"""The port's fidelity anchor (``octproz_tpu_torch.fullgeom_fidelity``)
against the JAX package's (``scripts/fullgeom_fidelity.py``) at the JAX
test's geometry, 256 x 64 x 8, on the CPU: the same device volumes, the
same SNR bound, each rung's PSNR with FPN off and on within a stated
tolerance of the JAX script's, and the gates of ``tests/test_fidelity.py``.

Tolerance of a rung's PSNR.  The JAX script rounds each PSNR to 0.1 dB
(up to 0.05 dB away).  Past that, both chains compute one float32 chain
in their own order:

* "bfloat16" and "high" sit 25-60 dB above float32 rounding (their error
  is that of their bf16 operands, 2^-8 and 2^-16); there the two
  frameworks' outputs differ by 2.4e-7-1.4e-5 RMS against an error of
  1.7e-4-4.4e-2 RMS, which moves a PSNR by at most 0.6 dB by the triangle
  inequality and moved it by 0.014 dB at most (measured on this geometry):
  held within ``CLOSE_DB`` = 0.15 dB.
* "default" and "highest" are float32-grade: their error against the
  oracle (1.2e-6 RMS, about 118 dB, FPN off; 1.1e-5-2.1e-5 with FPN on,
  where the FPN subtraction leaves deep nulls that the log amplifies) is
  float32 rounding itself, and the two frameworks round differently: the
  outputs differ by as much as each differs from the oracle.  Measured
  gaps 0.005-0.09 dB FPN off, 0.05-1.04 dB FPN on: held within
  ``FLOAT32_DB`` = 1.5 dB.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

jax.config.update("jax_platforms", "cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import fullgeom_fidelity as jfg  # noqa: E402  (scripts/, the JAX package's)

from octproz_tpu_torch import fullgeom_fidelity as tfg  # noqa: E402
from test_torch_soak import chip_smoke, counted  # noqa: E402,F401  (the counting wrappers)
from torch_threads import one_torch_thread  # noqa: E402,F401  (autouse: one intra-op thread)

GEOMETRY = (256, 64, 8)
RUNGS = ("bfloat16", "default", "high", "highest")
CLOSE_DB = 0.15
FLOAT32_DB = 1.5
TOLERANCE_DB = {"bfloat16": CLOSE_DB, "high": CLOSE_DB, "default": FLOAT32_DB,
                "highest": FLOAT32_DB}


@pytest.fixture(scope="module")
def both():
    """Both scripts' volumes, bound and rung PSNRs, FPN off and on."""
    from octproz_tpu import curves as jcurves

    js, jraw, janalog = jfg.device_and_volumes(*GEOMETRY)
    ts, traw, tanalog = tfg.device_and_volumes(*GEOMETRY)
    jcfg, tcfg = jfg.anchor_config(js), tfg.anchor_config(ts)
    jcv = jcurves.make_curves(js.acq, jcfg, **js.curve_kwargs())
    tcv = tfg.host_curves(ts, tcfg)
    jbound, jref = jfg.derive_snr_bound(js, jraw, janalog, jcfg, jcv)
    tbound, tref = tfg.derive_snr_bound(ts, traw, tanalog, tcfg, tcv)
    return {
        "volumes": ((jraw, janalog), (traw, tanalog)),
        "bound": (jbound, tbound),
        "reference": (jref, tref),
        "off": (jfg.rung_psnrs(js, jraw, jref, jcfg, jcv),
                tfg.rung_psnrs(ts, traw, tref, tcfg, device="cpu")),
        "on": (jfg.fpn_on_rung_psnrs(js, jraw, jcfg, jcv),
               tfg.fpn_on_rung_psnrs(ts, traw, tcfg, tcv, device="cpu")),
    }


@pytest.mark.parametrize("which", ["raw", "analog"])
def test_device_volumes_equal_jax(both, which):
    """The port's PhytoOCT volume is the JAX script's, bit for bit."""
    (jraw, janalog), (traw, tanalog) = both["volumes"]
    j, t = (jraw, traw) if which == "raw" else (janalog, tanalog)
    assert t.dtype == j.dtype and t.shape == j.shape == GEOMETRY[::-1]
    np.testing.assert_array_equal(t, j)


def test_snr_bound_equals_jax(both):
    """The unrounded bound and the oracle reference equal the JAX
    script's: both sides run the numpy oracle on the same volumes and
    the same host curves."""
    jbound, tbound = both["bound"]
    assert abs(tbound - jbound) <= 1e-9
    np.testing.assert_array_equal(both["reference"][1], both["reference"][0])


@pytest.mark.parametrize("fpn_bscans", [0, 4])
def test_threaded_oracle_equals_one_call(fpn_bscans):
    """The oracle in blocks of B-scans on threads (the FPN mean line from
    the first blocks' lines, the sinusoidal correction on the whole volume)
    equals ``tests/oracle.py``'s one call, bit for bit."""
    import oracle

    system, raw, _ = tfg.device_and_volumes(*GEOMETRY)
    cfg = tfg.anchor_config(system)
    curves = tfg.host_curves(system, cfg)
    x = np.asarray(raw >> 4, np.float64)
    fpn_lines = fpn_bscans * system.acq.ascans_per_bscan
    want, _ = oracle.full_pipeline(x, 12, bitshift=False, fpn_lines=fpn_lines,
                                   **tfg._oracle_args(cfg, curves))
    np.testing.assert_array_equal(tfg.oracle_volume(x, cfg, curves, fpn_lines), want)


@pytest.mark.parametrize("fpn", ["off", "on"])
@pytest.mark.parametrize("rung", RUNGS)
def test_rung_psnr_matches_jax(both, fpn, rung):
    """Each rung's PSNR within its tolerance (module docstring) of the
    JAX script's."""
    jax_r, port_r = both[fpn]
    assert abs(port_r[rung]["psnr_db"] - jax_r[rung]["psnr_db"]) <= TOLERANCE_DB[rung]


@pytest.mark.parametrize("fpn", ["off", "on"])
@pytest.mark.parametrize("rung", RUNGS)
def test_rung_gates(both, fpn, rung):
    """The gates the smoke holds at full geometry (phase 15), here: the
    float32-grade rungs 10 dB above the bound, "high" at the bound, bf16
    below it."""
    bound = both["bound"][1]
    psnr = both[fpn][1][rung]["psnr_db"]
    if rung == "bfloat16":
        assert psnr < bound
    elif rung == "high":
        assert psnr >= bound
    else:
        assert psnr > bound + 10


def test_run_meets_the_jax_gates(tmp_path):
    """``run`` at the JAX test's geometry meets tests/test_fidelity.py's
    assertions: a finite bound, "highest" within it with FPN off and on
    and 10 dB above it, bf16 not claiming it, and the ``cli compare`` gate
    passed against the saved pair."""
    report = tfg.run(*GEOMETRY, save_pair_dir=str(tmp_path), rungs=["bfloat16", "highest"],
                     device="cpu")
    bound = report["snr_bound_db"]
    assert 30.0 < bound < 90.0
    assert report["platform"] == "cpu"
    for key in ("rungs", "rungs_fpn_on"):
        assert report[key]["highest"]["within_reference_snr_bound"]
        assert report[key]["highest"]["psnr_db"] > bound + 10
    assert not report["rungs"]["bfloat16"]["within_reference_snr_bound"]
    assert report["cli_compare"]["passed"] and report["cli_compare"]["returncode"] == 0
    assert os.path.exists(report["pair"]["oracle"])
    assert set(report) >= {"platform", "platform_note", "geometry", "anchor", "snr_bound_db",
                           "snr_bound_definition", "rungs", "rungs_fpn_on", "fpn_on_note",
                           "pair", "cli_compare"}


def test_cli_compare_gate_fails_above_the_output(tmp_path):
    """The gate is a real gate: at a bound above the output's PSNR the
    ``compare`` command fails and the gate says so."""
    system, raw, analog = tfg.device_and_volumes(*GEOMETRY)
    cfg = tfg.anchor_config(system)
    _, ref = tfg.derive_snr_bound(system, raw, analog, cfg, tfg.host_curves(system, cfg))
    ref_path = str(tmp_path / "oracle.raw")
    ref.astype(np.float32).tofile(ref_path)
    gate = tfg.cli_compare_gate(system, raw, cfg, ref_path, str(tmp_path), min_psnr=1000.0,
                                device="cpu")
    assert gate["returncode"] == 1 and not gate["passed"]


def test_watch_wraps_each_rung_run():
    """``watch(rung, cfg)`` wraps each rung's run, with the rung's
    configuration: the hook the smoke reads the launch counts through."""
    import contextlib

    system, raw, analog = tfg.device_and_volumes(*GEOMETRY)
    cfg = tfg.anchor_config(system)
    seen = []

    @contextlib.contextmanager
    def watch(rung, c):
        seen.append((rung, c.compute_dtype, c.matmul_precision, c.fpn_mode.value))
        yield

    ref = np.zeros((GEOMETRY[2], GEOMETRY[1], GEOMETRY[0] // 2))
    tfg.rung_psnrs(system, raw, ref, cfg, rungs=["bfloat16", "high"], device="cpu", watch=watch)
    assert seen == [("bfloat16", "bfloat16", "default", "off"),
                    ("high", "float32", "high", "off")]


def test_main_small_on_the_cpu(tmp_path, capsys):
    """``python -m octproz_tpu_torch.fullgeom_fidelity --small --device
    cpu``: the report on stdout and in ``--out``."""
    out = tmp_path / "report.json"
    assert tfg.main(["--small", "--device", "cpu", "--out", str(out)]) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    saved = json.loads(out.read_text())
    assert printed["geometry"] == saved["geometry"] == {"samples": 256, "ascans": 64,
                                                         "bscans": 8}
    assert set(saved["rungs"]) == set(RUNGS) == set(saved["rungs_fpn_on"])


def test_run_refuses_a_missing_card():
    """On the card by default: without one ``run`` raises before it
    builds anything, never falling back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfg.run(*GEOMETRY)


def test_smoke_anchor_watch_reads_each_rungs_family(counted, tmp_path):
    """The smoke's watch (``chip_smoke._anchor_watch``) around each rung of
    the anchor, FPN off and on and the ``cli compare`` run: each run
    launched its rung's family on its route and nothing else (the FPN
    buffer's planar kernel with FPN on, the steady-state kernel off), summed
    by ``kernels`` row."""
    system, raw, analog = tfg.device_and_volumes(*GEOMETRY)
    cfg = tfg.anchor_config(system)
    curves = tfg.host_curves(system, cfg)
    launches = {}
    watch = chip_smoke._anchor_watch(system.acq, launches)
    _, ref = tfg.derive_snr_bound(system, raw, analog, cfg, curves)
    tfg.rung_psnrs(system, raw, ref, cfg, device="cpu", watch=watch)
    tfg.fpn_on_rung_psnrs(system, raw, cfg, curves, device="cpu", watch=watch)
    ref_path = str(tmp_path / "oracle.raw")
    ref.astype(np.float32).tofile(ref_path)
    tfg.cli_compare_gate(system, raw, cfg, ref_path, str(tmp_path), 50.0, device="cpu",
                         watch=watch)
    assert launches == {"depth_scale_bf16": 1, "depth_scale": 1, "depth_scale_split": 3,
                        "depth_bf16": 1, "depth": 1, "depth_split": 2}


@pytest.mark.parametrize("fpn", ["off", "once"])
@pytest.mark.parametrize("rung", RUNGS)
def test_smoke_first_buffer_families(fpn, rung):
    """One buffer from a fresh FPN state launches the FPN buffer's planar
    kernel with FPN once, the steady-state kernel with FPN off; the split
    rungs their split family."""
    import dataclasses

    from octproz_tpu_torch.bench import at_rung
    from octproz_tpu_torch.params import FpnMode

    system, _, _ = tfg.device_and_volumes(*GEOMETRY)
    cfg = at_rung(dataclasses.replace(tfg.anchor_config(system), fpn_mode=FpnMode(fpn)), rung)
    family = "depth" if fpn == "once" else "depth_scale"
    split = "_split" if rung in ("high", "highest") else ""
    assert chip_smoke.first_buffer_families(cfg) == {family + split}

