"""The configurations phase of ``chip_smoke.py`` (every configuration the
CPU tests hold against the JAX package, run on the card and held against
the port on the CPU), checked here without a card:

* its list of configurations is ``SLICE_CONFIGS`` of
  tests/test_torch_pipeline.py, name for name and change for change, and
  its scan list the scan test's;
* its comparison, with both sides on the CPU, passes equal outputs and
  fails an output with one shown voxel moved 1e-3 display units, or a
  mean line moved past its tolerance; where it falls back to the float64
  products, one voxel of typical depth moved 5e-3 and a shift of 2e-4 of
  every voxel still fail;
* its rule for the kernel families a configuration launches
  (``config_families``) is what the pipeline dispatches, counted by
  wrappers that stand in for the kernels' launch counters;
* its float64 reference (``image_f64``) agrees with the port's float32
  output within the comparison's bound on a small buffer, per path;
* ``fold_k_split``, which only the card's phase adds to the matrix, against
  the JAX package.

Small sizes: 1024-sample lines (the phase's curves), 32 A-scans, 8
B-scans.
"""

import sys

import numpy as np
import pytest
import torch

import test_torch_pipeline as tp
from octproz_tpu_torch.kernels import fused_prep as tfp
from octproz_tpu_torch.params import FpnState

sys.path.insert(0, tp.bench._REPO)
import chip_smoke  # noqa: E402

ASCANS = 32
CONFIGS = {**chip_smoke.slice_configs(), **chip_smoke.CARD_ONLY_CONFIGS}


def _model(name, device="cpu"):
    return chip_smoke.config_model(CONFIGS[name], device, ascans=ASCANS)


def _run(name, strategy="auto"):
    model = _model(name)
    raws = chip_smoke.config_buffers(model.acq, 5 if strategy == "auto" else 3, 7)
    return model, raws, chip_smoke.run_config(model, raws, strategy)


def test_the_phase_runs_every_slice_config():
    """slice_configs() is SLICE_CONFIGS; a name left out carries a reason
    and is one of them; the scan list is the scan test's."""
    assert chip_smoke.slice_configs() == tp.SLICE_CONFIGS
    assert set(chip_smoke.CONFIGS_LEFT_OUT) <= set(tp.SLICE_CONFIGS)
    assert all(isinstance(r, str) and r for r in chip_smoke.CONFIGS_LEFT_OUT.values())
    scan = [m for m in tp.test_scan_chunk_matches_jax.pytestmark if m.name == "parametrize"]
    assert tuple(scan[0].args[1]) == chip_smoke.SCAN_CONFIGS
    assert not set(chip_smoke.CARD_ONLY_CONFIGS) & set(tp.SLICE_CONFIGS)


def _moved(outs, k, by, where):
    """``outs`` with output ``k``'s shown voxel at ``where`` ("smallest":
    the smallest shown value, where a bf16 store's step is below 1e-3;
    "median": a voxel at the median shown value) moved by ``by``."""
    moved = [t.clone() for t in outs]
    flat = moved[k].view(-1)
    values = flat.float()
    shown = torch.isfinite(values) & (values >= 0)
    if where == "smallest":
        i = int(torch.where(shown, values, torch.full_like(values, 2.0)).argmin())
    else:
        i = int((values - values[shown].median()).abs().argmin())
    flat[i] = values[i] + by
    return moved, i


@pytest.mark.parametrize("name", ["fft-matmul", "fft-gather-lanczos", "bf16-store",
                                  "fft-bf16-store", "fft-prep-real-default"])
def test_compare_passes_equal_outputs_and_catches_one_moved_voxel(name):
    """Both sides on the CPU: the same model twice passes; one shown voxel
    of a steady output moved 1e-3 (the smallest shown value, where a bf16
    store's step is below it) fails."""
    _, raws, (got, states) = _run(name)
    want, want_states = chip_smoke.run_config(_model(name), raws)
    worst, fpn, black = chip_smoke.hold_config(name, got, want, states, want_states)
    assert worst == 0.0 and fpn == 0.0
    moved, i = _moved(got, 1, 1e-3, "smallest")
    assert float(moved[1].view(-1)[i].float() - want[1].view(-1)[i].float()) >= 0.9e-3
    with pytest.raises(AssertionError, match="output 1"):
        chip_smoke.hold_config(name, moved, want, states, want_states)


@pytest.mark.parametrize("name", ["once-default", "fft-matmul", "fft-gather-lanczos"])
def test_float64_fallback_catches_a_moved_voxel_and_a_shift(name):
    """Where an output misses against the CPU's, the check against the
    float64 products (``config_near_exact``) fails one voxel of typical
    depth moved 5e-3 (past its float32 bound: 0.6-1.7e-3 display units at
    the median voxel, the FFT path's the larger) and every voxel moved 2e-4
    (far past the share of voxels it lets past 1e-4)."""
    model, raws, (got, states) = _run(name)
    want, want_states = chip_smoke.run_config(_model(name), raws)
    exact = lambda side: chip_smoke.run_config_f64(  # noqa: E731
        model, raws, chip_smoke.config_steps(model, raws))
    moved, _ = _moved(got, 1, 5e-3, "median")
    with pytest.raises(AssertionError, match="float32 bound"):
        chip_smoke.hold_config(name, moved, want, states, want_states, exact=exact)
    shifted = [t + 2e-4 for t in got]
    with pytest.raises(AssertionError, match="float64 products"):
        chip_smoke.hold_config(name, shifted, want, states, want_states, exact=exact)


def test_compare_catches_a_moved_mean_line():
    _, raws, (got, states) = _run("once-default")
    want, want_states = chip_smoke.run_config(_model("once-default"), raws)
    mean = states[-1].mean_line.clone()
    mean[0, 5] += 1e-4 * float(mean.abs().max()) + 1e-3
    moved = [*states[:-1], FpnState(mean_line=mean, determined=True)]
    with pytest.raises(AssertionError, match="FPN mean line"):
        chip_smoke.hold_config("once-default", got, want, moved, want_states)


def test_compare_refuses_a_different_finite_mask():
    _, raws, (got, states) = _run("once-default")
    moved = [t.clone() for t in got]
    moved[0].view(-1)[3] = float("-inf")
    with pytest.raises(AssertionError, match="finite masks"):
        chip_smoke.hold_config("once-default", moved, got, states, states)


@pytest.fixture
def counted(monkeypatch):
    """The kernels' public wrappers counting as their launches do
    (``fused_prep._kernel_operands`` names the family and route), then
    running the plain versions: the launch counts of a CPU run."""
    wrappers = {"fold_depth": ("depth", 3), "fold_depth_scale": ("depth_scale", 3),
                "fold_depth_scale_concat": ("depth_scale_concat", 2),
                "prep_phase": ("prep_phase", 2), "prep_real": ("prep_real", 2)}
    for name, (family, axes) in wrappers.items():
        plain = getattr(tfp, name)

        def wrapper(raw, *args, plain=plain, family=family, axes=axes, **kw):
            ops = args[:axes - 1]
            _, _, key, route = tfp._kernel_operands(raw, ops, family)
            tfp._count_launch(key, route)
            return plain(raw, *args, **kw)

        monkeypatch.setattr(tfp, name, wrapper)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    tfp.reset_launch_counts()
    yield
    tfp.reset_launch_counts()


@pytest.mark.parametrize("strategy,name", [("auto", n) for n in CONFIGS]
                         + [("scan", n) for n in chip_smoke.SCAN_CONFIGS])
def test_config_families_are_what_the_pipeline_dispatches(counted, strategy, name):
    """Each configuration's run launches exactly ``config_families(cfg)``,
    every one-pass launch on the route of its compute dtype
    (``_config_launches``, the check the phase makes on the card)."""
    model, _, _ = _run(name, strategy)
    rows = chip_smoke._config_launches(name, model.cfg, model.acq)
    assert set(rows) == {chip_smoke.config_row(k, model.cfg, model.acq)
                         for k in chip_smoke.config_families(model.cfg)}


def test_config_launches_refuse_a_missing_family(counted):
    """A run that launched none of its families (a route dropped to its
    plain version) fails the check."""
    model = _model("once-default")
    with pytest.raises(AssertionError, match="want the families"):
        chip_smoke._config_launches("once-default", model.cfg, model.acq)


@pytest.mark.parametrize("name", ["once-default", "once-high", "fpn-continuous", "fast-log",
                                  "fold-concat-post-stages", "fold-24bit", "fft-matmul",
                                  "fft-prep-16bit-high", "fft-gather-lanczos",
                                  "fft-background", "fft-prep-real-default", "bf16-fold",
                                  "bf16-fft-matmul"])
def test_float64_reference_agrees_with_the_port(name):
    """``run_config_f64`` -- the products in float64 on the port's own
    operands and elementwise stages -- is within the comparison's bound of
    the port's float32 output on a small buffer (256 lines: no voxel as
    deep in a null as on the card's 4096), on every path and rung form."""
    model, raws, (got, _) = _run(name)
    steps = chip_smoke.config_steps(model, raws)
    for g, (image, bound) in zip(got, chip_smoke.run_config_f64(model, raws, steps)):
        err, ok, _ = chip_smoke.config_close(g, image)
        assert ok, err
        assert chip_smoke.config_near_exact(g, (image, bound))[1:] == (True, 0, 0.0)
        shown = torch.isfinite(image) & (image >= 0)
        assert bool((bound[shown] > 0).all()) and float(bound[shown].median()) < 2e-3


def test_fold_k_split_matches_jax():
    """The card-only configuration (fold_k_split with fast log and a bf16
    store on the default rung's scaled kernel) against the JAX package, as
    SLICE_CONFIGS' cases run."""
    (changes,) = chip_smoke.CARD_ONLY_CONFIGS.values()
    tm, jm = tp._models(**changes)
    raws = tp._buffers(5)
    for raw in raws[:3]:
        tp._close(tm.process_buffer(raw), np.asarray(jm.process_buffer(raw), np.float32))
        tp._same_fpn(tm, jm)
    tp._close(tm.process_chunk(np.stack(raws[3:])),
              np.asarray(jm.process_chunk(np.stack(raws[3:])), np.float32))
