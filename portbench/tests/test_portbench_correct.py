"""The comparison that decides ``correct``, shown to pass and to fail.

On the CPU at a small geometry, the port's plain versions through a whole
run of each cell (the look for a card skipped): sound runs are correct;
the control -- the port's own lower precision, ``compute_dtype=
"bfloat16"`` -- and faults planted in the timed path are not.  On the card
(marked ``cuda``), the same at the cells' own width on a short volume."""

from __future__ import annotations

import json
import time

import pytest
import torch

from portbench import run
from portbench.interferograms import make_volumes
from portbench.reference import Reference

CELLS = ("figshare.replay", "figshare.live", "handheld.replay", "handheld.live")


def _run(cell, seed=2**31 + 11, **kw):
    return run.run_cell(cell, seed, 0.2, False, "cpu", time.perf_counter(), **kw)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(small_cell, name):
    r = _run(small_cell(name))
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    metrics = set(r["metrics"])
    assert "setup_s" in metrics and len(metrics) == 2
    json.dumps(r)


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(small_cell, name):
    r = _run(small_cell(name), changes={"compute_dtype": "bfloat16"})
    assert not r["correct"]
    assert r["checks"]["rms"]["value"] > r["checks"]["rms"]["limit"]


def _fault(kind):
    """A fault planted where the answer is produced: ``wrap(model)``."""
    def wrap(model):
        step = model.process_buffer
        last = []

        def faulty(raw):
            out = step(raw)
            if kind == "voxel":          # one voxel of every answer moved half the display
                out = out.clone()
                out[-1, 3, 5] = (out[-1, 3, 5].clamp(0.0, 1.0) + 0.5) % 1.0
            elif kind == "half":         # half of the B-scans left out
                out = out.clone()
                out[out.shape[0] // 2:] = 0.0
            elif kind == "stale":        # the previous buffer's answer
                last.append(out)
                out = last[-2] if len(last) > 1 else out
            return out

        model.process_buffer = faulty
    return wrap


@pytest.mark.parametrize("kind", ("voxel", "half", "stale"))
@pytest.mark.parametrize("name", ("figshare.replay", "handheld.live"))
def test_fault_in_the_timed_path_is_not_correct(small_cell, name, kind):
    r = _run(small_cell(name), wrap=_fault(kind))
    assert not r["correct"], (kind, r["checks"])


def test_reference_matches_the_port_on_the_cpu(small_cell):
    """The reference's buffers against the port's plain versions directly:
    the FPN buffer (its own mean line) and a steady one."""
    from octproz_tpu_torch.models.fdoct import FdOctModel

    for name in ("figshare.replay", "handheld.replay"):
        cell = small_cell(name, samples=128, ascans=32, bscans=6)
        acq, cfg = cell.acq(), cell.proc()
        raw = make_volumes(acq, 2, 99, "cpu", shift=4, signal=cell.signal)
        model = FdOctModel(acq, cfg, **cell.curve_kwargs(), device="cpu")
        ref = Reference(cell.config, "cpu")
        mean = ref.fpn_mean_line(raw[0])
        for b in (0, 1):
            out = model.process_buffer(raw[b])
            want = torch.cat([blk for _, blk in ref.buffer(raw[b], mean)])
            d = out.double().clamp(0, 1) - want.clamp(0, 1)
            assert float(d.abs().max()) < 1e-3 and float(d.pow(2).mean().sqrt()) < 1e-5


def test_reference_pipeline_against_the_oracle_equations():
    """The reference's stages on one line against a scalar transcription
    (decode, cubic resampling, Hann window, unnormalised inverse DFT)."""
    import numpy as np

    from portbench import reference as R

    n = 32
    cfg = {"acq": {"samples_per_line": n, "ascans_per_bscan": 9, "bscans_per_buffer": 1},
           "proc": {"bitshift": True, "background_removal": False, "resampling": True,
                    "interpolation": "cubic", "windowing": True, "dispersion": False,
                    "fpn_mode": "off", "log_scaling": True, "post_background_removal": False,
                    "grayscale_min": 0.0, "grayscale_max": 60.0, "multiplicator": 1.0,
                    "addend": 0.0, "bscan_flip": False, "sinusoidal_correction": False},
           "curves": {"resample_coeffs": [0.0, n - 1.0, 3.0, -1.0], "dispersion_coeffs": [0] * 4,
                      "window_type": "hanning", "window_center": 0.5, "window_fill_factor": 1.0}}
    rng = np.random.default_rng(0)
    codes = (rng.integers(0, 4096, (1, 9, n)) << 4).astype(np.int32)
    raw = torch.as_tensor(np.where(codes >= 32768, codes - 65536, codes).astype(np.int16)
                          ).view(torch.uint16)
    got = torch.cat([b for _, b in R.Reference(cfg, "cpu").buffer(raw, None)]).numpy()
    curve = R.resample_curve(cfg["curves"]["resample_coeffs"], n)
    win = R.hann_window(n)
    for a in range(9):
        line = (codes[0, a] >> 4).astype(np.float64)
        res = []
        for x in curve:
            x0 = int(x)
            t = float(x - np.float32(x0))
            y0, y1, y2, y3 = line[abs(x0 - 1)], line[x0], line[x0 + 1], line[x0 + 2]
            aa, bb, cc = -y0 + 3 * (y1 - y2) + y3, 2 * y0 - 5 * y1 + 4 * y2 - y3, -y0 + y2
            res.append(0.5 * t * ((aa * t + bb) * t + cc) + y1)
        spec = np.array(res) * win
        z = np.array([sum(spec[k] * np.exp(2j * np.pi * j * k / n) for k in range(n))
                      for j in range(n // 2)])
        want = 10 * np.log10(np.abs(z) ** 2 / (n // 2)) / 60.0
        np.testing.assert_allclose(got[0, a], want, rtol=1e-9, atol=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ("figshare.replay", "handheld.live"))
def test_card_sound_and_control(card, name):
    """At the cells' own line length and B-scan width, 8 B-scans a buffer:
    the kernels' run is correct, the bf16 control is not."""
    from conftest import load, shrink

    cell = shrink(load(name), samples=1024, ascans=512, bscans=8, volumes=3,
                  compare=2)
    ok = run.run_cell(cell, 2**31 + 5, 0.5, False, card, time.perf_counter())
    control = run.run_cell(cell, 2**31 + 5, 0.5, False, card, time.perf_counter(),
                           changes={"compute_dtype": "bfloat16"})
    assert ok["correct"], ok["checks"]
    assert not control["correct"], control["checks"]
