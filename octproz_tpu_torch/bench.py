"""Benchmark of the port on one CUDA GPU.

    python -m octproz_tpu_torch.bench      (from the root of a checkout)

prints one JSON line for the reference benchmark chain
(``default_full_config()`` with ``bitshift=True``: cubic k-linearization,
Hann window, dispersion, FPN once, log scaling) on 1024 x 512 x 256 buffers
of 12-bit samples:

* ``equivalent_ascan_rate`` (MHz) and ``ms_per_buffer`` of the steady state
  (FPN determined, ``FdOctModel.process_buffer``) at the default rung;
  ``rungs`` -- the same and the oracle PSNR for every precision rung; and
  ``in_bound`` -- the fastest rung whose oracle PSNR clears the 50.6 dB
  acquisition SNR bound;
* ``oracle_psnr_db`` per rung: FPN-off PSNR of one 1024 x 512 x 8 buffer
  against the float64 NumPy oracle (``tests/oracle.py``), each gated;
* ``golden_psnr_db``: the checked-in golden pair through the port;
* ``kernels``: each fold kernel's time beside its plain PyTorch version's
  at the main path's shapes;
* ``paths.fft``: the FFT path (``presets.benchmark_config(tpu=False)`` with
  the prep kernels, then cuFFT) -- steady ms per buffer and MHz at the
  default and "high" rungs with the step split into prep kernel, FFT and
  FPN plus scaling, its oracle PSNR per rung, its golden pair, and the four
  prep kernels beside their plain versions;
* the device's name and power limit, since a card below its maximum power
  runs slower under load.

Times are CUDA-event times after warm-up, on distinct buffers already on
the device.  Without a CUDA device the bench exits with an error: there is
no CPU measurement.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import subprocess
import sys
from typing import Dict, Sequence

import numpy as np
import torch

from .params import AcqParams, FpnMode, Interpolation, ProcConfig, WindowType, default_full_config

#: The reference's headline rate: v1.8.0 on a GTX 1080 (BASELINE.md).
BASELINE_MHZ = 3.40
#: Acquisition quantization-noise SNR bound (dB) of the in-bound rung.
IN_BOUND_SNR_DB = 50.6
#: Per-rung gates on the FPN-off oracle PSNR (dB).
ORACLE_GATE_DB = {"default": 20.0, "high": 50.0, "highest": 80.0}

#: The benchmark geometry: one 1024 x 512 x 256 buffer of 12-bit samples.
FULL_ACQ = AcqParams(samples_per_line=1024, ascans_per_bscan=512,
                     bscans_per_buffer=256, buffers_per_volume=1, bit_depth=12)
#: Curve coefficients of the benchmark chain.
CURVE_KW = dict(resample_coeffs=(0.0, 1023.0, 20.0, -10.0),
                dispersion_coeffs=(0.0, 0.0, 10.0, 0.0),
                window_type=WindowType.HANNING)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TESTS = os.path.join(_REPO, "tests")


#: The rungs the steady state is timed at.
TIMED_RUNGS = ("default", "high")
FOLD_KERNELS = ("depth", "depth_split", "depth_scale", "depth_scale_split")
PREP_KERNELS = ("prep_phase", "prep_phase_split", "prep_real", "prep_real_split")


def bench_config(**changes) -> ProcConfig:
    return dataclasses.replace(default_full_config(), bitshift=True, **changes)


def fft_config(**changes) -> ProcConfig:
    """The FFT path's chain: the benchmark preset without the folded GEMM,
    stages 1-3 in the prep kernels."""
    from .models.presets import benchmark_config

    return dataclasses.replace(benchmark_config(tpu=False), use_pallas_prep=True, **changes)


def device_info() -> Dict[str, object]:
    """The card's name, count and power limit (nvidia-smi's own line)."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    return {"platform": "gpu", "device_name": torch.cuda.get_device_name(0),
            "device_count": torch.cuda.device_count(),
            "power_limit": smi.splitlines()[0].split(",")[-1].strip(),
            "nvidia_smi": smi}


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean CUDA-event milliseconds of ``fn()`` over ``iters`` calls after
    ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def random_buffers(acq: AcqParams, count: int, device, seed: int) -> torch.Tensor:
    """``count`` distinct 12-bit raw buffers (count, bscans, ascans, samples),
    made on the device from a seed."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    vals = torch.randint(0, 4096, (count, *acq.buffer_shape), dtype=torch.int16,
                         generator=g, device=device)
    return vals.view(torch.uint16)


def _oracle():
    if _TESTS not in sys.path:
        sys.path.insert(0, _TESTS)
    import oracle

    return oracle


def oracle_psnr(rungs: Sequence[str], device, cfg: ProcConfig = None) -> Dict[str, float]:
    """Display-range PSNR (dB) of one 1024 x 512 x 8 buffer, FPN off, per
    precision rung against the float64 NumPy oracle (fast resampler)."""
    from . import curves as curves_mod
    from .models.fdoct import FdOctModel

    acq = dataclasses.replace(FULL_ACQ, bscans_per_buffer=8)
    cfg = dataclasses.replace(cfg or bench_config(), fpn_mode=FpnMode.OFF,
                              output_dtype="float32")
    host = curves_mod.make_curves(acq, cfg, **CURVE_KW, device="cpu")
    raw = np.random.default_rng(7).integers(0, 4096, size=acq.buffer_shape).astype(np.uint16)
    want, _ = _oracle().full_pipeline(
        raw, acq.bit_depth, bitshift=cfg.bitshift,
        resample_curve=np.asarray(host.resample_curve),
        interpolation=cfg.interpolation.value, window=np.asarray(host.window),
        phase=np.asarray(host.phase), log_scaling=cfg.log_scaling,
        gmin=cfg.grayscale_min, gmax=cfg.grayscale_max, addend=cfg.addend,
        coeff=cfg.multiplicator, fast=True)
    ref = np.clip(np.asarray(want, np.float64), 0, 1)
    out = {}
    for rung in rungs:
        model = FdOctModel(acq, dataclasses.replace(cfg, matmul_precision=rung),
                           **CURVE_KW, device=device)
        got = np.clip(model.fetch(model.process_buffer(raw)).astype(np.float64), 0, 1)
        mse = float(np.mean((got - ref) ** 2))
        out[rung] = float(10.0 * np.log10(1.0 / max(mse, 1e-30)))
    return out


def golden_pair(device, **changes):
    """The golden pair (tests/data/golden_pair_*) through the port on
    ``device``; returns utils.fidelity.CompareResult."""
    from .models.fdoct import FdOctModel
    from .utils.fidelity import compare_volumes, load_volume

    data = os.path.join(_TESTS, "data")
    with open(os.path.join(data, "golden_pair.json")) as f:
        meta = json.load(f)
    acq = AcqParams(samples_per_line=meta["samples"],
                    ascans_per_bscan=meta["ascans"],
                    bscans_per_buffer=meta["bscans"],
                    bit_depth=meta["bit_depth"])
    cfg = ProcConfig(**{
        "bitshift": meta["bitshift"],
        "resampling": True, "interpolation": Interpolation(meta["interpolation"]),
        "windowing": True, "dispersion": True,
        "fpn_mode": FpnMode(meta["fpn_mode"]),
        "bscans_for_noise": meta["bscans_for_noise"],
        "log_scaling": meta["log_scaling"],
        "grayscale_min": meta["grayscale_min"],
        "grayscale_max": meta["grayscale_max"],
        "fft_via_matmul": True, **changes})
    raw = np.fromfile(os.path.join(data, "golden_pair_input.raw"),
                      np.uint16).reshape(acq.buffer_shape)
    ref = load_volume(os.path.join(data, "golden_pair_ref.raw"),
                      tuple(meta["ref_shape"]))
    model = FdOctModel(acq, cfg, resample_coeffs=tuple(meta["resample_coeffs"]),
                       dispersion_coeffs=tuple(meta["dispersion_coeffs"]),
                       window_type=WindowType(meta["window_type"]), device=device)
    return compare_volumes(model.fetch(model.process_buffer(raw)), ref)


def steady_ms_per_buffer(cfg: ProcConfig, device, ring: int = 4,
                         iters: int = 12) -> float:
    """CUDA-event ms per buffer of ``FdOctModel.process_buffer`` in the
    steady state (FPN determined), cycling over ``ring`` distinct buffers
    already on the device."""
    from .models.fdoct import FdOctModel

    model = FdOctModel(FULL_ACQ, cfg, **CURVE_KW, device=device)
    bufs = random_buffers(FULL_ACQ, ring, device, seed=11)
    model.process_buffer(bufs[0])  # FPN determination
    turn = itertools.count()
    return cuda_ms(lambda: model.process_buffer(bufs[next(turn) % ring]), iters=iters)


def fft_stage_ms(cfg: ProcConfig, device, ring: int = 4,
                 iters: int = 12) -> Dict[str, float]:
    """CUDA-event ms per buffer of the FFT path's stages in the steady
    state: ``prep`` (stages 1-3, the prep kernel), ``fft`` (inverse FFT and
    truncation), ``fpn_scale`` (FPN subtraction and scaling).  Runs the
    pipeline's own stage functions in its order and checks that the last
    buffer's output equals ``process_buffer``'s."""
    from . import pipeline
    from .models.fdoct import FdOctModel
    from .ops import postprocess

    if cfg.fft_via_matmul or pipeline.has_post(cfg):
        raise ValueError("fft_stage_ms times the FFT path without post stages")
    model = FdOctModel(FULL_ACQ, cfg, **CURVE_KW, device=device)
    bufs = random_buffers(FULL_ACQ, ring, device, seed=11)
    model.process_buffer(bufs[0])  # FPN determination
    acq, curves, state = model.acq, model.curves, model.fpn_state
    half = acq.output_ascan_length
    scale = postprocess.scale_log if cfg.log_scaling else postprocess.scale_lin
    names = ("prep", "fft", "fpn_scale")
    totals = dict.fromkeys(names, 0.0)
    warmup = 2
    for i in range(warmup + iters):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        raw = bufs[i % ring]
        ev[0].record()
        spectra = pipeline.prep_spectra(raw, curves, acq, cfg)
        ev[1].record()
        z = pipeline.transform_to_depth(spectra, half)
        ev[2].record()
        if cfg.fpn_mode != FpnMode.OFF:
            z, _ = pipeline.apply_fpn(z, state, acq, cfg)
        mag = pipeline.narrow(scale(z, half, cfg.grayscale_min, cfg.grayscale_max,
                                    cfg.addend, cfg.multiplicator), cfg)
        ev[3].record()
        ev[3].synchronize()
        if i >= warmup:
            for k, name in enumerate(names):
                totals[name] += ev[k].elapsed_time(ev[k + 1]) / iters
    if not torch.equal(mag, model.process_buffer(raw)):
        raise AssertionError("the timed stages differ from process_buffer")
    return totals


def _kernel_and_plain(name: str, device):
    """(kernel, plain) closures for one kernel family at the main path's
    shapes: one 131072-line buffer of 1024 uint16 samples; the fold
    families -> 512 bins, the prep families -> 1024 columns; the split
    families at the "high" rung (3 passes)."""
    from . import curves as curves_mod
    from .kernels import fused_prep as fp

    precision = "high" if name.endswith("_split") else "default"
    raw2d = random_buffers(FULL_ACQ, 1, device, seed=5).reshape(-1, FULL_ACQ.samples_per_line)
    if name.startswith("prep"):
        cv = curves_mod.make_curves(FULL_ACQ, fft_config(), **CURVE_KW, device=device)
        parts = fp._operator_parts(cv.prep_operator, precision)
        if name.startswith("prep_phase"):
            rows = (cv.phase.real.contiguous(), cv.phase.imag.contiguous())
            return (lambda: fp._launch_prep(raw2d, parts, *rows, bitshift=True),
                    lambda: fp.prep_phase_plain(raw2d, parts, *rows, bitshift=True))
        return (lambda: fp._launch_prep(raw2d, parts, None, None, bitshift=True),
                lambda: fp.prep_real_plain(raw2d, parts, bitshift=True))
    cfg = bench_config()
    cv = curves_mod.make_curves(FULL_ACQ, cfg, **CURVE_KW, device=device)
    wre = fp._operator_parts(cv.depth_op_re, precision)
    wim = fp._operator_parts(cv.depth_op_im, precision)
    if name.startswith("depth_scale"):
        mean2 = torch.zeros((2, FULL_ACQ.output_ascan_length), dtype=torch.float32,
                            device=device)
        a, b = fp._scale_affine(True, FULL_ACQ.output_ascan_length, cfg.grayscale_min,
                                cfg.grayscale_max, cfg.addend, cfg.multiplicator)
        kw = dict(bitshift=True, log_scaling=True, a=a, b=b)
        return (lambda: fp._launch_depth_scale(raw2d, wre, wim, mean2, fast_log=False,
                                               out_dtype=torch.float32, **kw),
                lambda: fp.depth_scale_plain(raw2d, wre, wim, mean2, **kw))
    return (lambda: fp._launch_depth(raw2d, wre, wim, bitshift=True),
            lambda: fp.depth_plain(raw2d, wre, wim, bitshift=True))


def kernel_times(device, names: Sequence[str] = FOLD_KERNELS,
                 iters: int = 5) -> Dict[str, Dict[str, float]]:
    """Each kernel family in ``names`` beside its plain version at the main
    path's shapes (see :func:`_kernel_and_plain`), in turns plain, kernel,
    kernel, plain."""
    out = {}
    for name in names:
        kernel, plain = _kernel_and_plain(name, device)
        p1 = cuda_ms(plain, iters, warmup=1)
        k1 = cuda_ms(kernel, iters, warmup=1)
        k2 = cuda_ms(kernel, iters, warmup=0)
        p2 = cuda_ms(plain, iters, warmup=0)
        out[name] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2}
    return out


def fft_path_record(device) -> Dict[str, object]:
    """The ``paths.fft`` record: steady ms and MHz with the stage split at
    each timed rung, oracle PSNR per rung (gated), the golden pair, and the
    prep kernels beside their plain versions."""
    psnr = oracle_psnr(tuple(ORACLE_GATE_DB), device, fft_config())
    for rung, gate in ORACLE_GATE_DB.items():
        if psnr[rung] < gate:
            raise SystemExit(f"bench: FFT path rung {rung!r} failed its fidelity gate: "
                             f"{psnr[rung]:.2f} dB < {gate} dB")
    lines = FULL_ACQ.ascans_per_buffer
    rungs = {}
    for rung in TIMED_RUNGS:
        cfg = fft_config(matmul_precision=rung)
        ms = steady_ms_per_buffer(cfg, device)
        rungs[rung] = {"ms_per_buffer": ms, "equivalent_ascan_rate": lines / ms / 1e3,
                       "oracle_psnr_db": psnr[rung], "stages_ms": fft_stage_ms(cfg, device)}
    golden = golden_pair(device, fft_via_matmul=False, use_pallas_prep=True)
    return {"config": "presets.benchmark_config(tpu=False), use_pallas_prep=True",
            "rungs": rungs, "oracle_psnr_db": psnr,
            "golden_psnr_db": float(golden.psnr_db),
            "kernels": kernel_times(device, PREP_KERNELS)}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("octproz_tpu_torch.bench: no CUDA device; the bench "
                         "measures the GPU only")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in true float32
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    info = device_info()
    psnr = oracle_psnr(("default", "high", "highest"), device)
    for rung, gate in ORACLE_GATE_DB.items():
        if psnr[rung] < gate:
            raise SystemExit(f"bench: rung {rung!r} failed its fidelity gate: "
                             f"{psnr[rung]:.2f} dB < {gate} dB")
    lines = FULL_ACQ.ascans_per_buffer
    rungs = {}
    for rung in ORACLE_GATE_DB:
        ms_rung = steady_ms_per_buffer(bench_config(matmul_precision=rung), device)
        rungs[rung] = {"ms_per_buffer": ms_rung,
                       "equivalent_ascan_rate": lines / ms_rung / 1e3,
                       "oracle_psnr_db": psnr[rung]}
    # the operating point: the fastest rung whose oracle PSNR clears the bound
    cleared = [r for r in rungs if psnr[r] >= IN_BOUND_SNR_DB]
    in_bound = min(cleared, key=lambda r: rungs[r]["ms_per_buffer"]) if cleared else None
    ms = rungs["default"]["ms_per_buffer"]
    golden = golden_pair(device)
    record = {
        "metric": "equivalent_ascan_rate",
        "equivalent_ascan_rate": lines / ms / 1e3,
        "unit": "MHz",
        "ms_per_buffer": ms,
        "vs_baseline": lines / ms / 1e3 / BASELINE_MHZ,
        "matmul_precision": "default",
        "in_bound": None if in_bound is None else {"matmul_precision": in_bound,
                                                   **rungs[in_bound]},
        "rungs": rungs,
        "oracle_psnr_db": psnr,
        "golden_psnr_db": float(golden.psnr_db),
        "kernels": kernel_times(device),
        "paths": {"fft": fft_path_record(device)},
        "platform": info["platform"],
        "device_name": info["device_name"],
        "power_limit": info["power_limit"],
        "geometry": list(FULL_ACQ.buffer_shape),
    }
    print(json.dumps(record))


if __name__ == "__main__":
    main()
