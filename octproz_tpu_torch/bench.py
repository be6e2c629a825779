"""Benchmark of the port on one CUDA GPU.

    python -m octproz_tpu_torch.bench      (from the root of a checkout)

prints one JSON line for the reference benchmark chain
(``default_full_config()`` with ``bitshift=True``: cubic k-linearization,
Hann window, dispersion, FPN once, log scaling) on 1024 x 512 x 256 buffers
of 12-bit samples:

* ``equivalent_ascan_rate`` (MHz) and ``ms_per_buffer`` of the steady state
  (FPN determined, ``FdOctModel.process_buffer``) at the default rung;
  ``rungs`` -- the same and the oracle PSNR for every precision rung and for
  ``compute_dtype="bfloat16"`` (the rung "bfloat16", :func:`at_rung`); and
  ``in_bound`` -- the fastest rung whose oracle PSNR clears the 50.6 dB
  acquisition SNR bound;
* ``oracle_psnr_db`` per rung: FPN-off PSNR of one 1024 x 512 x 8 buffer
  against the float64 NumPy oracle (``tests/oracle.py``), each gated;
* ``golden_psnr_db``: the checked-in golden pair through the port;
* ``kernels``: each fold kernel's time beside its plain PyTorch version's
  at the main path's shapes (the concat kernels of ``fold_concat`` too, the
  bf16 route of the one-pass families, ``*_bf16``, and their one pass on
  float32 lines, ``*_f32lines``);
* ``paths.fft``: the FFT path (``presets.benchmark_config(tpu=False)`` with
  the prep kernels, then cuFFT) -- steady ms per buffer and MHz at the
  default and "high" rungs with the step split into prep kernel, FFT and
  FPN plus scaling, its oracle PSNR per rung, its golden pair, and the four
  prep kernels beside their plain versions;
* ``paths.stream``: the streaming runtime (``StreamingEngine``) on the
  benchmark chain with ``fold_concat`` -- the concat path's steady ms per
  buffer and MHz (``process_buffer``, buffers on the device), and the
  engine's end-to-end A-scan rate with the upload included, on the uint16
  and the packed-12 wire, per buffer and in chunks of four, every buffer
  quantized and fetched to the host; ``transfer_ms`` times the engine's
  transfer stages on their own;
* the device's name and power limit, since a card below its maximum power
  runs slower under load.

Times are CUDA-event times after warm-up, on distinct buffers already on
the device; the engine's rate is its own ``ThroughputMeter`` (host clock).
Without a CUDA device the bench exits with an error: there is no CPU
measurement.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, Sequence

import numpy as np
import torch

from .params import AcqParams, FpnMode, Interpolation, ProcConfig, WindowType, default_full_config

#: The reference's headline rate: v1.8.0 on a GTX 1080 (BASELINE.md).
BASELINE_MHZ = 3.40
#: Acquisition quantization-noise SNR bound (dB) of the in-bound rung.
IN_BOUND_SNR_DB = 50.6
#: Per-rung gates on the FPN-off oracle PSNR (dB); "bfloat16" is
#: ``compute_dtype="bfloat16"``, the throughput point, gated as "default"
#: was on the TPU's bf16 MXU.
ORACLE_GATE_DB = {"default": 20.0, "high": 50.0, "highest": 80.0, "bfloat16": 20.0}

#: The benchmark geometry: one 1024 x 512 x 256 buffer of 12-bit samples.
FULL_ACQ = AcqParams(samples_per_line=1024, ascans_per_bscan=512,
                     bscans_per_buffer=256, buffers_per_volume=1, bit_depth=12)
#: The benchmark geometry at 24 bits, in uint32 containers: samples above
#: 16 bits, which the wrappers decode to float32 lines before the kernels.
WIDE_ACQ = dataclasses.replace(FULL_ACQ, bit_depth=24)
#: Curve coefficients of the benchmark chain.
CURVE_KW = dict(resample_coeffs=(0.0, 1023.0, 20.0, -10.0),
                dispersion_coeffs=(0.0, 0.0, 10.0, 0.0),
                window_type=WindowType.HANNING)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TESTS = os.path.join(_REPO, "tests")


#: The rungs the steady state is timed at (:func:`at_rung`).
TIMED_RUNGS = ("default", "high", "highest", "bfloat16")
#: The kernel families timed on their own; ``*_bf16`` is the one-pass
#: family's bf16 route (``compute_dtype="bfloat16"``).
FOLD_KERNELS = ("depth", "depth_split", "depth_scale", "depth_scale_split",
                "depth_scale_concat", "depth_scale_concat_split", "depth_bf16",
                "depth_scale_bf16", "depth_scale_concat_bf16")
PREP_KERNELS = ("prep_phase", "prep_phase_split", "prep_real", "prep_real_split",
                "prep_phase_bf16", "prep_real_bf16")
#: The one-pass families on float32 lines (``*_f32lines``: samples above 16
#: bits, decoded before the kernel): on the tensor cores as three x parts,
#: six bf16 terms; off the main path, timed on 24-bit samples.
F32_LINE_KERNELS = ("depth_f32lines", "depth_scale_f32lines", "depth_scale_concat_f32lines",
                    "prep_phase_f32lines", "prep_real_f32lines")


def at_rung(cfg: ProcConfig, rung: str) -> ProcConfig:
    """``cfg`` at ``rung``: a matmul precision of float32 compute, or
    "bfloat16" -- ``compute_dtype="bfloat16"``, where the precision is
    ignored."""
    if rung == "bfloat16":
        return dataclasses.replace(cfg, compute_dtype="bfloat16")
    return dataclasses.replace(cfg, matmul_precision=rung)


def bench_config(**changes) -> ProcConfig:
    return dataclasses.replace(default_full_config(), bitshift=True, **changes)


def fft_config(**changes) -> ProcConfig:
    """The FFT path's chain: the benchmark preset without the folded GEMM,
    stages 1-3 in the prep kernels."""
    from .models.presets import benchmark_config

    return dataclasses.replace(benchmark_config(tpu=False), use_pallas_prep=True, **changes)


def device_info() -> Dict[str, object]:
    """The card's name and count (``utils.deviceinfo``) and power limit
    (nvidia-smi's own line)."""
    from .utils.deviceinfo import device_report

    devices = device_report()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    return {"platform": devices[0]["platform"], "device_name": devices[0]["device_kind"],
            "device_count": len(devices),
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
    """``count`` distinct raw buffers (count, bscans, ascans, samples) of
    12-bit samples in uint16, or for ``acq.bit_depth`` above 16 of 24-bit
    samples in uint32, made on the device from a seed."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    if acq.bit_depth > 16:
        vals = torch.randint(0, 1 << 24, (count, *acq.buffer_shape), dtype=torch.int32,
                             generator=g, device=device)
        return vals.view(torch.uint32)
    vals = torch.randint(0, 4096, (count, *acq.buffer_shape), dtype=torch.int16,
                         generator=g, device=device)
    return vals.view(torch.uint16)


def wide_config(cfg: ProcConfig) -> ProcConfig:
    """``cfg`` (a chain of 12-bit samples) for :data:`WIDE_ACQ`'s 24-bit
    samples: no bitshift (on a 32-bit container it scales to [0, 1)), and
    the display range moved up by the samples' gain -- 20 log10 of 2^16
    over the shifted 12-bit samples, 2^12 over unshifted ones -- so the
    image sits in it as the 12-bit chain's does."""
    gain_db = 20.0 * np.log10(2.0 ** (24 - (8 if cfg.bitshift else 12)))
    return dataclasses.replace(cfg, bitshift=False, grayscale_min=cfg.grayscale_min + gain_db,
                               grayscale_max=cfg.grayscale_max + gain_db)


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
        model = FdOctModel(acq, at_rung(cfg, rung), **CURVE_KW, device=device)
        got = np.clip(model.fetch(model.process_buffer(raw)).astype(np.float64), 0, 1)
        mse = float(np.mean((got - ref) ** 2))
        out[rung] = float(10.0 * np.log10(1.0 / max(mse, 1e-30)))
    return out


def golden_pair(device, steady: bool = False, **changes):
    """The golden pair (tests/data/golden_pair_*) through the port on
    ``device``; returns utils.fidelity.CompareResult.  The input buffer
    determines its FPN; with ``steady`` it then goes through the steady
    state -- the fused kernel, which subtracts that same mean line -- and
    that second output is compared."""
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
    out = model.process_buffer(raw)
    if steady:
        out = model.process_buffer(raw)
    return compare_volumes(model.fetch(out), ref)


def steady_ms_per_buffer(cfg: ProcConfig, device, ring: int = 4,
                         iters: int = 12, acq: AcqParams = FULL_ACQ) -> float:
    """CUDA-event ms per buffer of ``FdOctModel.process_buffer`` in the
    steady state (FPN determined), cycling over ``ring`` distinct buffers
    already on the device (:func:`random_buffers` of ``acq``: 12-bit
    samples, or 24-bit ones for :data:`WIDE_ACQ` with :func:`wide_config`)."""
    from .models.fdoct import FdOctModel

    model = FdOctModel(acq, cfg, **CURVE_KW, device=device)
    bufs = random_buffers(acq, ring, device, seed=11)
    model.process_buffer(bufs[0])  # FPN determination
    turn = itertools.count()
    return cuda_ms(lambda: model.process_buffer(bufs[next(turn) % ring]), iters=iters)


def fpn_buffer_ms(cfg: ProcConfig, device, ring: int = 4, iters: int = 12,
                  acq: AcqParams = FULL_ACQ) -> float:
    """CUDA-event ms of the FPN-determination buffer (the first-buffer
    latency): ``FdOctModel.process_buffer`` from a fresh FPN state
    (``redetermine_fpn`` before each call), cycling over ``ring`` distinct
    buffers already on the device (:func:`random_buffers`)."""
    from .models.fdoct import FdOctModel

    model = FdOctModel(acq, cfg, **CURVE_KW, device=device)
    bufs = random_buffers(acq, ring, device, seed=11)
    turn = itertools.count()

    def first_buffer():
        model.redetermine_fpn()
        model.process_buffer(bufs[next(turn) % ring])

    return cuda_ms(first_buffer, iters=iters)


def post_stage_ms(device, iters: int = 12) -> Dict[str, float]:
    """CUDA-event ms of each post stage alone on one full processed buffer
    (bscans, ascans, depth) of float32 values in [0, 1): the B-scan flip,
    the sinusoidal scan correction (the handheld preset's curve) and the
    post-process background removal (its mean A-scan, weight 0.8, offset
    0.05)."""
    from . import curves as curves_mod
    from .models.presets import handheld_sinusoidal_config
    from .ops import postprocess

    cv = curves_mod.make_curves(FULL_ACQ, handheld_sinusoidal_config(), **CURVE_KW,
                                device=device)
    g = torch.Generator(device=device)
    g.manual_seed(12)
    vol = torch.rand((FULL_ACQ.bscans_per_buffer, FULL_ACQ.ascans_per_bscan,
                      FULL_ACQ.output_ascan_length), generator=g, device=device)
    background = postprocess.get_background(vol)
    return {"bscan_flip": cuda_ms(lambda: postprocess.bscan_flip(vol), iters=iters),
            "sinusoidal_correction": cuda_ms(
                lambda: postprocess.sinusoidal_correction(vol, cv.sinusoidal_curve),
                iters=iters),
            "post_background_removal": cuda_ms(
                lambda: postprocess.remove_post_background(vol, background, 0.8, 0.05),
                iters=iters)}


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
    warmup = 2
    # No synchronisation inside the loop: the host runs ahead, so an event
    # pair spans device work and not the host's enqueueing of it.
    events = []
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
        events.append(ev)
    events[-1][-1].synchronize()
    totals = {name: sum(ev[k].elapsed_time(ev[k + 1]) for ev in events[warmup:]) / iters
              for k, name in enumerate(names)}
    if not torch.equal(mag, model.process_buffer(raw)):
        raise AssertionError("the timed stages differ from process_buffer")
    return totals


#: Published peaks of one H100 SXM (NVIDIA's data sheet, dense, 700 W):
#: bf16 on the tensor cores, and HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def kernel_bound(name: str, lines: int, n_in: int, n_out: int, *, parts: int = 1,
                 in_itemsize: int = 2, out_itemsize: int = 4,
                 x_parts: int = 1, bf16: bool = False) -> Dict[str, object]:
    """The least time one H100 could take for a kernel family's work: the
    larger of its FLOPs over the bf16 tensor-core peak and its bytes over
    the memory rate.  ``n_out`` is ``half`` for the fold families and the
    operator's width for the prep families; ``parts`` the operator parts
    per axis as the wrapper takes them (1, or 2/3 at the split rungs).

    FLOPs follow the Pallas cost estimates (octproz_tpu/pallas/fused_prep.py:
    482, 494, 597, 617, 655, 680, 704): 2*lines*n_in*n_out per GEMM (two
    GEMMs, re and im, for the fold families; one for prep) and pass term,
    counting only the terms the input needs: ``x_parts`` is the number of
    bf16 parts of x the data needs (``fused_prep.x_parts``: 1 where x is
    exact in bf16, as shifted 12-bit samples are; 2 for samples of at most
    16 bits; 3 above), of which the kernel splits x into at most two, or
    three at one pass on float32 lines (``in_itemsize`` 4), and x part i
    meets operator parts 0 .. parts - 1 - i: sum_i (parts - i) terms.  Every
    product is bf16 x bf16 on the tensor cores (989 TFLOP/s): the split
    rungs', and the one pass as the terms of the float32 operator's three
    bf16 parts on every input type (``fused_prep.ONE_PASS_ROUTES``).  With
    ``bf16`` (``compute_dtype="bfloat16"``) one bf16 term against one bf16
    part, on any input type.  Bytes: the raw input, every bf16 operator
    part the kernel reads, the FPN mean line or phasor rows, and the
    output, each once."""
    from .kernels.fused_prep import _ONE_PASS_PARTS

    three_x_parts = parts == 1 and in_itemsize == 4 and not bf16
    if parts == 1 and not bf16:
        parts = _ONE_PASS_PARTS
    xp = min(x_parts, 3 if three_x_parts else 2)
    terms = sum(parts - i for i in range(xp)) if parts > 1 else 1
    gemms = 1 if name.startswith("prep") else 2
    flops = terms * gemms * 2 * lines * n_in * n_out
    op_bytes = gemms * parts * n_in * n_out * 2
    if name.startswith("prep_phase"):
        extra, out = 2 * n_out * 4, lines * n_out * 8          # complex64 spectra
    elif name.startswith("prep"):
        extra, out = 0, lines * n_out * 4
    elif name.startswith("depth_scale"):
        extra, out = 2 * n_out * 4, lines * n_out * out_itemsize
    else:
        extra, out = 0, 2 * lines * n_out * 4                   # planar re, im
    nbytes = lines * n_in * in_itemsize + op_bytes + extra + out
    flop_ms = flops / PEAK_BF16_FLOPS * 1e3
    byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return {"bound_ms": max(flop_ms, byte_ms),
            "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
            "flops": flops, "bytes": nbytes}


def library_operands(x: torch.Tensor, axes: Sequence[Sequence[torch.Tensor]]):
    """The yardstick of a kernel family's product: ``torch.matmul(a, b)`` of
    the decoded input ``x`` by the operator parts of every axis
    concatenated along N -- float32 (x, with TF32 off) at one float32 part,
    bf16 (x_hi, the mask truncation) by the bf16 parts at the split rungs,
    and at one bf16 part (``compute_dtype="bfloat16"``) cuBLAS's bf16
    product of the same rounded operands (x rounded to nearest).  It
    computes the products of the terms x_hi needs; the kernel's epilogue and
    its other terms are not in it.  Returns (a, b)."""
    from .kernels import fused_prep as fp

    b = torch.cat([w for parts in axes for w in parts], dim=1).contiguous()
    if b.dtype != torch.bfloat16:
        return x, b
    if len(axes[0]) == 1:
        return x.to(torch.bfloat16), b
    return fp._bf16_trunc(x).to(torch.bfloat16), b


def float32_lines(acq: AcqParams, device, seed: int) -> torch.Tensor:
    """One buffer of 24-bit samples as float32 lines (lines, samples): what
    a source above 16 bits hands the kernels after its decode, made on the
    device from a seed."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return torch.randint(0, 1 << 24, (acq.ascans_per_buffer, acq.samples_per_line),
                         dtype=torch.int32, generator=g, device=device).to(torch.float32)


def _kernel_cases(name: str, device):
    """(kernel, plain, library, bound) for one kernel family at the main
    path's shapes: one 131072-line buffer of 1024 uint16 12-bit samples
    (shifted: x_lo is zero); the fold families -> 512 bins, the prep
    families -> 1024 columns; the split families at the "high" rung (3
    passes), the ``*_bf16`` names the one-pass family's bf16 route, the
    ``*_f32lines`` names its one pass on 24-bit samples as float32 lines
    (:func:`float32_lines`, no bitshift: the three-x-part tensor-core
    route).
    ``library`` is the matmul of :func:`library_operands`; the bound is
    :func:`kernel_bound` with x_parts read from the data and the lines'
    item size."""
    from . import curves as curves_mod
    from .kernels import fused_prep as fp

    precision = ("high" if name.endswith("_split") else fp.BF16 if name.endswith("_bf16")
                 else "default")
    if name.endswith("_f32lines"):
        raw2d, bitshift = float32_lines(FULL_ACQ, device, seed=5), False
    else:
        raw2d = random_buffers(FULL_ACQ, 1, device, seed=5).reshape(
            -1, FULL_ACQ.samples_per_line)
        bitshift = True
    x = fp._decode_block(raw2d, bitshift)
    shape = dict(lines=raw2d.shape[0], n_in=raw2d.shape[1],
                 parts=fp._SPLIT_PARTS.get(precision, 1),
                 x_parts=fp.x_parts(x), bf16=precision == fp.BF16,
                 in_itemsize=raw2d.element_size())
    if name.startswith("prep"):
        cv = curves_mod.make_curves(FULL_ACQ, fft_config(), **CURVE_KW, device=device)
        parts = fp._operator_parts(cv.prep_operator, precision)
        a, b = library_operands(x, [parts])
        bound = kernel_bound(name, n_out=parts[0].shape[1], **shape)
        if name.startswith("prep_phase"):
            rows = (cv.phase.real.contiguous(), cv.phase.imag.contiguous())
            return (lambda: fp._launch_prep(raw2d, parts, *rows, bitshift=bitshift),
                    lambda: fp.prep_phase_plain(raw2d, parts, *rows, bitshift=bitshift),
                    lambda: torch.matmul(a, b), bound)
        return (lambda: fp._launch_prep(raw2d, parts, None, None, bitshift=bitshift),
                lambda: fp.prep_real_plain(raw2d, parts, bitshift=bitshift),
                lambda: torch.matmul(a, b), bound)
    cfg = bench_config()
    cv = curves_mod.make_curves(FULL_ACQ, cfg, **CURVE_KW, device=device)
    wre = fp._operator_parts(cv.depth_op_re, precision)
    wim = fp._operator_parts(cv.depth_op_im, precision)
    a, b = library_operands(x, [wre, wim])
    bound = kernel_bound(name, n_out=wre[0].shape[1], **shape)
    library = lambda: torch.matmul(a, b)  # noqa: E731
    if name.startswith("depth_scale"):
        mean2 = torch.zeros((2, FULL_ACQ.output_ascan_length), dtype=torch.float32,
                            device=device)
        a_s, b_s = fp._scale_affine(True, FULL_ACQ.output_ascan_length, cfg.grayscale_min,
                                    cfg.grayscale_max, cfg.addend, cfg.multiplicator)
        kw = dict(bitshift=bitshift, log_scaling=True, a=a_s, b=b_s, out_dtype=torch.float32)
        if name.startswith("depth_scale_concat"):
            wide = fp.concat_operator(cv.depth_op_re, cv.depth_op_im, precision)
            return (lambda: fp._launch_depth_scale_concat(raw2d, wide, mean2, **kw),
                    lambda: fp.depth_scale_concat_plain(raw2d, wide, mean2, **kw),
                    library, bound)
        return (lambda: fp._launch_depth_scale(raw2d, wre, wim, mean2, fast_log=False,
                                               **kw),
                lambda: fp.depth_scale_plain(raw2d, wre, wim, mean2, **kw), library, bound)
    return (lambda: fp._launch_depth(raw2d, wre, wim, bitshift=bitshift),
            lambda: fp.depth_plain(raw2d, wre, wim, bitshift=bitshift), library, bound)


def kernel_times(device, names: Sequence[str] = FOLD_KERNELS,
                 iters: int = 5) -> Dict[str, Dict[str, object]]:
    """Each kernel family in ``names`` beside its plain version at the main
    path's shapes (see :func:`_kernel_cases`), in turns plain, kernel,
    kernel, plain; then the library call, and the bound computed from the
    same inputs."""
    out = {}
    for name in names:
        kernel, plain, library, bound = _kernel_cases(name, device)
        p1 = cuda_ms(plain, iters, warmup=1)
        k1 = cuda_ms(kernel, iters, warmup=1)
        k2 = cuda_ms(kernel, iters, warmup=0)
        p2 = cuda_ms(plain, iters, warmup=0)
        lib = cuda_ms(library, iters, warmup=1)
        out[name] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "library_ms": lib,
                     "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"]}
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
        cfg = at_rung(fft_config(), rung)
        ms = steady_ms_per_buffer(cfg, device)
        rungs[rung] = {"ms_per_buffer": ms, "equivalent_ascan_rate": lines / ms / 1e3,
                       "oracle_psnr_db": psnr[rung], "stages_ms": fft_stage_ms(cfg, device)}
    golden = golden_pair(device, fft_via_matmul=False, use_pallas_prep=True)
    return {"config": "presets.benchmark_config(tpu=False), use_pallas_prep=True",
            "rungs": rungs, "oracle_psnr_db": psnr,
            "golden_psnr_db": float(golden.psnr_db),
            "kernels": kernel_times(device, PREP_KERNELS)}


def stream_sources(directory: str, count: int = 3, seed: int = 40):
    """``count`` distinct 12-bit buffers of ``FULL_ACQ`` written once to
    ``directory`` as uint16 samples and as packed-12 wire bytes; returns
    {wire: VirtualOctSource replaying the file from RAM without end}, so
    the host source does not set the engine's pace."""
    from .io.source import VirtualOctSource
    from .ops.convert import pack_uint12

    bufs = np.random.default_rng(seed).integers(0, 4096, size=(count, *FULL_ACQ.buffer_shape),
                                                dtype=np.uint16)
    u16, p12 = os.path.join(directory, "u16.raw"), os.path.join(directory, "p12.raw")
    bufs.tofile(u16)
    pack_uint12(bufs).tofile(p12)
    del bufs
    return {"uint16": VirtualOctSource(u16, FULL_ACQ),
            "packed12": VirtualOctSource(p12, FULL_ACQ, packed_12bit=True,
                                         keep_packed=True)}


def engine_rate(cfg: ProcConfig, device, source, wire: str, dispatch_chunk: int = 1,
                seconds: float = 5.0, warmup: int = 8, window_s: float = 1.0,
                max_buffers: int = 5000, attach=None, mesh=None) -> Dict[str, object]:
    """The engine's end-to-end rate on ``source`` (the upload, the step and
    the quantized fetch of every buffer included): the buffers that reached
    the host after the first ``warmup`` (rounded up to whole chunks; they
    hold the FPN buffer and the pipeline's fill) over the wall time they
    took, in a run stopped once about ``seconds`` have passed after the
    warm-up.  Both ends of the timed span are the arrival of a chunk's last
    buffer.  The ThroughputMeter's ``window_s`` windows after the first are
    kept as a spread statistic (``window_mhz``).  ``attach(engine)``, when
    given, is called before the run (a live viewer chaining onto the
    engine's callbacks).  ``mesh``: the model's step sharded over it
    (``parallel.make_mesh``), ``device`` its first device."""
    from .models.fdoct import FdOctModel
    from .runtime import StreamingEngine

    chunk = max(1, dispatch_chunk)
    warm = -(-warmup // chunk) * chunk - 1  # the last buffer of a chunk
    model = FdOctModel(FULL_ACQ, cfg, **CURVE_KW, device=device, mesh=mesh)
    arrived, windows = [], []

    def on_processed(_host, _buffer_nr):
        arrived.append(time.perf_counter())
        if len(arrived) > warm and arrived[-1] - arrived[warm] >= seconds:
            eng.stop()

    eng = StreamingEngine(model, source, wire_format=wire, stream_to_host=True,
                          dispatch_chunk=chunk, metrics_window_s=window_s,
                          on_metrics=windows.append, on_processed=on_processed)
    if attach is not None:
        attach(eng)
    t0 = time.perf_counter()
    n = eng.run(max_buffers=max_buffers)
    wall = time.perf_counter() - t0
    ends = arrived[:len(arrived) // chunk * chunk]  # whole chunks only
    timed = len(ends) - 1 - warm
    if timed < chunk:
        raise AssertionError(f"the engine delivered {len(arrived)} buffers; "
                             f"{warm + 1} are warm-up")
    span = ends[-1] - ends[warm]
    rate = timed * FULL_ACQ.ascans_per_buffer / span
    wire_bytes = (FULL_ACQ.samples_per_buffer * 3 // 2 if wire == "packed12"
                  else FULL_ACQ.bytes_per_buffer)
    return {"ascans_per_s": rate, "mhz": rate / 1e6, "timed_buffers": timed,
            "timed_s": span, "buffers": n, "wall_s": wall,
            "wire_mb_per_s": timed * wire_bytes / span / 1e6,
            "window_mhz": [w.ascans_per_s / 1e6 for w in windows[1:]]}


def transfer_ms(device, source_u16, source_p12, reps: int = 5) -> Dict[str, float]:
    """The engine's per-buffer transfer stages on their own, at full size:
    ``stage`` (host copy of a buffer into pinned memory, host clock, uint16
    and packed-12), ``h2d`` (pinned -> device, both wires), ``unpack``
    (packed-12 -> uint16 on the device) and ``d2h`` (the 12-bit quantized
    image, device -> pinned), CUDA events."""
    from .ops.convert import unpack_uint12_device
    from .ops.quantize import quantize

    out = {}
    for wire, src in (("uint16", source_u16), ("packed12", source_p12)):
        host = torch.from_numpy(np.ascontiguousarray(src.read_buffer(0)))
        pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
        t0 = time.perf_counter()
        for _ in range(reps):
            pinned.copy_(host)
        out[f"stage_{wire}"] = (time.perf_counter() - t0) / reps * 1e3
        dev = torch.empty(host.shape, dtype=host.dtype, device=device)
        out[f"h2d_{wire}"] = cuda_ms(lambda: dev.copy_(pinned, non_blocking=True), reps)
        if wire == "packed12":
            out["unpack"] = cuda_ms(lambda: unpack_uint12_device(dev, FULL_ACQ.samples_per_buffer),
                                    reps)
    img = quantize(torch.rand(FULL_ACQ.processed_buffer_shape, device=device), 12)
    back = torch.empty(img.shape, dtype=img.dtype, pin_memory=True)
    out["d2h"] = cuda_ms(lambda: back.copy_(img, non_blocking=True), reps)
    return out


def ring_ms(acq: AcqParams, frame: np.ndarray, reps: int = 5) -> Dict[str, float]:
    """The host stages of a buffer through ``io.hwbridge.HardwareRingSource``
    on their own, host clock, mean over ``reps``: ``write`` (the producer's
    ``write_blocking`` into a slot), ``read`` (``buffers()`` handing out a
    copy of the slot) and ``stage`` (the engine's copy of that buffer into
    pinned memory)."""
    from .io.hwbridge import HardwareRingSource

    src = HardwareRingSource(acq, n_slots=2)
    out = dict.fromkeys(("write", "read", "stage"), 0.0)
    try:
        stream = src.buffers()
        pinned = torch.empty(frame.shape, dtype=acq.raw_dtype, pin_memory=True)
        for _ in range(reps):
            t0 = time.perf_counter()
            src.write_blocking(frame)
            t1 = time.perf_counter()
            buf = next(stream)
            t2 = time.perf_counter()
            pinned.copy_(torch.from_numpy(buf))
            t3 = time.perf_counter()
            for key, span in zip(out, (t1 - t0, t2 - t1, t3 - t2)):
                out[key] += span * 1e3 / reps
            del buf
    finally:
        src.close()
    return out


def stream_path_record(device) -> Dict[str, object]:
    """The ``paths.stream`` record: the concat path's steady state and the
    engine's rate on both wires, per buffer and in batch chunks of four,
    at every timed rung."""
    lines = FULL_ACQ.ascans_per_buffer
    out = {"config": "bench_config(fold_concat=True), stream_to_host, streaming_skip=0",
           "rungs": {}}
    with tempfile.TemporaryDirectory() as tmp:
        sources = stream_sources(tmp)
        out["transfer_ms"] = transfer_ms(device, sources["uint16"], sources["packed12"])
        for rung in TIMED_RUNGS:
            cfg = at_rung(bench_config(fold_concat=True), rung)
            ms = steady_ms_per_buffer(cfg, device)
            rec = {"ms_per_buffer": ms, "equivalent_ascan_rate": lines / ms / 1e3}
            for wire, src in sources.items():
                for chunk in (1, 4):
                    rec[f"engine_{wire}_chunk{chunk}"] = engine_rate(cfg, device, src, wire,
                                                                    chunk)
            out["rungs"][rung] = rec
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("octproz_tpu_torch.bench: no CUDA device; the bench "
                         "measures the GPU only")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in true float32
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    info = device_info()
    psnr = oracle_psnr(tuple(ORACLE_GATE_DB), device)
    for rung, gate in ORACLE_GATE_DB.items():
        if psnr[rung] < gate:
            raise SystemExit(f"bench: rung {rung!r} failed its fidelity gate: "
                             f"{psnr[rung]:.2f} dB < {gate} dB")
    lines = FULL_ACQ.ascans_per_buffer
    rungs = {}
    for rung in ORACLE_GATE_DB:
        ms_rung = steady_ms_per_buffer(at_rung(bench_config(), rung), device)
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
        "paths": {"fft": fft_path_record(device), "stream": stream_path_record(device)},
        "platform": info["platform"],
        "device_name": info["device_name"],
        "power_limit": info["power_limit"],
        "geometry": list(FULL_ACQ.buffer_shape),
    }
    print(json.dumps(record))


if __name__ == "__main__":
    main()
