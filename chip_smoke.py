"""Smoke test of the PyTorch/CUDA port (octproz_tpu_torch) on one GPU.

    python3 chip_smoke.py        (from the root of a checkout, one CUDA GPU)

Phases, each printing progress; any failure raises, so the exit code is
nonzero and the final line is not printed:

1. device: the card's name and power limit;
2. build: the CUDA kernels from ``octproz_tpu_torch/kernels/csrc``;
3. kernels: each kernel family (four fold, two concat fold, four prep)
   against its plain PyTorch version on the card, at the main path's
   widths, an odd line count and 1664-sample lines (and 1100 for the split
   fold, the concat and the prep kernels: 550 bins, not a multiple of the
   64-bin tile, and for the concat kernel's split rung an im view that is
   not 16-byte aligned, read element by element; 1088 for the concat and
   the prep kernels: 544 bins, a half-empty last tile), every family's
   one pass on both of its routes (uint8/uint16 lines on the tensor cores,
   float32 lines on the float32-FMA kernel, the route read back and
   logged), then controls (a kernel computing a neighbouring rung, or for
   the concat kernels reading the im half one column early) that must
   fail;
4. fold path: ``FdOctModel`` on full 1024 x 512 x 256 buffers of the
   reference benchmark chain on the folded GEMM -- FPN determination,
   steady buffers and a batched chunk -- at the default and the "high"
   rung, then the handheld preset (post stages, batched chunk), with the
   fold kernels' launch counts read around that run; each rung's steady
   output and buffer 0's GEMM against the plain versions at full size (a
   one-pass steady output against the float64 product of its float32
   operator, see ``_check_steady_full_size``);
5. FFT path: the same chain through the prep kernels and cuFFT at the
   default, "high" and "highest" rungs (scan chunk against per-buffer
   steps), its dispersion-free variant and the handheld preset, with the
   prep kernels' launch counts read around that run (every default-rung
   phase and real launch on the tensor cores) and the split kernels' around each
   split rung's runs; each rung's full-size prep output against the plain
   versions;
6. stream: ``StreamingEngine`` over full 12-bit buffers replayed from RAM
   by ``VirtualOctSource``, the benchmark chain with ``fold_concat`` at the
   default and the "high" rung, per buffer and in batch chunks of four, on
   the uint16 and the packed-12 wire, every buffer quantized and fetched
   to the host, with the launch counts read around each engine run (the
   rung's concat kernel launched for every steady buffer or chunk, the
   two-operator steady-state kernels not, every one-pass launch on the
   tensor cores): the streamed float32 recorder
   output against ``process_buffer`` on the same buffers, the packed-12
   wire's against the uint16 wire's (exact), the steady concat output at
   full size as in phase 4, and the engine's A-scan rate
   with the upload included (buffers over wall time, 3 s after warm-up)
   beside the steady ``process_buffer`` rate;
7. bf16: ``compute_dtype="bfloat16"`` -- the bf16 route of the five
   one-pass families (B1/B2/B5/B7/B8: x rounded to nearest, one rounded
   bf16 operator part, one term) against its plain version on uint8,
   shifted and unshifted 12-bit, full 16-bit and float32 lines and the
   ragged shapes, the route read back per case, and two controls that must
   fail (x truncated, not rounded; the one-pass rung's three-part route);
   then ``default_full_config()`` at bf16 on full 1024 x 512 x 256 buffers
   through ``FdOctModel`` on the fold path, the concat path and the FFT
   path with and without dispersion, with the launch counts read around
   that run (every launch of the five families on the bf16 route, none on
   another), each steady output at full size against the float64 product
   of the rounded operands (the prep output against its plain version);
8. fidelity: the golden pair and the float64-oracle ladder on the fold,
   concat and FFT paths (bf16 at least at the default gate and 20 dB below
   the default rung; its golden pair recorded, not gated), the golden pair
   through the concat kernels (``fold_concat``, the buffer's steady-state
   output) at the default and the "high" rung, and the prep output of the
   phase and the real kernels against float64 per rung (default and
   "highest" at least 20 dB above "high");
9. trace: one ``utils.profiling.trace`` of ``StreamingEngine.run`` on the
   concat path at the default rung, uint16 wire, after a warm-up run: the
   device's busy time (the union of its kernels and copies), its idle share
   over the traced window, the top device operations and the longest idle
   gaps with the host operations that overlap them; a trace without CUDA
   events fails;
10. times: steady-state ms per buffer and MHz on both paths at every timed
   rung, bf16 included (the FFT path split into prep kernel, FFT and FPN
   plus scaling), and each kernel beside its plain version, the library
   call for its product (``bench.library_operands``) and its bound
   (``bench.kernel_bound``).

The last line is ``{"ok": true, "device": {...}}``; the line before it holds
the kernels' JSON record (the bf16 routes as ``*_bf16``), the one before
that nvidia-smi's name and power limit.  JAX is never imported: the oracle
comes from ``tests/oracle.py`` (numpy only).
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CSRC = "octproz_tpu_torch/kernels/csrc/"
PALLAS = "octproz_tpu/pallas/fused_prep.py:"
# family -> (source of the kernel the main path launches, Pallas kernel body
# it replaces); every family runs on the tensor cores for the main path's
# uint16 lines: the fold families enter through fold_gemm.cu and
# fold_concat.cu, the prep families through prep_gemm.cu, which keep the
# float32-FMA kernel for the one pass on float32 lines
KERNELS = {
    "depth": ("fold_split.cu", 261),
    "depth_split": ("fold_split.cu", 271),
    "depth_scale": ("fold_split.cu", 375),
    "depth_scale_split": ("fold_split.cu", 422),
    "depth_scale_concat": ("fold_split.cu", 337),
    "depth_scale_concat_split": ("fold_split.cu", 354),
    "prep_phase": ("prep_split.cu", 228),
    "prep_phase_split": ("prep_split.cu", 245),
    "prep_real": ("prep_split.cu", 238),
    "prep_real_split": ("prep_split.cu", 254),
    # compute_dtype="bfloat16": the one-pass families' bf16 route
    "depth_bf16": ("fold_split.cu", 261),
    "depth_scale_bf16": ("fold_split.cu", 375),
    "depth_scale_concat_bf16": ("fold_split.cu", 337),
    "prep_phase_bf16": ("prep_split.cu", 228),
    "prep_real_bf16": ("prep_split.cu", 238),
}
#: The bf16 rows of KERNELS by their LAUNCHES family.
BF16_ROWS = {k[:-len("_bf16")]: k for k in KERNELS if k.endswith("_bf16")}
CONCAT = ("depth_scale_concat", "depth_scale_concat_split")
TWO_OPERATOR = ("depth_scale", "depth_scale_split")
FOLD = tuple(k for k in KERNELS if k.startswith("depth") and k not in CONCAT
             and k not in BF16_ROWS.values())
PREP = tuple(k for k in KERNELS if k.startswith("prep") and k not in BF16_ROWS.values())

# Kernel vs plain version on the card (both float32): the bounds of
# fused_prep.planar_error / scale_error / prep_error -- relative L2 <= 3e-6
# for planar fold output and <= 1e-6 for prep spectra; RMS <= 1e-6 and max
# <= 1e-4 display units above the display floor for a float32 store; one
# bf16 step more for a bf16 store -- each set between the float32
# reordering noise and the nearest wrong rung (readings in fused_prep.py).
# The controls at the end of phase 3 show on the card that a wrong rung
# fails them.
#
# Oracle rungs: the gates of bench.py are floors; "highest" must also clear
# "high" by RUNG_GAP_DB, since its operator carries ~24 bits against ~16
# (about 30 dB apart on an H100), so a 5-pass kernel that computed the
# 3-pass math would read as "high" and fail.  On the FFT path the float32
# FFT's own rounding caps "highest" at the default rung's level (135.1
# against 135.0 dB on an H100 at a 700 W limit; "high" 111.7 dB): the gap
# still holds end to end and is held there, and it is held again on the
# prep output before the FFT, where each rung keeps its own error budget
# (``_prep_snr_db``).
RUNG_GAP_DB = 20.0
#: Display floor (dB) of the one-pass kernel cases by sample kind: 20 log10 of
#: the samples' range over that of 8-bit values (12, 16 and 24 bits).
ONE_PASS_FLOOR_DB = {"u16": 24.0, "u16f": 48.0, "f32": 96.0}
#: The precision rungs the FFT path phase drives.
RUNGS = ("default", "high", "highest")
#: The bf16 rung (compute_dtype="bfloat16") must sit this far below the
#: default rung's oracle PSNR: a bf16 run that took a float32-grade route
#: would read as the default rung (bf16 operands carry 8 bits, about 2^-9
#: relative, against float32's 24).
BF16_GAP_DB = 20.0


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this smoke test needs one CUDA GPU")
    sys.path.insert(0, ROOT)
    from octproz_tpu_torch import bench

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in true float32
    torch.backends.cudnn.allow_tf32 = False
    info = bench.device_info()
    log(f"[device] {info['device_name']} x{info['device_count']}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    return info


def phase_build():
    from octproz_tpu_torch.kernels import build

    t0 = time.perf_counter()
    build.load()
    took = time.perf_counter() - t0
    lines = (build.library_path().parent / "build.log").read_text().splitlines()
    regs = [int(l.split("Used ")[1].split()[0]) for l in lines if "Used " in l]
    spills = [l.strip() for l in lines if "spill stores" in l
              and "0 bytes spill stores, 0 bytes spill loads" not in l]
    log(f"[build] {build.library_path()} in {took:.1f} s; {len(regs)} kernels, "
        f"max {max(regs) if regs else 'n/a'} registers; spills: {spills or 'none'}")
    return took


def _raw(kind, lines, n_in, g, dev):
    """Random raw lines: "u16s" 12-bit samples shifted to 8 bits (as on the
    main path: x_lo = 0), "u16" 12 bits unshifted (x_lo != 0), "u16f" all 16
    bits, "u8", or "f32" (a 24-bit source decoded before the kernel)."""
    import torch

    if kind == "u16f":
        return torch.randint(-32768, 32768, (lines, n_in), dtype=torch.int16,
                             generator=g, device=dev).view(torch.uint16)
    if kind in ("u16", "u16s"):
        return torch.randint(0, 4096, (lines, n_in), dtype=torch.int16,
                             generator=g, device=dev).view(torch.uint16)
    if kind == "u8":
        return torch.randint(0, 256, (lines, n_in), dtype=torch.uint8,
                             generator=g, device=dev)
    return torch.randint(0, 1 << 24, (lines, n_in), dtype=torch.int32,
                         generator=g, device=dev).to(torch.float32)


def _compare(raw, wre, wim, bitshift, mode, odt, g, ref=None, floor_db=0.0):
    """The kernel on (raw, wre, wim) against the plain version on ``ref``
    (default the same inputs), log scaling over the 60 dB from ``floor_db``
    up.  Returns (max |err|, detail, within bounds)."""
    import torch

    from octproz_tpu_torch.kernels import fused_prep as fp

    rraw, rre, rim = ref or (raw, wre, wim)
    if mode is None:
        got = fp.fold_depth(raw, wre, wim, bitshift=bitshift)
        want = fp.depth_plain(rraw, rre, rim, bitshift=bitshift)
        err = fp.planar_error(got, want)
        worst = max(float((a - b).abs().max()) for a, b in zip(got, want))
        return worst, (f"rel L2 {err:.3e} (bound {fp.PLANAR_REL_L2:g}), "
                       f"max|err| {worst:.3e}"), err <= fp.PLANAR_REL_L2
    half = wre[0].shape[1]
    mean2 = torch.randn((2, half), generator=g, device=raw.device) * 50.0
    lo = 0.0 if mode == "lin" else floor_db
    a, b = fp._scale_affine(mode != "lin", half, lo, lo + 60.0, 0.0, 1.0)
    kw = dict(bitshift=bitshift, log_scaling=mode != "lin", a=a, b=b,
              fast_log=mode == "fast_log", out_dtype=odt)
    got = fp.fold_depth_scale(raw, wre, wim, mean2, **kw)
    want = fp.depth_scale_plain(rraw, rre, rim, mean2, **kw)
    rms, worst, ok = fp.scale_error(got, want)
    bound = (f"{fp.SCALE_MAX:g} + bf16 step" if odt == torch.bfloat16
             else f"RMS {fp.SCALE_RMS:g}, max {fp.SCALE_MAX:g}")
    return worst, (f"above the display floor RMS {rms:.3e}, max {worst:.3e} "
                   f"(bound {bound})"), ok


def phase_kernels():
    """Each family at rungs 1/3/5 -- with x_lo terms zero (shifted 12-bit
    samples, as on the main path) and nonzero (unshifted 12-bit, full 16-bit
    and float inputs) --, fast_log, lin, float32 and bf16 stores,
    uint8/uint16/float inputs, an odd line count and n_in = 1664; the
    one-pass rung's route is read back after each of its cases (tensor cores
    for integer lines, the float32-FMA kernel for float32 lines); then the
    controls, which must fail."""
    import torch

    from octproz_tpu_torch import bench
    from octproz_tpu_torch import curves as curves_mod
    from octproz_tpu_torch.kernels import fused_prep as fp
    from octproz_tpu_torch.params import AcqParams

    dev = torch.device("cuda", 0)
    f32, bf16 = torch.float32, torch.bfloat16
    worst = {k: 0.0 for k in KERNELS}  # max |err| at the main path's inputs
    cases = [
        # (n_in, lines, input, passes, scale mode or None, out dtype)
        (1024, 4096, "u16s", 1, None, None),
        (1024, 4096, "u16s", 3, None, None),
        (1024, 4096, "u16s", 5, None, None),
        (1024, 4096, "u16", 3, None, None),
        (1024, 4096, "u16", 5, None, None),
        (1024, 4096, "u16s", 1, "log", f32),
        (1024, 4096, "u16s", 3, "log", f32),
        (1024, 4096, "u16s", 5, "log", f32),
        (1024, 4096, "u16", 3, "log", f32),
        (1024, 4096, "u16", 5, "log", f32),
        (1024, 4096, "u16s", 1, "fast_log", f32),
        (1024, 4096, "u16s", 1, "lin", f32),
        (1024, 4096, "u16s", 1, "log", bf16),
        (1024, 4096, "u16s", 3, "log", bf16),
        (1024, 4133, "u16s", 1, None, None),
        (1024, 4133, "u16s", 3, "log", f32),
        (1664, 1000, "u16s", 3, None, None),
        (1664, 1000, "u16", 5, None, None),
        (1664, 1000, "u16s", 1, "log", f32),
        (1024, 2048, "u8", 1, "log", f32),
        (1024, 2048, "f32", 5, None, None),
        (1024, 2048, "f32", 3, "log", f32),
        # the split kernels' ragged edges: 550 bins (1100 samples) and 4133
        # lines against their 64-bin and 128-line tiles; uint8 input
        (1100, 999, "u16", 3, None, None),
        (1100, 999, "u16s", 3, "log", f32),
        (1100, 999, "u16", 5, "log", f32),
        (1024, 4133, "u16s", 3, None, None),
        (1024, 2048, "u8", 3, None, None),
        (1024, 2048, "u8", 3, "log", f32),
    ]
    ops = {}
    for n_in in sorted({c[0] for c in cases} | {1088}):  # 1088: the concat cases
        acq = AcqParams(samples_per_line=n_in, ascans_per_bscan=8, bscans_per_buffer=1)
        cv = curves_mod.make_curves(acq, bench.bench_config(), **{
            **bench.CURVE_KW, "resample_coeffs": (0.0, n_in - 1.0, 20.0, -10.0)}, device=dev)
        ops[n_in] = (cv.depth_op_re, cv.depth_op_im)

    def parts(n_in, precision):
        return tuple(fp._operator_parts(w, precision) for w in ops[n_in])

    g = torch.Generator(device=dev)
    g.manual_seed(3)
    _fold_cases(cases, parts, worst, g, dev)

    # Controls: a kernel that computed a neighbouring rung must fail.
    raw = _raw("u16", 4096, 1024, g, dev)
    p5, p3 = parts(1024, "highest"), parts(1024, "high")
    x_hi = fp._bf16_trunc(raw.to(torch.float32))
    controls = [
        ("3-pass kernel on the highest parts", (raw, p5[0][:2], p5[1][:2]), (raw, *p5)),
        ("3-pass kernel without x_lo (x_hi input)", (x_hi, *p3), (raw, *p3)),
    ]
    _fold_controls(controls, g)
    _concat_kernel_cases(worst, ops, g, dev)
    _prep_kernel_cases(worst, g, dev)
    _one_pass_kernel_cases(worst, parts, dev)
    _bf16_kernel_cases(worst, parts, ops, dev)
    return worst


#: A case's passes -> its rung: the C entries' passes argument, 0 for the
#: bf16 route (``compute_dtype="bfloat16"``).
RUNG_OF_PASSES = {0: "bfloat16", 1: "default", 3: "high", 5: "highest"}


def _row(family, passes):
    """The LAUNCHES family's row in KERNELS / ``worst`` at ``passes``."""
    return family + ("_bf16" if passes == 0 else "")


def _fold_cases(cases, parts, worst, g, dev):
    """Each (n_in, lines, input, passes, scale mode or None, out dtype) of
    the two-operator fold kernels against its plain version; a one-pass
    case's route is read back and must follow its input type (at passes 0,
    the bf16 route, on every input type)."""
    import torch

    from octproz_tpu_torch.kernels import fused_prep as fp

    f32 = torch.float32
    for n_in, lines, kind, passes, mode, odt in cases:
        raw = _raw(kind, lines, n_in, g, dev)
        fp.reset_launch_counts()
        # At one pass (and at bf16) the plain version is a float32 product
        # of its own, so both sides carry their rounding, and log10
        # amplifies it without bound in the nulls: the display floor stays
        # 36 dB under the mean level of the samples, where 8-bit values
        # have it at 0 dB.
        floor_db = ONE_PASS_FLOOR_DB.get(kind, 0.0) if passes <= 1 else 0.0
        err, detail, ok = _compare(raw, *parts(n_in, RUNG_OF_PASSES[passes]), kind == "u16s",
                                   mode, odt, g, floor_db=floor_db)
        torch.cuda.synchronize()
        family = ("depth" if mode is None else "depth_scale") + ("_split" if passes > 1 else "")
        row = _row(family, passes)
        if n_in == 1024 and kind == "u16s" and odt in (None, f32):
            worst[row] = max(worst[row], err)  # the main path's inputs
        route = _route_read_back(family, kind, bf16=passes == 0) if passes <= 1 else ""
        log(f"[kernels] {row:<17} n_in={n_in} lines={lines} {kind} passes={passes} "
            f"{mode or 'planar'} {str(odt).replace('torch.', '') if odt else ''}{route}: "
            f"{detail} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{row} kernel disagrees with its plain version")


def _route_read_back(family, kind, bf16=False):
    """The one-pass route of the last launch, which at float32 compute the
    input type alone picks: float32 lines on the float32-FMA kernel,
    uint8/uint16 lines on the tensor cores; at bf16 compute (``bf16``) the
    bf16 route on every input type.  The launch counts were reset before
    that one launch."""
    from octproz_tpu_torch.kernels import fused_prep as fp

    want = "tensor_core_bf16" if bf16 else "simt" if kind == "f32" else "tensor_core"
    if fp.ONE_PASS_ROUTES[family] != {**dict.fromkeys(fp.ONE_PASS_ROUTES[family], 0), want: 1}:
        raise AssertionError(f"{family} on {kind} lines took the routes "
                             f"{fp.ONE_PASS_ROUTES[family]}, want {want}")
    return f" [route: {want}]"


def _fold_controls(controls, g, floor_db=0.0):
    """Each (name, kernel inputs, plain inputs): a kernel computing a
    neighbouring rung must fail the bounds, planar and scaled (display floor
    at ``floor_db``)."""
    import torch

    for name, kernel_in, plain_in in controls:
        for mode in (None, "log"):
            _, detail, ok = _compare(*kernel_in, False, mode, torch.float32, g, ref=plain_in,
                                     floor_db=floor_db)
            torch.cuda.synchronize()
            log(f"[kernels] control: {name}, {mode or 'planar'}: {detail} -> "
                f"{'passes (BAD)' if ok else 'fails, as it must'}")
            if ok:
                raise AssertionError(f"control {name!r} passed: the bounds do "
                                     f"not separate the rungs")


def _one_pass_kernel_cases(worst, parts, dev):
    """The one-pass rung of the two-operator fold kernels beyond the main
    path's inputs, on data of its own generator: on the tensor cores with
    x_lo nonzero (unshifted 12-bit and full 16-bit samples: five terms),
    uint8, every scale mode and store, n_in = 1664 and the ragged shapes;
    float32 lines on the float32-FMA kernel; then its controls, which must
    fail against the float32 product: the "high" parts (two of its three,
    the third zeroed) through its entry, and its three-part math without
    x_lo (x_hi as uint16 samples)."""
    import torch

    from octproz_tpu_torch.kernels import fused_prep as fp

    f32, bf16 = torch.float32, torch.bfloat16
    cases = [
        # lin on 8-bit values: its bounds are absolute display units
        (1024, 4096, "u16", 1, None, None),
        (1024, 4096, "u16f", 1, None, None),
        (1024, 4096, "u16", 1, "log", f32),
        (1024, 4096, "u16f", 1, "log", f32),
        (1024, 4096, "u16", 1, "fast_log", f32),
        (1024, 4096, "u8", 1, "lin", f32),
        (1024, 4096, "u16", 1, "log", bf16),
        (1024, 2048, "u8", 1, None, None),
        (1024, 4133, "u16f", 1, None, None),
        (1664, 1000, "u16", 1, None, None),
        (1100, 999, "u16", 1, None, None),
        (1100, 999, "u16s", 1, "log", f32),
        (1100, 999, "u8", 1, "lin", f32),
        # float32 lines at one pass keep the float32-FMA kernel
        (1024, 2048, "f32", 1, None, None),
        (1024, 2048, "f32", 1, "log", f32),
    ]
    g = torch.Generator(device=dev)
    g.manual_seed(6)
    _fold_cases(cases, parts, worst, g, dev)
    raw = _raw("u16", 4096, 1024, g, dev)
    p1 = parts(1024, "default")
    two = tuple(fp.OnePass(w[0], split=(*w.split[:2], torch.zeros_like(w.split[2])))
                for w in p1)
    x_hi16 = fp._bf16_trunc(raw.to(f32)).to(torch.int16).view(torch.uint16)
    _fold_controls([
        ("one-pass kernel on two of its three parts", (raw, *two), (raw, *p1)),
        ("one-pass kernel without x_lo (x_hi input)", (x_hi16, *p1), (raw, *p1)),
    ], g, floor_db=ONE_PASS_FLOOR_DB["u16"])


def _bf16_kernel_cases(worst, parts, ops, dev):
    """The bf16 route (passes 0: ``compute_dtype="bfloat16"``) of the five
    one-pass families -- B1/B2 (two operators), B5 (concat), B7/B8 (prep)
    -- against the plain versions on the same rounded operands, on uint8,
    shifted and unshifted 12-bit, full 16-bit and float32 lines, every
    scale mode and store, the ragged shapes (n_in 1088: a half-empty last
    tile; 1100: for B5 half % 8 != 0, the element-wise producer), the route
    read back per case; on a generator of their own.  Then two controls,
    which must fail against the bf16 plain version on unshifted 12-bit
    samples (shifted ones have at most 8 significant bits and are exact in
    bf16, so rounding and truncation agree there): the kernel fed x
    truncated to bf16 (the x_hi of the split rungs) in place of x rounded
    to nearest, and the one-pass rung's three-part route."""
    import torch

    from octproz_tpu_torch.kernels import fused_prep as fp

    f32, bf16 = torch.float32, torch.bfloat16
    g = torch.Generator(device=dev)
    g.manual_seed(10)
    _fold_cases([
        (1024, 4096, "u16s", 0, None, None),
        (1024, 4096, "u16", 0, None, None),
        (1024, 4096, "u16f", 0, None, None),
        (1024, 2048, "u8", 0, None, None),
        (1024, 2048, "f32", 0, None, None),
        (1024, 4133, "u16s", 0, None, None),
        (1664, 1000, "u16", 0, None, None),
        (1100, 999, "u16", 0, None, None),
        (1024, 4096, "u16s", 0, "log", f32),
        (1024, 4096, "u16", 0, "log", f32),
        (1024, 4096, "u16f", 0, "log", f32),
        (1024, 4096, "u16s", 0, "fast_log", f32),
        (1024, 4096, "u16", 0, "fast_log", f32),
        (1024, 4096, "u16s", 0, "lin", f32),
        (1024, 4096, "u16s", 0, "log", bf16),
        (1024, 2048, "u8", 0, "lin", f32),
        (1024, 2048, "f32", 0, "log", f32),
        (1100, 999, "u16s", 0, "log", f32),
        (1024, 4133, "u16", 0, "log", f32),
    ], parts, worst, g, dev)
    _concat_cases([
        (1024, 4096, "u16s", 0, True, f32),
        (1024, 4096, "u16", 0, True, f32),
        (1024, 4096, "u16f", 0, True, f32),
        (1024, 4096, "u16s", 0, False, f32),
        (1024, 4096, "u16s", 0, True, bf16),
        (1024, 2048, "u8", 0, True, f32),
        (1024, 2048, "f32", 0, True, f32),
        (1024, 4133, "u16s", 0, True, f32),
        (1088, 999, "u16", 0, True, f32),
        (1100, 999, "u16", 0, True, f32),
        (1100, 999, "f32", 0, True, f32),
    ], ops, worst, g, dev)
    prep_cases = [(n, lines, kind, 0, epi, bg) for epi in ("phase", "real")
                  for n, lines, kind, bg in ((1024, 4096, "u16s", False), (1024, 4096, "u16", False),
                                             (1024, 4096, "u16f", True), (1024, 2048, "u8", False),
                                             (1024, 2048, "f32", False), (1088, 999, "u16", False),
                                             (1100, 999, "u16", True), (1024, 4133, "u16s", False))]
    prep_ops = {(n, bg): _prep_operators(n, bg, dev) for n, bg in {(c[0], c[5]) for c in prep_cases}}
    _prep_cases(prep_cases, prep_ops, worst, g, dev)

    raw = _raw("u16", 4096, 1024, g, dev)
    x_trunc = fp._bf16_trunc(raw.to(f32)).to(torch.int16).view(torch.uint16)
    pb, p1 = parts(1024, fp.BF16), parts(1024, "default")
    _fold_controls([
        ("bf16 kernel fed truncated x", (x_trunc, *pb), (raw, *pb)),
        ("the three-part one-pass route in place of bf16", (raw, *p1), (raw, *pb)),
    ], g, floor_db=ONE_PASS_FLOOR_DB["u16"])
    wb, w1 = (fp.concat_operator(*ops[1024], r) for r in (fp.BF16, "default"))
    _concat_controls([
        ("bf16 concat kernel fed truncated x", (x_trunc, wb), (raw, wb)),
        ("the three-part one-pass concat route in place of bf16", (raw, w1), (raw, wb)),
    ], g, floor_db=ONE_PASS_FLOOR_DB["u16"])
    op, rows = prep_ops[(1024, False)]
    qb, q1 = fp._operator_parts(op, fp.BF16), fp._operator_parts(op, "default")
    for epi, epi_rows in (("phase", rows), ("real", None)):
        for name, kernel_in in ((f"bf16 {epi} kernel fed truncated x", (x_trunc, qb)),
                                (f"the three-part one-pass {epi} route in place of bf16",
                                 (raw, q1))):
            _, detail, ok = _compare_prep(*kernel_in, epi_rows, False, ref=(raw, qb))
            torch.cuda.synchronize()
            log(f"[kernels] control: {name}: {detail} -> "
                f"{'passes (BAD)' if ok else 'fails, as it must'}")
            if ok:
                raise AssertionError(f"control {name!r} passed: the prep bound does not "
                                     f"catch it")


def _compare_concat(raw, wide, bitshift, log_scaling, odt, g, ref=None, floor_db=0.0):
    """A concat kernel on (raw, wide parts) against its plain version on
    ``ref`` (default the same inputs), log scaling over the 60 dB from
    ``floor_db`` up.  Returns (max |err|, detail, within the bounds)."""
    import torch

    from octproz_tpu_torch.kernels import fused_prep as fp

    rraw, rwide = ref or (raw, wide)
    half = wide[0].shape[1] // 2
    mean2 = torch.randn((2, half), generator=g, device=raw.device) * 50.0
    lo = floor_db if log_scaling else 0.0
    a, b = fp._scale_affine(log_scaling, half, lo, lo + 60.0, 0.0, 1.0)
    kw = dict(bitshift=bitshift, log_scaling=log_scaling, a=a, b=b, out_dtype=odt)
    got = fp.fold_depth_scale_concat(raw, wide, mean2, **kw)
    want = fp.depth_scale_concat_plain(rraw, rwide, mean2, **kw)
    rms, worst, ok = fp.scale_error(got, want)
    bound = (f"{fp.SCALE_MAX:g} + bf16 step" if odt == torch.bfloat16
             else f"RMS {fp.SCALE_RMS:g}, max {fp.SCALE_MAX:g}")
    return worst, (f"above the display floor RMS {rms:.3e}, max {worst:.3e} "
                   f"(bound {bound})"), ok


def _concat_kernel_cases(worst, ops, g, dev):
    """The concat fold families (B5/B6) on the two-operator families' grid
    -- rungs 1/3/5 with x_lo zero and nonzero, log and lin, float32 and
    bf16 stores, uint8/uint16/float inputs, an odd line count, n_in = 1664
    --, the split rung's own ragged shapes (n_in = 1088 and 1100), then the
    controls, which must fail: the wrong rung, and the im half read one
    column early at one and at three passes (swapping re and im would not
    do: p is symmetric in them)."""
    import torch

    from octproz_tpu_torch.kernels import fused_prep as fp

    f32, bf16 = torch.float32, torch.bfloat16
    cases = [
        # (n_in, lines, input, passes, log scaling, out dtype)
        (1024, 4096, "u16s", 1, True, f32),
        (1024, 4096, "u16s", 3, True, f32),
        (1024, 4096, "u16s", 5, True, f32),
        (1024, 4096, "u16", 3, True, f32),
        (1024, 4096, "u16", 5, True, f32),
        (1024, 4096, "u16s", 1, False, f32),
        (1024, 4096, "u16", 3, False, f32),
        (1024, 4096, "u16s", 1, True, bf16),
        (1024, 4096, "u16s", 3, True, bf16),
        (1024, 4133, "u16s", 1, True, f32),
        (1024, 4133, "u16s", 3, True, f32),
        (1664, 1000, "u16s", 1, True, f32),
        (1664, 1000, "u16", 5, True, f32),
        (1024, 2048, "u8", 1, True, f32),
        (1024, 2048, "f32", 3, True, f32),
        (1024, 2048, "f32", 5, True, f32),
    ]
    _concat_cases(cases, ops, worst, g, dev)
    # The split rung on the tensor-core pipeline, which reads each wide part
    # as two views at row pitch 2 * half: 544 bins (a half-empty last 64-bin
    # tile), 550 bins (the im view not 16-byte aligned: the element-wise
    # producer), uint8, a bf16 store at 5 passes; on a generator of their
    # own, so the cases after them keep their data.
    g_split = torch.Generator(device=dev)
    g_split.manual_seed(7)
    _concat_cases([
        (1088, 999, "u16", 3, True, f32),
        (1088, 4133, "u16s", 3, True, f32),
        (1100, 999, "u16", 3, True, f32),
        (1100, 999, "u16s", 5, False, f32),
        (1024, 2048, "u8", 3, True, f32),
        (1024, 4096, "u16s", 5, True, bf16),
    ], ops, worst, g_split, dev)

    raw = _raw("u16", 4096, 1024, g, dev)
    p5, p3 = (fp.concat_operator(*ops[1024], r) for r in ("highest", "high"))
    one = fp.concat_operator(*ops[1024], "default")
    w1 = one[0]
    half = w1.shape[1] // 2

    def im_early(w):  # the im column of bin j at half - 1 + j
        return torch.cat([w[:, :half + 1], w[:, half:-1]], dim=1).contiguous()

    x_hi = fp._bf16_trunc(raw.to(torch.float32))
    controls = [
        ("3-pass concat kernel on the highest parts", (raw, p5[:2]), (raw, p5)),
        ("3-pass concat kernel without x_lo (x_hi input)", (x_hi, p3), (raw, p3)),
        ("one-pass concat kernel reading im at column half - 1 + j", (raw, (im_early(w1),)),
         (raw, (w1,))),
        ("3-pass concat kernel reading im at column half - 1 + j",
         (raw, tuple(im_early(w) for w in p3)), (raw, p3)),
    ]
    _concat_controls(controls, g)

    # The one pass on both routes beyond the main path's inputs: unshifted
    # 12-bit and full 16-bit samples (x_lo terms), 544 bins (a half-empty
    # last tile) and 550 (each view's three parts read element by element),
    # lin on 8-bit values, float32 lines on the float32-FMA kernel; on a
    # generator of their own, with the display floor of their samples'
    # range; then the one pass's own controls against the float32 product.
    g_one = torch.Generator(device=dev)
    g_one.manual_seed(9)
    _concat_cases([
        (1024, 4096, "u16", 1, True, f32),
        (1024, 4096, "u16f", 1, True, f32),
        (1024, 4096, "u16", 1, True, bf16),
        (1088, 999, "u16", 1, True, f32),
        (1088, 4133, "u16s", 1, True, f32),
        (1100, 999, "u16", 1, True, f32),
        (1100, 999, "u16s", 1, False, f32),
        (1100, 999, "u8", 1, False, f32),
        (1024, 2048, "f32", 1, True, f32),
        (1100, 999, "f32", 1, True, f32),
    ], ops, worst, g_one, dev)
    raw = _raw("u16", 4096, 1024, g_one, dev)
    two = fp.OnePass(w1, split=(*one.split[:2], torch.zeros_like(one.split[2])))
    x_hi16 = fp._bf16_trunc(raw.to(f32)).to(torch.int16).view(torch.uint16)
    _concat_controls([
        ("one-pass concat kernel on two of its three parts", (raw, two), (raw, one)),
        ("one-pass concat kernel without x_lo (x_hi input)", (x_hi16, one), (raw, one)),
    ], g_one, floor_db=ONE_PASS_FLOOR_DB["u16"])


def _concat_controls(controls, g, floor_db=0.0):
    """Each (name, kernel inputs, plain inputs) of a concat kernel: it must
    fail the scale bounds (display floor at ``floor_db``)."""
    import torch

    for name, kernel_in, plain_in in controls:
        _, detail, ok = _compare_concat(*kernel_in, False, True, torch.float32, g,
                                        ref=plain_in, floor_db=floor_db)
        torch.cuda.synchronize()
        log(f"[kernels] control: {name}: {detail} -> "
            f"{'passes (BAD)' if ok else 'fails, as it must'}")
        if ok:
            raise AssertionError(f"control {name!r} passed: the bounds do not catch it")


def _concat_cases(cases, ops, worst, g, dev):
    """Each (n_in, lines, input, passes, log scaling, out dtype) of the
    concat fold kernels against its plain version; a one-pass case's route
    is read back and must follow its input type, and its display floor
    follows its samples' range (``ONE_PASS_FLOOR_DB``)."""
    import torch

    from octproz_tpu_torch.kernels import fused_prep as fp

    for n_in, lines, kind, passes, log_scaling, odt in cases:
        raw = _raw(kind, lines, n_in, g, dev)
        wide = fp.concat_operator(*ops[n_in], RUNG_OF_PASSES[passes])
        fp.reset_launch_counts()
        floor_db = ONE_PASS_FLOOR_DB.get(kind, 0.0) if passes <= 1 else 0.0
        err, detail, ok = _compare_concat(raw, wide, kind == "u16s", log_scaling, odt, g,
                                          floor_db=floor_db)
        torch.cuda.synchronize()
        family = "depth_scale_concat" + ("_split" if passes > 1 else "")
        row = _row(family, passes)
        if n_in == 1024 and kind == "u16s" and odt == torch.float32:
            worst[row] = max(worst[row], err)  # the main path's inputs
        route = _route_read_back(family, kind, bf16=passes == 0) if passes <= 1 else ""
        log(f"[kernels] {row:<24} n_in={n_in} lines={lines} {kind} passes={passes} "
            f"{'log' if log_scaling else 'lin'} {str(odt).replace('torch.', '')}{route}: "
            f"{detail} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{row} kernel disagrees with its plain version")


def _compare_prep(raw, parts, rows, bitshift, ref=None):
    """A prep kernel (phase with ``rows`` = (cos, sin), real with None) on
    (raw, parts) against its plain version on ``ref`` (default the same
    inputs).  Returns (max |err|, detail, within the bound)."""
    from octproz_tpu_torch.kernels import fused_prep as fp

    rraw, rparts = ref or (raw, parts)
    if rows is None:
        got = fp.prep_real(raw, parts, bitshift=bitshift)
        want = fp.prep_real_plain(rraw, rparts, bitshift=bitshift)
    else:
        got = fp.prep_phase(raw, parts, *rows, bitshift=bitshift)
        want = fp.prep_phase_plain(rraw, rparts, *rows, bitshift=bitshift)
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"prep kernel gave {got.dtype} {tuple(got.shape)}, "
                             f"plain {want.dtype} {tuple(want.shape)}")
    err = fp.prep_error(got, want)
    worst = float((got - want).abs().max())
    return worst, (f"rel L2 {err:.3e} (bound {fp.PREP_REL_L2:g}), max|err| {worst:.3e}"
                   ), err <= fp.PREP_REL_L2


def _prep_operators(n_in, background_removal, dev):
    """The FFT path's prep operator (float32) and phasor rows at n_in."""
    from octproz_tpu_torch import bench
    from octproz_tpu_torch import curves as curves_mod
    from octproz_tpu_torch.params import AcqParams

    acq = AcqParams(samples_per_line=n_in, ascans_per_bscan=8, bscans_per_buffer=1)
    cfg = bench.fft_config(background_removal=background_removal)
    cv = curves_mod.make_curves(acq, cfg, **{
        **bench.CURVE_KW, "resample_coeffs": (0.0, n_in - 1.0, 20.0, -10.0)}, device=dev)
    return cv.prep_operator, (cv.phase.real.contiguous(), cv.phase.imag.contiguous())


def _prep_kernel_cases(worst, g, dev):
    """The prep families on the fold kernels' grid -- rungs 1/3/5, shifted
    and unshifted 12-bit, uint8 and float inputs, an odd line count,
    n_in = 1664 -- plus n_in = 1100 (ragged in n_in and n_out), 1088 (a
    half-empty last tile of the tensor-core kernels) and the operator with
    background removal folded in (denser, so more reordering); both
    kernels' one pass on both of its routes (uint8/uint16 lines on the
    tensor cores, float32 lines on the float32-FMA kernel, the route read
    back after each one-pass case); then the controls, which must fail --
    at the split rungs a neighbouring rung, at one pass each kernel on two
    of its three parts and without x_lo, against the float32 product."""
    import torch

    from octproz_tpu_torch.kernels import fused_prep as fp

    cases = [
        # (n_in, lines, input, passes, "phase" or "real", background removal)
        (1024, 4096, "u16s", 1, "phase", False),
        (1024, 4096, "u16s", 3, "phase", False),
        (1024, 4096, "u16s", 5, "phase", False),
        (1024, 4096, "u16", 3, "phase", False),
        (1024, 4096, "u16", 5, "phase", False),
        (1024, 4096, "u16s", 1, "real", False),
        (1024, 4096, "u16s", 3, "real", False),
        (1024, 4096, "u16s", 5, "real", False),
        (1024, 4096, "u16", 3, "real", False),
        (1024, 4096, "u16", 5, "real", False),
        (1024, 4096, "u16", 1, "phase", True),
        (1024, 4096, "u16", 3, "real", True),
        (1024, 4133, "u16s", 1, "phase", False),
        (1024, 4133, "u16s", 3, "real", False),
        (1664, 1000, "u16s", 3, "phase", False),
        (1664, 1000, "u16", 5, "real", False),
        (1664, 1000, "u16s", 1, "real", False),
        (1100, 999, "u16", 3, "phase", True),
        (1100, 999, "u16s", 1, "real", False),
        (1024, 2048, "u8", 1, "phase", False),
        (1024, 2048, "f32", 5, "phase", False),
        (1024, 2048, "f32", 3, "real", False),
        # the split kernels' ragged edges: a TMA-aligned n_out whose last
        # 128-column tile is half empty (1088), 4133 lines, background
        # removal at 5 passes, uint8 input
        (1088, 999, "u16", 3, "phase", False),
        (1088, 999, "u16", 3, "real", False),
        (1088, 4133, "u16s", 3, "phase", True),
        (1024, 4133, "u16", 5, "real", True),
        (1024, 2048, "u8", 3, "phase", False),
        (1024, 2048, "u8", 3, "real", False),
    ]
    # The prep kernels' one pass beyond the cases above: unshifted 12-bit
    # and full 16-bit samples (x_lo terms), background removal, n_in = 1088
    # and 1100 (its uint16 rows not 16-byte aligned: the element-wise
    # producer), and float32 lines on the float32-FMA kernel; on a generator
    # of their own, so the controls keep their data.
    one_pass = [
        (1024, 4096, "u16", 1, "phase", False),
        (1024, 4096, "u16f", 1, "phase", False),
        (1024, 4096, "u16f", 1, "phase", True),
        (1088, 999, "u16", 1, "phase", False),
        (1088, 4133, "u16s", 1, "phase", True),
        (1024, 2048, "f32", 1, "phase", False),
        (1024, 4096, "u16", 1, "real", False),
        (1024, 4096, "u16f", 1, "real", False),
        (1024, 4096, "u16f", 1, "real", True),
        (1088, 999, "u16", 1, "real", False),
        (1088, 4133, "u16s", 1, "real", True),
        (1100, 999, "u16", 1, "real", True),
        (1024, 2048, "f32", 1, "real", False),
        (1100, 999, "f32", 1, "real", False),
    ]
    ops = {(n, bg): _prep_operators(n, bg, dev)
           for n, bg in {(c[0], c[5]) for c in cases + one_pass}}
    _prep_cases(cases, ops, worst, g, dev)
    g_one = torch.Generator(device=dev)
    g_one.manual_seed(8)
    _prep_cases(one_pass, ops, worst, g_one, dev)

    raw = _raw("u16", 4096, 1024, g, dev)
    op, rows = ops[(1024, False)]
    p5, p3 = fp._operator_parts(op, "highest"), fp._operator_parts(op, "high")
    x_hi = fp._bf16_trunc(raw.to(torch.float32))
    controls = [
        ("3-pass kernel on the highest parts", (raw, p5[:2]), (raw, p5)),
        ("3-pass kernel without x_lo (x_hi input)", (x_hi, p3), (raw, p3)),
    ]
    for name, kernel_in, plain_in in controls:
        for epi_rows in (rows, None):
            _, detail, ok = _compare_prep(*kernel_in, epi_rows, False, ref=plain_in)
            torch.cuda.synchronize()
            log(f"[kernels] control: {name}, prep {'phase' if epi_rows else 'real'}: "
                f"{detail} -> {'passes (BAD)' if ok else 'fails, as it must'}")
            if ok:
                raise AssertionError(f"control {name!r} passed: the prep bound does "
                                     f"not separate the rungs")
    p1 = fp._operator_parts(op, "default")
    two = fp.OnePass(p1[0], split=(*p1.split[:2], torch.zeros_like(p1.split[2])))
    x_hi16 = x_hi.to(torch.int16).view(torch.uint16)
    for epi, epi_rows in (("phase", rows), ("real", None)):
        for name, kernel_in in ((f"one-pass {epi} kernel on two of its three parts", (raw, two)),
                                (f"one-pass {epi} kernel without x_lo (x_hi input)",
                                 (x_hi16, p1))):
            _, detail, ok = _compare_prep(*kernel_in, epi_rows, False, ref=(raw, p1))
            torch.cuda.synchronize()
            log(f"[kernels] control: {name}: {detail} -> "
                f"{'passes (BAD)' if ok else 'fails, as it must'}")
            if ok:
                raise AssertionError(f"control {name!r} passed: the prep bound does not "
                                     f"catch it")


def _prep_cases(cases, ops, worst, g, dev):
    """Each (n_in, lines, input, passes, "phase" or "real", background
    removal) of the prep kernels against its plain version; a one-pass
    case's route is read back and must follow its input type."""
    import torch

    from octproz_tpu_torch.kernels import fused_prep as fp

    for n_in, lines, kind, passes, epi, bg in cases:
        op, rows = ops[(n_in, bg)]
        raw = _raw(kind, lines, n_in, g, dev)
        fp.reset_launch_counts()
        err, detail, ok = _compare_prep(raw, fp._operator_parts(op, RUNG_OF_PASSES[passes]),
                                        rows if epi == "phase" else None, kind == "u16s")
        torch.cuda.synchronize()
        family = f"prep_{epi}" + ("_split" if passes > 1 else "")
        row = _row(family, passes)
        if n_in == 1024 and kind == "u16s" and not bg:
            worst[row] = max(worst[row], err)  # the main path's inputs
        route = _route_read_back(family, kind, bf16=passes == 0) if passes <= 1 else ""
        log(f"[kernels] {row:<17} n_in={n_in} lines={lines} {kind} passes={passes}"
            f"{' bg' if bg else ''}{route}: {detail} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{row} kernel disagrees with its plain version")


def _run_main_path(model, host_raw, bufs, tag):
    """Buffer 0 (FPN determination) from the host, three steady buffers, a
    batched chunk of four; checks batch == per-buffer steps."""
    import torch

    acq = model.acq
    out0 = model.process_buffer(host_raw)
    if not model.fpn_state.determined:
        raise AssertionError("FPN was not determined on buffer 0")
    steady = [model.process_buffer(bufs[i]) for i in range(3)]
    chunk = model.process_chunk(bufs, strategy="batch")
    steady.append(model.process_buffer(bufs[3]))
    torch.cuda.synchronize()
    want = (acq.bscans_per_buffer, acq.ascans_per_bscan, acq.output_ascan_length)
    for out in [out0, *steady]:
        if tuple(out.shape) != want:
            raise AssertionError(f"output shape {tuple(out.shape)} != {want}")
        if not bool(torch.isfinite(out).all()):
            raise AssertionError("non-finite values in the processed buffer")
    if tuple(chunk.shape) != (4, *want):
        raise AssertionError(f"chunk shape {tuple(chunk.shape)}")
    for i in range(4):
        a, b = steady[i], chunk[i]
        if not torch.equal(torch.isfinite(a), torch.isfinite(b)):
            raise AssertionError("batch and per-buffer finite masks differ")
        if not torch.allclose(a, b, atol=1e-5, rtol=1e-5):
            raise AssertionError(f"batch buffer {i} != per-buffer step "
                                 f"({float((a - b).abs().max()):.3e})")
    log(f"[main] {tag}: buffer 0 + 3 steady + batch of 4, shape {want}, "
        f"batch == per-buffer (atol 1e-5)")
    return steady[0], bufs[0]


def _check_steady_full_size(model, out, raw):
    """The main path's first steady buffer against its kernel's semantics on
    the same full-size input (no kernel launch).  At the split rungs that is
    the plain version (two-operator or, with fold_concat, concat), which
    sums the same pass terms.  At one pass the plain version is a float32
    product with rounding of its own, and over a full buffer's deepest
    nulls log10 amplifies it past the max bound (on the card it read 1.7e-4
    against the kernel on one stream buffer, while the kernel's three-part
    sum stays closer to the exact product): the kernel is held to the same
    bounds against the product of the same float32 operator evaluated in
    float64, and its distance to the plain version is logged beside it.
    At bf16 compute likewise, against the float64 product of the rounded
    operands (x and the operator rounded to bf16, as the kernel takes
    them)."""
    import torch

    from octproz_tpu_torch.kernels import fused_prep as fp

    acq, cfg = model.acq, model.cfg
    rung = fp.operator_rung(cfg)
    a, b = fp._scale_affine(cfg.log_scaling, acq.output_ascan_length, cfg.grayscale_min,
                            cfg.grayscale_max, cfg.addend, cfg.multiplicator)
    kw = dict(bitshift=cfg.bitshift, log_scaling=cfg.log_scaling, a=a, b=b)
    raw2d = raw.reshape(-1, acq.samples_per_line)
    mean2 = model.fpn_state.mean_line
    if cfg.fold_concat:
        wide = fp.concat_operator(*model.curves.depth_parts, rung)
        plain = fp.depth_scale_concat_plain(raw2d, wide, mean2, **kw)
    else:
        plain = fp.depth_scale_plain(raw2d, *model.curves.depth_parts, mean2, **kw)
    got = out.reshape(plain.shape)
    family = ("depth_scale_concat" if cfg.fold_concat else "depth_scale") \
        + {"default": "", fp.BF16: "_bf16"}.get(rung, "_split")
    what, ref = "plain version", plain
    if rung in ("default", fp.BF16):
        rms, worst, _ = fp.scale_error(got, plain)
        log(f"[main] {family} full buffer ({rung}) vs plain version (float32 product): "
            f"above the display floor RMS {rms:.3e}, max {worst:.3e}")
        x = fp._decode_block(raw2d, cfg.bitshift)
        w_re, w_im = model.curves.depth_op_re, model.curves.depth_op_im
        if rung == fp.BF16:
            x, w_re, w_im = (t.to(torch.bfloat16) for t in (x, w_re, w_im))
        x = x.double()
        m64 = mean2.double()
        re = x @ w_re.double() - m64[0:1]
        im = x @ w_im.double() - m64[1:2]
        p = re * re + im * im
        ref = fp._f32(a) * (torch.log10(p) if cfg.log_scaling else torch.sqrt(p)) + fp._f32(b)
        del x, re, im, p
        rms, worst, _ = fp.scale_error(plain, ref)
        log(f"[main] plain version (float32 product) vs the float64 product: above the "
            f"display floor RMS {rms:.3e}, max {worst:.3e}")
        what = "the float64 product"
    rms, worst, ok = fp.scale_error(got, ref)
    log(f"[main] {family} full buffer ({rung}) vs {what}: "
        f"above the display floor RMS {rms:.3e}, max {worst:.3e} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"full-size {family} output disagrees with {what}")
    return family, worst


def _check_output(outs, acq, tag):
    """Every output of the buffer's processed shape, with no NaN and no
    +inf.  -inf is log10(0): without dispersion the DC bin is real, and a
    line whose DC equals the FPN mean exactly has p = 0 there (the
    reference's exact path gives -inf too; such a voxel displays black), so
    it is counted and must stay rare."""
    import torch

    want = (acq.bscans_per_buffer, acq.ascans_per_bscan, acq.output_ascan_length)
    for out in outs:
        if tuple(out.shape) != want:
            raise AssertionError(f"{tag}: output shape {tuple(out.shape)} != {want}")
        if bool(torch.isnan(out).any()) or bool(torch.isposinf(out).any()):
            raise AssertionError(f"{tag}: NaN or +inf in the processed buffer")
        black = int(torch.isneginf(out).sum())
        if black > out.numel() * 1e-5:
            raise AssertionError(f"{tag}: {black} voxels at -inf (p == 0)")
        if black:
            log(f"[main] {tag}: {black} voxel(s) at -inf (p == 0 after FPN)")


def _run_handheld(model, bufs, tag, batch):
    """The handheld preset (post stages): buffer 0 (FPN determination) and
    two steady buffers; on the fold path also a batched chunk of those two,
    which must equal the per-buffer steps."""
    import torch

    out0 = model.process_buffer(bufs[0])
    steady = [model.process_buffer(bufs[i]) for i in (1, 2)]
    _check_output([out0, *steady], model.acq, tag)
    if batch:
        chunk = model.process_chunk(bufs[1:3], strategy="batch")
        for a, b in zip(steady, chunk):
            if not torch.allclose(a, b, atol=1e-5, rtol=1e-5):
                raise AssertionError(f"{tag}: batch != per-buffer step "
                                     f"({float((a - b).abs().max()):.3e})")
    log(f"[main] {tag}: buffer 0 + 2 steady{' + batch of 2 == per-buffer' if batch else ''}")


def _check_routes(launches, tag, route="tensor_core"):
    """Every one-pass launch of a path's run on uint16 lines went to
    ``route`` (the tensor cores; at bf16 compute their bf16 route):
    ``ONE_PASS_ROUTES`` against the run's launch counts (none for a family
    the path does not launch)."""
    from octproz_tpu_torch.kernels import fused_prep as fp

    routes = {k: dict(v) for k, v in fp.ONE_PASS_ROUTES.items()}
    log(f"[main] {tag} one-pass routes "
        f"{ {k: v for k, v in routes.items() if any(v.values())} }")
    want = {k: {**dict.fromkeys(v, 0), route: launches.get(k, 0)} for k, v in routes.items()}
    if routes != want:
        raise AssertionError(f"{tag}: one-pass launches by route {routes}, want {want}")


def _read_launches(families, t0, tag):
    import torch

    from octproz_tpu_torch.kernels import fused_prep as fp

    torch.cuda.synchronize()
    launches = {k: fp.LAUNCHES[k] for k in families}
    log(f"[main] {tag} launches {launches} ({time.perf_counter() - t0:.1f} s)")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"{tag} never launched {missing}")
    return launches


def phase_main_path(worst):
    import torch

    from octproz_tpu_torch import bench
    from octproz_tpu_torch.kernels import fused_prep as fp
    from octproz_tpu_torch.models.fdoct import FdOctModel
    from octproz_tpu_torch.models.presets import handheld_sinusoidal_config

    dev = torch.device("cuda", 0)
    acq = bench.FULL_ACQ
    host_raw = np.random.default_rng(20).integers(0, 4096, size=acq.buffer_shape,
                                                  dtype=np.uint16)
    bufs = bench.random_buffers(acq, 4, dev, seed=21)
    model = FdOctModel(acq, bench.bench_config(), **bench.CURVE_KW, device=dev)
    handheld = FdOctModel(acq, handheld_sinusoidal_config(tpu=True), **bench.CURVE_KW,
                          device=dev)
    torch.cuda.synchronize()

    fp.reset_launch_counts()
    t0 = time.perf_counter()
    for rung in ("default", "high"):
        if rung != "default":
            model.set_config(matmul_precision=rung)
            model.redetermine_fpn()
        out, raw = _run_main_path(model, host_raw, bufs, f"{rung} rung")
        family, err = _check_steady_full_size(model, out, raw)
        worst[family] = max(worst[family], err)
        del out
    _run_handheld(handheld, bufs, "fold path, handheld preset", batch=True)
    launches = _read_launches(FOLD, t0, "fold path")
    _check_routes(launches, "fold path")
    del handheld

    # Buffer 0's GEMM (the depth families) at full size on buffer 0's input,
    # after the counts were read.
    raw0 = torch.from_numpy(host_raw).to(dev).reshape(-1, acq.samples_per_line)
    for rung in ("default", "high"):
        w = tuple(fp._operator_parts(op, rung)
                  for op in (model.curves.depth_op_re, model.curves.depth_op_im))
        err, detail, ok = _compare(raw0, *w, True, None, None, None)
        family = "depth" if rung == "default" else "depth_split"
        worst[family] = max(worst[family], err)
        log(f"[main] {family} full buffer 0 ({rung}) vs plain version: {detail} "
            f"-> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"full-size {family} output disagrees with the plain version")
    return launches


def _run_fft_path(model, host_raw, bufs, tag):
    """Buffer 0 (FPN determination) from the host, four steady buffers, and
    a scan chunk of the same four, which must equal the per-buffer steps."""
    import torch

    out0 = model.process_buffer(host_raw)
    if not model.fpn_state.determined:
        raise AssertionError("FPN was not determined on buffer 0")
    steady = [model.process_buffer(bufs[i]) for i in range(4)]
    chunk = model.process_chunk(bufs, strategy="auto")  # the FFT path scans
    torch.cuda.synchronize()
    _check_output([out0, *steady], model.acq, tag)
    if tuple(chunk.shape) != (4, *steady[0].shape):
        raise AssertionError(f"chunk shape {tuple(chunk.shape)}")
    for i in range(4):
        if not torch.equal(steady[i], chunk[i]):
            raise AssertionError(f"{tag}: scan chunk buffer {i} != per-buffer step "
                                 f"({float((steady[i] - chunk[i]).abs().max()):.3e})")
    log(f"[fft] {tag}: buffer 0 + 4 steady + scan chunk of 4, shape "
        f"{tuple(steady[0].shape)}, scan == per-buffer (exact)")


def phase_fft_path(worst):
    """The FFT path at full width: the benchmark chain (phase kernels) at
    every rung, its dispersion-free variant (real kernels) and the handheld
    preset, with the prep kernels' launch counts read around the run (and
    the split kernels' around each split rung); then each rung's full-size
    prep output against the plain versions."""
    import torch

    from octproz_tpu_torch import bench
    from octproz_tpu_torch.kernels import fused_prep as fp
    from octproz_tpu_torch.models.fdoct import FdOctModel
    from octproz_tpu_torch.models.presets import handheld_sinusoidal_config

    dev = torch.device("cuda", 0)
    acq = bench.FULL_ACQ
    host_raw = np.random.default_rng(30).integers(0, 4096, size=acq.buffer_shape,
                                                  dtype=np.uint16)
    bufs = bench.random_buffers(acq, 4, dev, seed=31)
    models = {"phase": FdOctModel(acq, bench.fft_config(), **bench.CURVE_KW, device=dev),
              "real": FdOctModel(acq, bench.fft_config(dispersion=False), **bench.CURVE_KW,
                                 device=dev)}
    handheld = FdOctModel(acq, dataclasses.replace(handheld_sinusoidal_config(tpu=False),
                                                   use_pallas_prep=True),
                          **bench.CURVE_KW, device=dev)
    torch.cuda.synchronize()

    fp.reset_launch_counts()
    t0 = time.perf_counter()
    for rung in RUNGS:
        before = dict(fp.LAUNCHES)
        for epi, model in models.items():
            if rung != "default":
                model.set_config(matmul_precision=rung)
                model.redetermine_fpn()
            _run_fft_path(model, host_raw, bufs,
                          f"{rung} rung, {'dispersion' if epi == 'phase' else 'no dispersion'}")
        if rung != "default":  # each split rung's own runs went through the split kernels
            ran = {k: fp.LAUNCHES[k] - before[k] for k in PREP if k.endswith("_split")}
            log(f"[fft] {rung} rung launches {ran}")
            if not all(ran.values()):
                raise AssertionError(f"FFT path at {rung!r} never launched a split prep "
                                     f"kernel: {ran}")
    _run_handheld(handheld, bufs, "FFT path, handheld preset", batch=False)
    launches = _read_launches(PREP, t0, "FFT path")
    _check_routes(launches, "FFT path")
    del handheld

    # Full-size prep output of each rung against the plain version, after
    # the counts were read.
    raw2d = bufs[0].reshape(-1, acq.samples_per_line)
    for rung in RUNGS:
        for epi, model in models.items():
            if model.cfg.matmul_precision != rung:
                model.set_config(matmul_precision=rung)
            cv = model.curves
            rows = (cv.phase.real.contiguous(), cv.phase.imag.contiguous()) \
                if epi == "phase" else None
            err, detail, ok = _compare_prep(raw2d, cv.prep_parts, rows, True)
            family = f"prep_{epi}" + ("_split" if rung != "default" else "")
            worst[family] = max(worst[family], err)
            log(f"[fft] {family} full buffer ({rung}) vs plain version: {detail} "
                f"-> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"full-size {family} output disagrees with the plain "
                                     f"version")
    return launches


def _engine_launches(run, rung, need, tag):
    """``run()`` -- one ``StreamingEngine.run`` -- between a reset and a read
    of the launch counts.  The rung's concat family must have launched at
    least ``need(result)`` times (the steady buffers or chunks the run
    dispatched) and no other steady-state family at all, and every one-pass
    launch of the run (the default rung's concat kernel, the FPN buffer's
    fold kernel) must have gone to the tensor cores.  Returns the result
    and the run's concat counts."""
    import torch

    from octproz_tpu_torch.kernels import fused_prep as fp

    torch.cuda.synchronize()
    fp.reset_launch_counts()
    result = run()
    torch.cuda.synchronize()
    counts = {k: fp.LAUNCHES[k] for k in CONCAT + TWO_OPERATOR}
    family = CONCAT[0] if rung == "default" else CONCAT[1]
    want = need(result)
    if counts[family] < want or any(v for k, v in counts.items() if k != family):
        raise AssertionError(f"{tag}: engine run launched {counts}; want {family} >= "
                             f"{want} and no other steady-state family")
    _check_routes({k: fp.LAUNCHES[k] for k in fp.ONE_PASS_ROUTES}, tag)
    return result, {k: counts[k] for k in CONCAT}


def _record_stream(cfg, source, wire, chunk, directory, dev, tag):
    """Two buffers of the engine's float32 recorder stream (every buffer
    quantized and fetched as well), with the engine run's launch counts.
    For a chunked run the model's FPN is determined on buffer 0 first, so
    both recorded buffers come out of one batch kernel; per buffer, the
    run's first buffer determines the FPN and the second is steady."""
    from octproz_tpu_torch import bench
    from octproz_tpu_torch.io.recorder import RecordingParams
    from octproz_tpu_torch.models.fdoct import FdOctModel
    from octproz_tpu_torch.runtime import StreamingEngine

    acq = bench.FULL_ACQ
    model = FdOctModel(acq, cfg, **bench.CURVE_KW, device=dev)
    if chunk > 1:
        model.process_buffer(source.read_buffer(0) if wire == "uint16"
                             else model.put_packed_buffer(source.read_buffer(0)))
    eng = StreamingEngine(model, source, wire_format=wire, stream_to_host=True,
                          dispatch_chunk=chunk, chunk_strategy="batch" if chunk > 1 else "auto")
    eng.start_recording(RecordingParams(save_dir=directory, name=f"{wire}{chunk}",
                                        buffers_to_record=2, save_raw=False,
                                        save_processed=True, save_as_32bit_float=True,
                                        save_meta=False))
    want = max(chunk, 2)
    n, counts = _engine_launches(lambda: eng.run(max_buffers=want), cfg.matmul_precision,
                                 lambda n: n // chunk if chunk > 1 else n - 1, tag)
    path = eng.processed_recorder.last_file
    if n != want or path is None:
        raise AssertionError(f"{tag}: {n} buffers, recording {path}")
    out = np.fromfile(path, np.float32).reshape(2, *acq.processed_buffer_shape)
    os.remove(path)
    return out, counts


def phase_stream(worst, info):
    """The streaming runtime at full width on the concat path: see the
    module docstring, phase 6.  Returns the concat kernels' launch counts,
    summed over the engine runs alone."""
    import tempfile

    import torch

    from octproz_tpu_torch import bench
    from octproz_tpu_torch.kernels import fused_prep as fp
    from octproz_tpu_torch.models.fdoct import FdOctModel

    dev = torch.device("cuda", 0)
    acq = bench.FULL_ACQ
    card = f"{info['device_name']}, power limit {info['power_limit']}"
    rates = {}
    launches = dict.fromkeys(CONCAT, 0)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        sources = bench.stream_sources(tmp)
        log(f"[stream] sources: 3 buffers per wire written and read back in "
            f"{time.perf_counter() - t0:.1f} s")
        host = [sources["uint16"].read_buffer(i) for i in range(2)]
        for rung in ("default", "high"):
            cfg = bench.bench_config(fold_concat=True, matmul_precision=rung)
            ref_model = FdOctModel(acq, cfg, **bench.CURVE_KW, device=dev)
            ref = [ref_model.fetch(ref_model.process_buffer(host[0]))]   # FPN buffer
            steady = [ref_model.process_buffer(b) for b in (host[1], host[0])]
            ref += [ref_model.fetch(t) for t in steady]
            want = {1: (ref[0], ref[1]), 4: (ref[2], ref[1])}
            recorded = {}
            for wire, src in sources.items():
                for chunk in (1, 4):
                    mode = "batch chunks of 4" if chunk > 1 else "per buffer"
                    tag = f"stream {rung} {wire} {mode}"
                    got, counts = _record_stream(cfg, src, wire, chunk, tmp, dev, tag)
                    recorded[(wire, chunk)] = got
                    for i in range(2):
                        rms, err, ok = fp.scale_error(torch.from_numpy(got[i]),
                                                      torch.from_numpy(want[chunk][i]))
                        if not ok:
                            raise AssertionError(
                                f"{tag} buffer {i} differs from process_buffer: "
                                f"RMS {rms:.3e}, max {err:.3e}")
                    rate, rate_counts = _engine_launches(
                        lambda: bench.engine_rate(cfg, dev, src, wire, chunk, seconds=3.0),
                        rung, lambda r: (r["buffers"] - chunk) // chunk if chunk > 1
                        else r["buffers"] - 1, f"{tag} rate")
                    rates[(rung, wire, chunk)] = rate
                    for k in CONCAT:
                        launches[k] += counts[k] + rate_counts[k]
                    log(f"[stream] {rung} rung, {wire} wire, {mode}: recorded float32 "
                        f"stream == process_buffer within the scale bounds; engine "
                        f"launches {counts} (recorded run), {rate_counts} (rate run), "
                        f"two-operator steady-state kernels 0")
            for chunk in (1, 4):
                if not np.array_equal(recorded[("uint16", chunk)], recorded[("packed12", chunk)]):
                    raise AssertionError(f"{rung}: packed-12 wire output != uint16 wire output")
            log(f"[stream] {rung} rung: packed-12 wire output == uint16 wire output (exact)")
            family, err = _check_steady_full_size(ref_model, steady[1], torch.from_numpy(
                host[0]).to(dev))
            worst[family] = max(worst[family], err)
            del ref_model, steady, recorded
    log(f"[main] stream path launches {launches}, summed over the engine runs "
        f"({time.perf_counter() - t0:.1f} s)")
    lines = acq.ascans_per_buffer
    for rung in ("default", "high"):
        ms = bench.steady_ms_per_buffer(bench.bench_config(fold_concat=True,
                                                           matmul_precision=rung), dev)
        for (r, wire, chunk), rate in rates.items():
            if r == rung:
                spread = rate["window_mhz"]
                log(f"[stream] {rung} rung, {wire} wire, chunk {chunk}: engine "
                    f"{rate['mhz']:.3f} MHz A-scans with the upload and the quantized "
                    f"fetch ({rate['timed_buffers']} buffers in {rate['timed_s']:.3f} s after "
                    f"warm-up, {rate['wire_mb_per_s']:.0f} MB/s wire; 1 s windows "
                    f"{min(spread, default=0):.3f}-{max(spread, default=0):.3f} MHz); steady "
                    f"process_buffer {lines / ms / 1e3:.3f} MHz ({ms:.3f} ms/buffer) ({card})")
    return launches


#: Launches of the bf16 main path (phase_bf16_path): per path buffer 0
#: (FPN determination; the fold paths' planar kernel), then on the fold
#: paths three steady buffers, a batch chunk of four (one launch) and one
#: more buffer, on the FFT paths four steady buffers and a scan chunk of
#: four (a launch per buffer).
BF16_MAIN_LAUNCHES = {"depth": 2, "depth_scale": 5, "depth_scale_concat": 5,
                      "prep_phase": 9, "prep_real": 9}


def phase_bf16_path(worst):
    """``default_full_config()`` at ``compute_dtype="bfloat16"`` on full
    1024 x 512 x 256 buffers through ``FdOctModel``: the fold path, the
    concat path and the FFT path with dispersion (phase kernel) and without
    (real kernel), between one reset and one read of the launch counts.
    Every launch of the five families must be on the bf16 route, none on
    the three-part one-pass route, the float32-FMA kernel or a split rung,
    as many as the runs dispatch (``BF16_MAIN_LAUNCHES``).  Then each
    steady output and buffer 0's planar GEMM at full size: the scaled ones
    against the float64 product of the rounded operands, the others
    against their plain versions."""
    import torch

    from octproz_tpu_torch import bench
    from octproz_tpu_torch.kernels import fused_prep as fp
    from octproz_tpu_torch.models.fdoct import FdOctModel

    dev = torch.device("cuda", 0)
    acq = bench.FULL_ACQ
    host_raw = np.random.default_rng(50).integers(0, 4096, size=acq.buffer_shape,
                                                  dtype=np.uint16)
    bufs = bench.random_buffers(acq, 4, dev, seed=51)
    bf16 = dict(compute_dtype="bfloat16")
    models = {"fold": FdOctModel(acq, bench.bench_config(**bf16), **bench.CURVE_KW, device=dev),
              "concat": FdOctModel(acq, bench.bench_config(fold_concat=True, **bf16),
                                   **bench.CURVE_KW, device=dev),
              "FFT, dispersion": FdOctModel(acq, bench.fft_config(**bf16), **bench.CURVE_KW,
                                            device=dev),
              "FFT, no dispersion": FdOctModel(acq, bench.fft_config(dispersion=False, **bf16),
                                               **bench.CURVE_KW, device=dev)}
    torch.cuda.synchronize()

    fp.reset_launch_counts()
    t0 = time.perf_counter()
    steady = {}
    for name, model in models.items():
        if model.cfg.fft_via_matmul:
            steady[name] = _run_main_path(model, host_raw, bufs, f"bf16 {name} path")
        else:
            _run_fft_path(model, host_raw, bufs, f"bf16 {name}")
    launches = _read_launches(tuple(BF16_ROWS), t0, "bf16 path")
    others = {k: v for k, v in fp.LAUNCHES.items() if v and k not in BF16_ROWS}
    if launches != BF16_MAIN_LAUNCHES or others:
        raise AssertionError(f"bf16 path launched {launches} and {others}; want "
                             f"{BF16_MAIN_LAUNCHES} and nothing else")
    _check_routes(launches, "bf16 path", route="tensor_core_bf16")

    for name, (out, raw) in steady.items():
        family, err = _check_steady_full_size(models[name], out, raw)
        worst[family] = max(worst[family], err)
    del steady
    cv = models["fold"].curves
    raw0 = torch.from_numpy(host_raw).to(dev).reshape(-1, acq.samples_per_line)
    err, detail, ok = _compare(raw0, *cv.depth_parts, True, None, None, None)
    worst["depth_bf16"] = max(worst["depth_bf16"], err)
    log(f"[bf16] depth full buffer 0 (bf16) vs plain version: {detail} "
        f"-> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("full-size bf16 depth output disagrees with the plain version")
    raw2d = bufs[0].reshape(-1, acq.samples_per_line)
    for name, epi in (("FFT, dispersion", "phase"), ("FFT, no dispersion", "real")):
        cv = models[name].curves
        rows = (cv.phase.real.contiguous(), cv.phase.imag.contiguous()) \
            if epi == "phase" else None
        err, detail, ok = _compare_prep(raw2d, cv.prep_parts, rows, True)
        worst[f"prep_{epi}_bf16"] = max(worst[f"prep_{epi}_bf16"], err)
        log(f"[bf16] prep_{epi} full buffer (bf16) vs plain version: {detail} "
            f"-> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"full-size bf16 prep_{epi} output disagrees with the "
                                 f"plain version")
    return launches


def phase_fidelity():
    import torch

    from octproz_tpu_torch import bench

    dev = torch.device("cuda", 0)
    paths = {"fold path": ({}, None),
             "FFT path": (dict(fft_via_matmul=False, use_pallas_prep=True), bench.fft_config())}
    # the concat path's golden pair: the buffer again once its FPN is
    # determined, so the steady-state concat kernel makes the output
    goldens = [(path, changes) for path, (changes, _) in paths.items()]
    goldens.append(("concat fold path, steady", dict(fold_concat=True, steady=True)))
    for path, changes in goldens:
        for rung in ("default", "high"):
            res = bench.golden_pair(dev, matmul_precision=rung, **changes)
            log(f"[fidelity] {path} golden pair ({rung}): PSNR {res.psnr_db:.2f} dB, "
                f"min B-scan {res.min_bscan_psnr_db:.2f} dB, SSIM {res.mean_ssim:.5f}")
            if not (res.psnr_db >= 60.0 and res.min_bscan_psnr_db >= 55.0
                    and res.mean_ssim >= 0.99):
                raise AssertionError(f"{path} golden pair below its gates: {res}")
        # bf16 compute misses the 60 dB golden gate by design, in the JAX
        # package too (docs/performance.md): recorded, not gated
        res = bench.golden_pair(dev, compute_dtype="bfloat16", **changes)
        log(f"[fidelity] {path} golden pair (bfloat16, not gated): PSNR {res.psnr_db:.2f} dB, "
            f"min B-scan {res.min_bscan_psnr_db:.2f} dB, SSIM {res.mean_ssim:.5f}")
    # the concat path at bf16: with FPN off its kernel (B5) makes buffer 0
    concat = bench.bench_config(fold_concat=True)
    psnr = bench.oracle_psnr(("default", "bfloat16"), dev, concat)
    log(f"[fidelity] concat fold path oracle PSNR (FPN off, 1024x512x8): "
        + ", ".join(f"{k} {v:.2f} dB" for k, v in psnr.items()))
    _check_bf16_rung("concat fold path", psnr)
    for path, (changes, cfg) in paths.items():
        psnr = bench.oracle_psnr(tuple(bench.ORACLE_GATE_DB), dev, cfg)
        log(f"[fidelity] {path} oracle PSNR (FPN off, 1024x512x8): "
            + ", ".join(f"{k} {v:.2f} dB" for k, v in psnr.items()))
        for rung, gate in bench.ORACLE_GATE_DB.items():
            if psnr[rung] < gate:
                raise AssertionError(f"{path} oracle PSNR {rung} {psnr[rung]:.2f} < {gate}")
        _check_bf16_rung(path, psnr)
        if psnr["high"] < bench.IN_BOUND_SNR_DB:
            raise AssertionError(f"{path}: high rung below the {bench.IN_BOUND_SNR_DB} dB "
                                 f"SNR bound")
        if psnr["highest"] < psnr["high"] + RUNG_GAP_DB:
            raise AssertionError(f"{path}: highest rung not {RUNG_GAP_DB} dB above high: "
                                 f"{psnr}")
    for epi in ("phase", "real"):
        snr = _prep_snr_db(dev, epi)
        log(f"[fidelity] FFT path prep output SNR vs float64, {epi} kernels (1024x512x8, "
            f"before the FFT): " + ", ".join(f"{k} {v:.2f} dB" for k, v in snr.items()))
        if min(snr["default"], snr["highest"]) < snr["high"] + RUNG_GAP_DB:
            raise AssertionError(f"prep output of the {epi} kernels: default/highest not "
                                 f"{RUNG_GAP_DB} dB above high: {snr}")


def _check_bf16_rung(path, psnr):
    """The bf16 rung clears its gate and sits at least BF16_GAP_DB below the
    default rung: a bf16 run that took a float32-grade route would not."""
    from octproz_tpu_torch import bench

    if psnr["bfloat16"] < bench.ORACLE_GATE_DB["bfloat16"] \
            or psnr["bfloat16"] > psnr["default"] - BF16_GAP_DB:
        raise AssertionError(f"{path}: bf16 oracle PSNR {psnr['bfloat16']:.2f} dB not in "
                             f"[{bench.ORACLE_GATE_DB['bfloat16']}, default "
                             f"{psnr['default']:.2f} - {BF16_GAP_DB}]")


def _prep_snr_db(dev, epi):
    """Each rung's prep spectra (the phase or the real kernels) on the
    oracle's input, against a float64 product of the same float32 operator
    (and phasor): 10 log10(||ref||^2 / ||got - ref||^2).  On the FFT path
    the float32 FFT caps the end-to-end oracle PSNR near the default rung's
    (about 135 dB on an H100), so "highest" reads barely above "default"
    there; before the FFT the rungs keep their own error budgets (~2^-24
    against ~2^-16 for "high")."""
    import torch

    from octproz_tpu_torch import bench
    from octproz_tpu_torch import curves as curves_mod
    from octproz_tpu_torch.kernels import fused_prep as fp
    from octproz_tpu_torch.ops.convert import decode

    acq = dataclasses.replace(bench.FULL_ACQ, bscans_per_buffer=8)
    cfg = bench.fft_config()
    cv = curves_mod.make_curves(acq, cfg, **bench.CURVE_KW, device=dev)
    raw = np.random.default_rng(7).integers(0, 4096, size=acq.buffer_shape).astype(np.uint16)
    raw2d = torch.from_numpy(raw).to(dev).reshape(-1, acq.samples_per_line)
    x = decode(raw2d, acq.bit_depth, cfg.bitshift).double()
    ref = x @ cv.prep_operator.double()
    rows = (cv.phase.real.contiguous(), cv.phase.imag.contiguous())
    if epi == "phase":
        ref = ref * cv.phase.to(torch.complex128)
    out = {}
    for rung in ("default", "high", "highest"):
        parts = fp._operator_parts(cv.prep_operator, rung)
        got = (fp.prep_phase(raw2d, parts, *rows, bitshift=cfg.bitshift) if epi == "phase"
               else fp.prep_real(raw2d, parts, bitshift=cfg.bitshift)).to(torch.complex128)
        err = float((got - ref).abs().square().sum())
        out[rung] = 10.0 * np.log10(float(ref.abs().square().sum()) / max(err, 1e-300))
    return out


#: Trace event categories (torch.profiler's Chrome trace): what the device
#: ran, and what the host did around it.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation", "python_function")


def _merge(spans):
    """The union of (start, end) spans, sorted and merged."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def trace_summary(events, top=6, gaps=5):
    """From a trace's events (microseconds): the traced window (first to
    last device event), the device's busy time (the union of its kernel,
    copy and memset intervals over every stream), its idle share of the
    window, the device operations by total time, and the longest idle gaps,
    each with the device operations on either side of it and the host
    operations (name, thread) that overlap it most."""
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    if not dev:
        raise AssertionError("the trace holds no CUDA kernel or copy on the card")
    busy = _merge((e["ts"], e["ts"] + e["dur"]) for e in dev)
    t0, t1 = busy[0][0], busy[-1][1]
    busy_us = sum(e - s for s, e in busy)
    totals = {}
    for e in dev:
        name = e["name"]
        n, t = totals.get(name, (0, 0.0))
        totals[name] = (n + 1, t + e["dur"])
    host = [e for e in events if e.get("cat") in HOST_CATS and "dur" in e]
    holes = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:])), reverse=True)
    ends = sorted(dev, key=lambda e: e["ts"] + e["dur"])
    starts = sorted(dev, key=lambda e: e["ts"])
    longest = []
    for dur, s, e in holes[:gaps]:
        before = max((d for d in ends if d["ts"] + d["dur"] <= s), key=lambda d: d["ts"] + d["dur"])
        after = min((d for d in starts if d["ts"] >= e), key=lambda d: d["ts"])
        over = {}
        for h in host:
            o = min(e, h["ts"] + h["dur"]) - max(s, h["ts"])
            if o > 0:
                key = (h["name"], h.get("tid"))
                over[key] = over.get(key, 0.0) + o
        longest.append({"at_ms": (s - t0) / 1e3, "ms": dur / 1e3,
                        "before": before["name"], "after": after["name"],
                        "host": [(name, tid, round(o / 1e3, 3)) for (name, tid), o in
                                 sorted(over.items(), key=lambda kv: -kv[1])[:4]]})
    return {"window_ms": (t1 - t0) / 1e3, "busy_ms": busy_us / 1e3,
            "idle_share": 1.0 - busy_us / (t1 - t0), "device_events": len(dev),
            "top": sorted(((name, n, t / 1e3) for name, (n, t) in totals.items()),
                          key=lambda r: -r[2])[:top],
            "gaps": longest}


def phase_trace(info):
    """A ``utils.profiling.trace`` of ``StreamingEngine.run`` on each wire
    (uint16, then packed-12): the concat path at the default rung, buffers
    replayed from RAM, quantized and fetched, after a warm-up run of the
    same model on that wire (FPN determined, kernels built, memory pools
    filled).  Each traced run stops about 3 s after its first buffer
    arrives.  Returns the summaries by wire."""
    import tempfile

    import torch

    from octproz_tpu_torch import bench
    from octproz_tpu_torch.models.fdoct import FdOctModel
    from octproz_tpu_torch.runtime import StreamingEngine
    from octproz_tpu_torch.utils import profiling

    dev = torch.device("cuda", 0)
    card = f"{info['device_name']}, power limit {info['power_limit']}"
    lines = bench.FULL_ACQ.ascans_per_buffer
    summaries = {}
    with tempfile.TemporaryDirectory() as tmp:
        sources = bench.stream_sources(tmp)
        model = FdOctModel(bench.FULL_ACQ, bench.bench_config(fold_concat=True),
                           **bench.CURVE_KW, device=dev)
        for wire in ("uint16", "packed12"):
            kw = dict(wire_format=wire, stream_to_host=True)
            StreamingEngine(model, sources[wire], **kw).run(max_buffers=8)
            torch.cuda.synchronize()
            arrived = []

            def on_processed(_host, _buffer_nr, arrived=arrived):
                arrived.append(time.perf_counter())
                if arrived[-1] - arrived[0] >= 3.0:
                    eng.stop()

            eng = StreamingEngine(model, sources[wire], on_processed=on_processed, **kw)
            with profiling.trace(os.path.join(tmp, "trace")) as path:
                n = eng.run(max_buffers=1000)
                torch.cuda.synchronize()
            with open(path) as f:
                events = json.load(f)["traceEvents"]
            size_mb = os.path.getsize(path) / 1e6
            os.remove(path)
            s = summaries[wire] = trace_summary(events)
            del events
            log(f"[trace] engine run ({wire} wire): {n} buffers, traced window "
                f"{s['window_ms']:.3f} ms ({size_mb:.1f} MB of trace), {s['device_events']} "
                f"device events, device busy {s['busy_ms']:.3f} ms -> idle share "
                f"{100 * s['idle_share']:.2f} % ({n * lines / s['window_ms'] / 1e3:.3f} MHz over "
                f"the window) ({card})")
            for name, count, ms in s["top"]:
                log(f"[trace] {wire} device op {ms:10.3f} ms in {count:5d} calls: {name[:100]}")
            for gap in s["gaps"]:
                log(f"[trace] {wire} idle gap {gap['ms']:.3f} ms at {gap['at_ms']:.3f} ms, after "
                    f"{gap['before'][:50]}, before {gap['after'][:50]}; host ops over it: "
                    + "; ".join(f"{name[:60]} (thread {tid}) {o} ms"
                                for name, tid, o in gap["host"]))
    return summaries


def phase_times(info):
    import torch

    from octproz_tpu_torch import bench

    dev = torch.device("cuda", 0)
    lines = bench.FULL_ACQ.ascans_per_buffer
    card = f"{info['device_name']}, power limit {info['power_limit']}"
    for rung in bench.TIMED_RUNGS:
        ms = bench.steady_ms_per_buffer(bench.at_rung(bench.bench_config(), rung), dev)
        log(f"[times] fold path steady state ({rung}): {ms:.3f} ms/buffer, "
            f"{lines / ms / 1e3:.3f} MHz ({card})")
    for rung in ("default", "bfloat16"):
        ms = bench.steady_ms_per_buffer(bench.at_rung(bench.bench_config(fold_concat=True),
                                                      rung), dev)
        log(f"[times] concat fold path steady state ({rung}): {ms:.3f} ms/buffer, "
            f"{lines / ms / 1e3:.3f} MHz ({card})")
    for rung in bench.TIMED_RUNGS:
        cfg = bench.at_rung(bench.fft_config(), rung)
        ms = bench.steady_ms_per_buffer(cfg, dev)
        stages = bench.fft_stage_ms(cfg, dev)
        log(f"[times] FFT path steady state ({rung}): {ms:.3f} ms/buffer, "
            f"{lines / ms / 1e3:.3f} MHz; stages "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in stages.items()) + f" ({card})")
    times = bench.kernel_times(dev, tuple(KERNELS))
    for name, t in times.items():
        log(f"[times] {name:<24} kernel {t['ms']:.3f} ms, plain {t['plain_ms']:.3f} ms, "
            f"library {t['library_ms']:.3f} ms, bound {t['bound_ms']:.3f} ms "
            f"({t['bound_by']}; kernel at {100 * t['bound_ms'] / t['ms']:.1f} % of it) ({card})")
    return times


def main() -> None:
    info = phase_device()
    phase_build()
    worst = phase_kernels()
    launches = {**phase_main_path(worst), **phase_fft_path(worst)}
    launches.update(phase_stream(worst, info))
    launches.update({BF16_ROWS[k]: v for k, v in phase_bf16_path(worst).items()})
    phase_fidelity()
    phase_trace(info)
    times = phase_times(info)
    kernels = [{"name": name, "route": "cuda", "source": CSRC + source,
                "replaces": PALLAS + str(line), "launches": launches[name],
                "max_abs_err": worst[name],
                **{k: times[name][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                               "library_ms")}}
               for name, (source, line) in KERNELS.items()]
    print(info["nvidia_smi"])
    print(json.dumps({"kernels": kernels}))
    import torch

    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
