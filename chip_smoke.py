"""Smoke test of the PyTorch/CUDA port (octproz_tpu_torch) on one GPU.

    python3 chip_smoke.py        (from the root of a checkout, one CUDA GPU)

Phases, each printing progress; any failure raises, so the exit code is
nonzero and the final line is not printed:

1. device: the card's name and power limit;
2. build: the CUDA kernels from ``octproz_tpu_torch/kernels/csrc``;
3. kernels: each kernel family (four fold, four prep) against its plain
   PyTorch version on the card, at the main path's widths, an odd line
   count and 1664-sample lines (and 1100 for the prep kernels), then
   controls (a kernel computing a neighbouring rung) that must fail;
4. fold path: ``FdOctModel`` on full 1024 x 512 x 256 buffers of the
   reference benchmark chain on the folded GEMM -- FPN determination,
   steady buffers and a batched chunk -- at the default and the "high"
   rung, then the handheld preset (post stages, batched chunk), with the
   fold kernels' launch counts read around that run; each rung's steady
   output and buffer 0's GEMM against the plain versions at full size;
5. FFT path: the same chain through the prep kernels and cuFFT at both
   rungs (scan chunk against per-buffer steps), its dispersion-free variant
   and the handheld preset, with the prep kernels' launch counts read
   around that run; each rung's full-size prep output against the plain
   versions;
6. fidelity: the golden pair and the float64-oracle ladder on both paths;
7. times: steady-state ms per buffer and MHz on both paths (the FFT path
   split into prep kernel, FFT and FPN plus scaling), and each kernel
   beside its plain version.

The last line is ``{"ok": true, "device": {...}}``; the line before it holds
the kernels' JSON record.  JAX is never imported: the oracle comes from
``tests/oracle.py`` (numpy only).
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
# family -> (source, Pallas kernel body it replaces)
KERNELS = {
    "depth": ("fold_gemm.cu", 261),
    "depth_split": ("fold_gemm.cu", 271),
    "depth_scale": ("fold_gemm.cu", 375),
    "depth_scale_split": ("fold_gemm.cu", 422),
    "prep_phase": ("prep_gemm.cu", 228),
    "prep_phase_split": ("prep_gemm.cu", 245),
    "prep_real": ("prep_gemm.cu", 238),
    "prep_real_split": ("prep_gemm.cu", 254),
}
FOLD = tuple(k for k in KERNELS if k.startswith("depth"))
PREP = tuple(k for k in KERNELS if k.startswith("prep"))

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
    main path: x_lo = 0), "u16" 12 bits unshifted (x_lo != 0), "u8", or
    "f32" (a 24-bit source decoded before the kernel)."""
    import torch

    if kind in ("u16", "u16s"):
        return torch.randint(0, 4096, (lines, n_in), dtype=torch.int16,
                             generator=g, device=dev).view(torch.uint16)
    if kind == "u8":
        return torch.randint(0, 256, (lines, n_in), dtype=torch.uint8,
                             generator=g, device=dev)
    return torch.randint(0, 1 << 24, (lines, n_in), dtype=torch.int32,
                         generator=g, device=dev).to(torch.float32)


def _compare(raw, wre, wim, bitshift, mode, odt, g, ref=None):
    """The kernel on (raw, wre, wim) against the plain version on ``ref``
    (default the same inputs).  Returns (max |err|, detail, within bounds)."""
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
    a, b = fp._scale_affine(mode != "lin", half, 0.0, 60.0, 0.0, 1.0)
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
    """Each family at rungs 1/3/5 -- the split rungs with x_lo terms zero
    (shifted 12-bit samples, as on the main path) and nonzero (unshifted
    12-bit and float inputs) --, fast_log, lin, float32 and bf16 stores,
    uint8/uint16/float inputs, an odd line count and n_in = 1664; then the
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
    ]
    ops = {}
    for n_in in sorted({c[0] for c in cases}):
        acq = AcqParams(samples_per_line=n_in, ascans_per_bscan=8, bscans_per_buffer=1)
        cv = curves_mod.make_curves(acq, bench.bench_config(), **{
            **bench.CURVE_KW, "resample_coeffs": (0.0, n_in - 1.0, 20.0, -10.0)}, device=dev)
        ops[n_in] = (cv.depth_op_re, cv.depth_op_im)

    def parts(n_in, precision):
        return tuple(fp._operator_parts(w, precision) for w in ops[n_in])

    g = torch.Generator(device=dev)
    g.manual_seed(3)
    for n_in, lines, kind, passes, mode, odt in cases:
        precision = {1: "default", 3: "high", 5: "highest"}[passes]
        raw = _raw(kind, lines, n_in, g, dev)
        err, detail, ok = _compare(raw, *parts(n_in, precision), kind == "u16s",
                                   mode, odt, g)
        torch.cuda.synchronize()
        family = ("depth" if mode is None else "depth_scale") + ("_split" if passes > 1 else "")
        if n_in == 1024 and kind == "u16s" and odt in (None, f32):
            worst[family] = max(worst[family], err)  # the main path's inputs
        log(f"[kernels] {family:<17} n_in={n_in} lines={lines} {kind} passes={passes} "
            f"{mode or 'planar'} {str(odt).replace('torch.', '') if odt else ''}: "
            f"{detail} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{family} kernel disagrees with its plain version")

    # Controls: a kernel that computed a neighbouring rung must fail.
    raw = _raw("u16", 4096, 1024, g, dev)
    p5, p3 = parts(1024, "highest"), parts(1024, "high")
    x_hi = fp._bf16_trunc(raw.to(torch.float32))
    controls = [
        ("3-pass kernel on the highest parts", (raw, p5[0][:2], p5[1][:2]), (raw, *p5)),
        ("3-pass kernel without x_lo (x_hi input)", (x_hi, *p3), (raw, *p3)),
    ]
    for name, kernel_in, plain_in in controls:
        for mode in (None, "log"):
            _, detail, ok = _compare(*kernel_in, False, mode, f32, g, ref=plain_in)
            torch.cuda.synchronize()
            log(f"[kernels] control: {name}, {mode or 'planar'}: {detail} -> "
                f"{'passes (BAD)' if ok else 'fails, as it must'}")
            if ok:
                raise AssertionError(f"control {name!r} passed: the bounds do "
                                     f"not separate the rungs")
    _prep_kernel_cases(worst, g, dev)
    return worst


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
    n_in = 1664 -- plus n_in = 1100 (ragged in n_in and n_out) and the
    operator with background removal folded in (denser, so more
    reordering); then the controls, which must fail."""
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
    ]
    ops = {(n, bg): _prep_operators(n, bg, dev) for n, bg in {(c[0], c[5]) for c in cases}}
    for n_in, lines, kind, passes, epi, bg in cases:
        precision = {1: "default", 3: "high", 5: "highest"}[passes]
        op, rows = ops[(n_in, bg)]
        raw = _raw(kind, lines, n_in, g, dev)
        err, detail, ok = _compare_prep(raw, fp._operator_parts(op, precision),
                                        rows if epi == "phase" else None, kind == "u16s")
        torch.cuda.synchronize()
        family = f"prep_{epi}" + ("_split" if passes > 1 else "")
        if n_in == 1024 and kind == "u16s" and not bg:
            worst[family] = max(worst[family], err)  # the main path's inputs
        log(f"[kernels] {family:<17} n_in={n_in} lines={lines} {kind} passes={passes}"
            f"{' bg' if bg else ''}: {detail} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{family} kernel disagrees with its plain version")

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
    """The main path's first steady buffer against the plain version of its
    kernel on the same full-size input (no kernel launch)."""
    from octproz_tpu_torch.kernels import fused_prep as fp

    acq, cfg = model.acq, model.cfg
    a, b = fp._scale_affine(cfg.log_scaling, acq.output_ascan_length, cfg.grayscale_min,
                            cfg.grayscale_max, cfg.addend, cfg.multiplicator)
    ref = fp.depth_scale_plain(raw.reshape(-1, acq.samples_per_line),
                               *model.curves.depth_parts, model.fpn_state.mean_line,
                               bitshift=cfg.bitshift, log_scaling=cfg.log_scaling,
                               a=a, b=b)
    rms, worst, ok = fp.scale_error(out.reshape(ref.shape), ref)
    family = "depth_scale" if cfg.matmul_precision == "default" else "depth_scale_split"
    log(f"[main] {family} full buffer ({cfg.matmul_precision}) vs plain version: "
        f"above the display floor RMS {rms:.3e}, max {worst:.3e} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"full-size {family} output disagrees with the plain version")
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
    both rungs, its dispersion-free variant (real kernels) and the handheld
    preset, with the prep kernels' launch counts read around the run; then
    each rung's full-size prep output against the plain versions."""
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
    for rung in ("default", "high"):
        for epi, model in models.items():
            if rung != "default":
                model.set_config(matmul_precision=rung)
                model.redetermine_fpn()
            _run_fft_path(model, host_raw, bufs,
                          f"{rung} rung, {'dispersion' if epi == 'phase' else 'no dispersion'}")
    _run_handheld(handheld, bufs, "FFT path, handheld preset", batch=False)
    launches = _read_launches(PREP, t0, "FFT path")
    del handheld

    # Full-size prep output of each rung against the plain version, after
    # the counts were read.
    raw2d = bufs[0].reshape(-1, acq.samples_per_line)
    for rung in ("default", "high"):
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


def phase_fidelity():
    import torch

    from octproz_tpu_torch import bench

    dev = torch.device("cuda", 0)
    paths = {"fold path": ({}, None),
             "FFT path": (dict(fft_via_matmul=False, use_pallas_prep=True), bench.fft_config())}
    for path, (changes, cfg) in paths.items():
        for rung in ("default", "high"):
            res = bench.golden_pair(dev, matmul_precision=rung, **changes)
            log(f"[fidelity] {path} golden pair ({rung}): PSNR {res.psnr_db:.2f} dB, "
                f"min B-scan {res.min_bscan_psnr_db:.2f} dB, SSIM {res.mean_ssim:.5f}")
            if not (res.psnr_db >= 60.0 and res.min_bscan_psnr_db >= 55.0
                    and res.mean_ssim >= 0.99):
                raise AssertionError(f"{path} golden pair below its gates: {res}")
        psnr = bench.oracle_psnr(("default", "high", "highest"), dev, cfg)
        log(f"[fidelity] {path} oracle PSNR (FPN off, 1024x512x8): "
            + ", ".join(f"{k} {v:.2f} dB" for k, v in psnr.items()))
        for rung, gate in bench.ORACLE_GATE_DB.items():
            if psnr[rung] < gate:
                raise AssertionError(f"{path} oracle PSNR {rung} {psnr[rung]:.2f} < {gate}")
        if psnr["high"] < bench.IN_BOUND_SNR_DB:
            raise AssertionError(f"{path}: high rung below the {bench.IN_BOUND_SNR_DB} dB "
                                 f"SNR bound")
        if psnr["highest"] < psnr["high"] + RUNG_GAP_DB:
            raise AssertionError(f"{path}: highest rung not {RUNG_GAP_DB} dB above high: "
                                 f"{psnr}")
    snr = _prep_snr_db(dev)
    log("[fidelity] FFT path prep output SNR vs float64 (1024x512x8, before the FFT): "
        + ", ".join(f"{k} {v:.2f} dB" for k, v in snr.items()))
    if min(snr["default"], snr["highest"]) < snr["high"] + RUNG_GAP_DB:
        raise AssertionError(f"prep output: default/highest not {RUNG_GAP_DB} dB above "
                             f"high: {snr}")


def _prep_snr_db(dev):
    """Each rung's prep spectra (the phase kernels) on the oracle's input,
    against a float64 product of the same float32 operator and phasor:
    10 log10(||ref||^2 / ||got - ref||^2).  On the FFT path the float32 FFT
    caps the end-to-end oracle PSNR near the default rung's (about 135 dB
    on an H100), so "highest" reads barely above "default" there; before
    the FFT the rungs keep their own error budgets (~2^-24 against ~2^-16
    for "high")."""
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
    ref = (x @ cv.prep_operator.double()) * cv.phase.to(torch.complex128)
    rows = (cv.phase.real.contiguous(), cv.phase.imag.contiguous())
    out = {}
    for rung in ("default", "high", "highest"):
        got = fp.prep_phase(raw2d, fp._operator_parts(cv.prep_operator, rung), *rows,
                            bitshift=cfg.bitshift).to(torch.complex128)
        err = float((got - ref).abs().square().sum())
        out[rung] = 10.0 * np.log10(float(ref.abs().square().sum()) / max(err, 1e-300))
    return out


def phase_times(info):
    import torch

    from octproz_tpu_torch import bench

    dev = torch.device("cuda", 0)
    lines = bench.FULL_ACQ.ascans_per_buffer
    card = f"{info['device_name']}, power limit {info['power_limit']}"
    for rung in bench.TIMED_RUNGS:
        ms = bench.steady_ms_per_buffer(bench.bench_config(matmul_precision=rung), dev)
        log(f"[times] fold path steady state ({rung}): {ms:.3f} ms/buffer, "
            f"{lines / ms / 1e3:.3f} MHz ({card})")
    for rung in bench.TIMED_RUNGS:
        cfg = bench.fft_config(matmul_precision=rung)
        ms = bench.steady_ms_per_buffer(cfg, dev)
        stages = bench.fft_stage_ms(cfg, dev)
        log(f"[times] FFT path steady state ({rung}): {ms:.3f} ms/buffer, "
            f"{lines / ms / 1e3:.3f} MHz; stages "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in stages.items()) + f" ({card})")
    times = bench.kernel_times(dev, tuple(KERNELS))
    for name, t in times.items():
        log(f"[times] {name:<17} kernel {t['ms']:.3f} ms, plain {t['plain_ms']:.3f} ms ({card})")
    return times


def main() -> None:
    info = phase_device()
    phase_build()
    worst = phase_kernels()
    launches = {**phase_main_path(worst), **phase_fft_path(worst)}
    phase_fidelity()
    times = phase_times(info)
    kernels = [{"name": name, "route": "cuda", "source": CSRC + source,
                "replaces": PALLAS + str(line), "launches": launches[name],
                "max_abs_err": worst[name], "ms": times[name]["ms"],
                "plain_ms": times[name]["plain_ms"]}
               for name, (source, line) in KERNELS.items()]
    print(info["nvidia_smi"])
    print(json.dumps({"kernels": kernels}))
    import torch

    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
