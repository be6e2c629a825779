"""What limits the tensor-core kernels (B1/B2, B5, B7 and B8 at one pass
and at ``compute_dtype="bfloat16"``, B3/B4, B6, B9/B10) on the card.

    python -m octproz_tpu_torch.kernels.diagnose [VARIANT ...]
                                          (from the root of a checkout, one GPU)

builds the kernel library again for each diagnostic variant (all of
``VARIANTS``, or those named) of the split pipeline in
``csrc/fold_split.cuh`` and of the persistent one-term kernel in
``csrc/fold_bf16.cuh`` (B2, B5, B7 and B8 at bf16), which reads the same
flags (``-DFOLD_SPLIT_VARIANT=...``, which ``build.py`` never sets), into
its own build directory, and prints one JSON line with the card's name and
power limit and:

* ``rel_l2``: the kernels' relative L2 error against their plain versions
  -- the fold planar kernel (bound ``fused_prep.PLANAR_REL_L2``) at one pass
  (against the float32 product) and at the split rungs, on shifted and
  unshifted 12-bit samples, full 16-bit samples, float input and
  n_in = 1664, and the prep real kernel (bound ``fused_prep.PREP_REL_L2``)
  on the same inputs with and without background removal in the operator
  -- for the shipped kernel, ``one_chain`` (the same terms summed across
  n_in in one wgmma chain instead of folded into a float32 sum every
  64-sample stage) and ``no_turns`` (the two warpgroups start their wgmma
  without taking turns: the same sums; the one-term kernel has no turns);
* ``scale``: B2 and B5 at bf16 (the one-term kernel) against their plain
  versions on shifted and unshifted 12-bit, full 16-bit and 24-bit float
  samples: ``fused_prep.scale_error`` with log scaling over the 60 dB from
  the samples' display floor (RMS, max, within the bounds), and the
  relative L2 error of the magnitude sqrt(re^2 + im^2) (linear scaling, no
  FPN mean) beside ``PLANAR_REL_L2`` -- for the shipped kernel, which sums
  all of n_in in one wgmma chain (``one_chain`` and ``no_turns`` do not
  change it);
* ``ms``: B1, B2, B5, B7 and B8 (one pass), B3, B4, B6, B9 and B10
  ("high") at the main path's shapes (one 131072-line buffer of shifted
  12-bit samples), B2 on unshifted samples (five terms), B4 on uint8
  samples of the same shape, and B2 at bf16 with linear and fast-log
  scaling (what the log10 epilogue costs),
  for the shipped kernel, ``one_chain``, ``no_turns``, and the timing-only
  variants that refill no stage after the ring's first fill
  (``no_loads``), issue no wgmma (``no_mma``), or both -- what is left is
  the consumers' own path: waits, decode, vote, fold and epilogue -- and,
  for the one-term kernel alone, ``wgmma_only``: no refills, no decode
  and no epilogue arithmetic, its wgmma groups and barriers (the other
  kernels read it as ``no_loads``), and ``no_stores``: every value of the
  epilogue computed, none stored (what the stores cost B7 at bf16, whose
  complex64 spectra set its bound; the other kernels ignore it);
* ``prep_bf16``: B7 and B8 at bf16 (the one-term kernel) on shifted and
  unshifted 12-bit, full 16-bit, uint8 and 24-bit float samples, with and
  without background removal in the operator: the relative L2 error of the
  kernel and of its plain version (a float32 cuBLAS product) against the
  float64 product of the same rounded operands, beside
  ``PREP_REL_L2`` -- for the shipped kernel; and B8 on a dense random
  operator at n_in = 4352, where one wgmma chain's sums cancel most.

Only ``one_chain`` and ``no_turns`` compute the right terms; the other
variants' output is wrong by design and only their time is read.
"""

from __future__ import annotations

import contextlib
import json
import sys

import torch

from .. import bench
from . import build
from . import fused_prep as fp

VARIANTS = {"shipped": 0, "one_chain": 1, "no_turns": 8, "no_loads": 2, "no_mma": 4,
            "no_loads_no_mma": 6, "wgmma_only": 50, "no_stores": 64}
#: the variants whose output is right: their errors are read too
EXACT = ("shipped", "one_chain", "no_turns")
#: (name, n_in, lines, samples, passes) of the fold agreement cases
ERROR_CASES = (("u16 shifted", 1024, 4096, "u16s", 1), ("u16", 1024, 4096, "u16", 1),
               ("u16 full", 1024, 4133, "u16f", 1), ("u16 n_in=1664", 1664, 1000, "u16", 1),
               ("u16 shifted", 1024, 4096, "u16s", 3), ("u16", 1024, 4096, "u16", 3),
               ("u16", 1024, 4096, "u16", 5), ("u16 n_in=1664", 1664, 1000, "u16", 5),
               ("float", 1024, 2048, "f32", 5))
_RUNG = {1: "default", 3: "high", 5: "highest"}
#: (name, n_in, lines, samples, passes, background removal) of the prep cases
#: (name, samples, display floor dB) of the one-term kernel's agreement cases
SCALE_ERROR_CASES = (("u16 shifted", "u16s", 0.0), ("u16", "u16", 24.0),
                     ("u16 full", "u16f", 48.0), ("float", "f32", 96.0))
PREP_ERROR_CASES = (("u16 shifted", 1024, 4096, "u16s", 3, False),
                    ("u16", 1024, 4096, "u16", 3, False),
                    ("u16", 1024, 4096, "u16", 5, False),
                    ("float", 1024, 2048, "f32", 5, False),
                    ("u16 shifted, background", 1024, 4096, "u16s", 3, True),
                    ("u16, background", 1024, 4096, "u16", 3, True),
                    ("u16, background", 1024, 4096, "u16", 5, True),
                    ("u16 n_in=1664, background", 1664, 1000, "u16", 5, True))


@contextlib.contextmanager
def variant(number: int):
    """The kernel library built with FOLD_SPLIT_VARIANT=number while inside."""
    flags = build.NVCC_FLAGS
    build.NVCC_FLAGS = flags + ((f"-DFOLD_SPLIT_VARIANT={number}",) if number else ())
    build.load.cache_clear()
    try:
        build.load()
        yield
    finally:
        build.NVCC_FLAGS = flags
        build.load.cache_clear()


def _raw(kind: str, lines: int, n_in: int, g, dev):
    if kind == "f32":
        return torch.randint(0, 1 << 24, (lines, n_in), generator=g, device=dev).float()
    if kind == "u16f":
        return torch.randint(-32768, 32768, (lines, n_in), dtype=torch.int16, generator=g,
                             device=dev).view(torch.uint16)
    return torch.randint(0, 4096, (lines, n_in), dtype=torch.int16, generator=g,
                         device=dev).view(torch.uint16)


def _curves(n_in: int, cfg, dev):
    from .. import curves as curves_mod
    from ..params import AcqParams

    acq = AcqParams(samples_per_line=n_in, ascans_per_bscan=8, bscans_per_buffer=1)
    return curves_mod.make_curves(acq, cfg, **{
        **bench.CURVE_KW, "resample_coeffs": (0.0, n_in - 1.0, 20.0, -10.0)}, device=dev)


def errors(dev) -> dict:
    out = {}
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    for name, n_in, lines, kind, passes in ERROR_CASES:
        cv = _curves(n_in, bench.bench_config(), dev)
        parts = [fp._operator_parts(w, _RUNG[passes]) for w in (cv.depth_op_re, cv.depth_op_im)]
        raw = _raw(kind, lines, n_in, g, dev)
        shift = kind == "u16s"
        got = fp.fold_depth(raw, *parts, bitshift=shift)
        family = "depth" if passes == 1 else "depth_split"
        out[f"{family} {name}, {passes} passes"] = fp.planar_error(
            got, fp.depth_plain(raw, *parts, bitshift=shift))
    for name, n_in, lines, kind, passes, bg in PREP_ERROR_CASES:
        cv = _curves(n_in, bench.fft_config(background_removal=bg), dev)
        parts = fp._operator_parts(cv.prep_operator, _RUNG[passes])
        raw = _raw(kind, lines, n_in, g, dev)
        shift = kind == "u16s"
        out[f"prep_real_split {name}, {passes} passes"] = fp.prep_error(
            fp.prep_real(raw, parts, bitshift=shift),
            fp.prep_real_plain(raw, parts, bitshift=shift))
    return out


def scale_errors(dev) -> dict:
    """B2 and B5 at bf16 (the one-term kernel) against their plain versions
    on 4096 lines of 1024 samples -> 512 bins per kind of samples."""
    out = {}
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    cv = _curves(1024, bench.bench_config(compute_dtype="bfloat16"), dev)
    wre, wim = cv.depth_parts
    wide = fp.concat_operator(cv.depth_op_re, cv.depth_op_im, fp.BF16)
    zero = torch.zeros((2, 512), device=dev)
    for name, kind, floor in SCALE_ERROR_CASES:
        raw = _raw(kind, 4096, 1024, g, dev)
        shift = kind == "u16s"
        mean2 = torch.randn((2, 512), generator=g, device=dev) * 50.0
        a, b = fp._scale_affine(True, 512, floor, floor + 60.0, 0.0, 1.0)
        kw = dict(bitshift=shift, log_scaling=True, a=a, b=b)
        lin = dict(bitshift=shift, log_scaling=False, a=1.0, b=0.0)
        for family, kernel, plain, ops in (
                ("depth_scale_bf16", fp.fold_depth_scale, fp.depth_scale_plain, (wre, wim)),
                ("depth_scale_concat_bf16", fp.fold_depth_scale_concat,
                 fp.depth_scale_concat_plain, (wide,))):
            rms, worst, ok = fp.scale_error(kernel(raw, *ops, mean2, **kw),
                                            plain(raw, *ops, mean2, **kw))
            mag = fp.planar_error([kernel(raw, *ops, zero, **lin)], [plain(raw, *ops, zero, **lin)])
            out[f"{family} {name}"] = {"rms": rms, "max": worst, "ok": ok,
                                       "magnitude_rel_l2": mag}
    return out


#: (name, samples, background removal) of the bf16 prep cases
PREP_BF16_CASES = (("u16 shifted", "u16s", False), ("u16", "u16", False),
                   ("u16 full", "u16f", True), ("u8", "u8", False), ("float", "f32", False),
                   ("u16 shifted, background", "u16s", True))


def prep_bf16_errors(dev) -> dict:
    """B7 and B8 at bf16 (the one-term kernel, one wgmma chain over n_in)
    and their plain versions against the float64 product of the rounded
    operands, on 4096 lines of 1024 samples -> 1024 columns."""
    out = {}
    g = torch.Generator(device=dev)
    g.manual_seed(6)
    for name, kind, bg in PREP_BF16_CASES:
        cv = _curves(1024, bench.fft_config(background_removal=bg, compute_dtype="bfloat16"),
                     dev)
        parts = fp._operator_parts(cv.prep_operator, fp.BF16)
        rows = (cv.phase.real.contiguous(), cv.phase.imag.contiguous())
        raw = (torch.randint(0, 256, (4096, 1024), dtype=torch.uint8, generator=g, device=dev)
               if kind == "u8" else _raw(kind, 4096, 1024, g, dev))
        shift = kind == "u16s"
        x = fp._decode_block(raw, shift).to(torch.bfloat16).double()
        y = x @ parts[0].double()
        exact = {"prep_phase_bf16": torch.complex(y * rows[0].double(), y * rows[1].double()),
                 "prep_real_bf16": y}
        for family, kernel, plain in (
                ("prep_phase_bf16", lambda: fp.prep_phase(raw, parts, *rows, bitshift=shift),
                 lambda: fp.prep_phase_plain(raw, parts, *rows, bitshift=shift)),
                ("prep_real_bf16", lambda: fp.prep_real(raw, parts, bitshift=shift),
                 lambda: fp.prep_real_plain(raw, parts, bitshift=shift))):
            out[f"{family} {name}"] = {"kernel": fp.prep_error(kernel(), exact[family]),
                                       "plain": fp.prep_error(plain(), exact[family]),
                                       "bound": fp.PREP_REL_L2}
    # A dense random operator (4352 terms of random sign per sum; no FFT
    # path's operator looks like it): what one wgmma chain over n_in costs
    # where the sum cancels most.
    n = 4352
    parts = (torch.randn((n, n), generator=g, device=dev).div(64.0).to(torch.bfloat16),)
    raw = _raw("u16", 4096, n, g, dev)
    y = fp._decode_block(raw, False).to(torch.bfloat16).double() @ parts[0].double()
    out["prep_real_bf16 u16, dense random operator n_in=4352"] = {
        "kernel": fp.prep_error(fp.prep_real(raw, parts, bitshift=False), y),
        "plain": fp.prep_error(fp.prep_real_plain(raw, parts, bitshift=False), y),
        "bound": fp.PREP_REL_L2}
    return out


def times(dev) -> dict:
    out = {}
    for name in bench.FOLD_KERNELS + bench.PREP_KERNELS:
        kernel = bench._kernel_cases(name, dev)[0]
        out[name] = bench.cuda_ms(kernel, 10, 2)
    cv = _curves(1024, bench.bench_config(), dev)
    mean2 = torch.zeros((2, 512), device=dev)
    kw = dict(bitshift=False, log_scaling=True, a=1.0, b=0.0)
    one = [fp._operator_parts(w, "default") for w in (cv.depth_op_re, cv.depth_op_im)]
    raw16 = bench.random_buffers(bench.FULL_ACQ, 1, dev, seed=5).reshape(-1, 1024)
    out["depth_scale unshifted (five terms)"] = bench.cuda_ms(
        lambda: fp.fold_depth_scale(raw16, *one, mean2, **kw), 10, 2)
    parts = [fp._operator_parts(w, "high") for w in (cv.depth_op_re, cv.depth_op_im)]
    raw8 = torch.randint(0, 256, (bench.FULL_ACQ.ascans_per_buffer, 1024), dtype=torch.uint8,
                         device=dev)
    out["depth_scale_split uint8"] = bench.cuda_ms(
        lambda: fp.fold_depth_scale(raw8, *parts, mean2, **kw), 10, 2)
    raw12 = bench.random_buffers(bench.FULL_ACQ, 1, dev, seed=5).reshape(-1, 1024)
    bf = [fp._operator_parts(w, fp.BF16) for w in (cv.depth_op_re, cv.depth_op_im)]
    for mode, mode_kw in (("lin", dict(log_scaling=False)), ("fast_log", dict(fast_log=True))):
        out[f"depth_scale_bf16 {mode}"] = bench.cuda_ms(
            lambda: fp.fold_depth_scale(raw12, *bf, mean2, **{**kw, "bitshift": True,
                                                               **mode_kw}), 10, 2)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("octproz_tpu_torch.kernels.diagnose: no CUDA device; it measures "
                         "the GPU only")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in true float32
    dev = torch.device("cuda", 0)
    info = bench.device_info()
    record = {"device_name": info["device_name"], "power_limit": info["power_limit"],
              "rel_l2": {}, "ms": {}}
    names = sys.argv[1:] or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known: {list(VARIANTS)}")
    for name in names:
        with variant(VARIANTS[name]):
            if name in EXACT:
                record["rel_l2"][name] = errors(dev)
            if name == "shipped":
                record["scale"] = scale_errors(dev)
                record["prep_bf16"] = prep_bf16_errors(dev)
            record["ms"][name] = times(dev)
    print(json.dumps(record))


if __name__ == "__main__":
    main()
