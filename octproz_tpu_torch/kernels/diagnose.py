"""What limits the tensor-core kernels (B1/B2, B5, B7 and B8 at one pass,
B3/B4, B6, B9/B10) on the card.

    python -m octproz_tpu_torch.kernels.diagnose     (from the root of a checkout, one GPU)

builds the kernel library again for each diagnostic variant of the split
pipeline in ``csrc/fold_split.cuh`` (``-DFOLD_SPLIT_VARIANT=...``, which
``build.py`` never sets) into its own build directory, and prints one JSON
line with the card's name and power limit and:

* ``rel_l2``: the kernels' relative L2 error against their plain versions
  -- the fold planar kernel (bound ``fused_prep.PLANAR_REL_L2``) at one pass
  (against the float32 product) and at the split rungs, on shifted and
  unshifted 12-bit samples, full 16-bit samples, float input and
  n_in = 1664, and the prep real kernel (bound ``fused_prep.PREP_REL_L2``)
  on the same inputs with and without background removal in the operator
  -- for the shipped kernel, ``one_chain`` (the same terms summed across
  n_in in one wgmma chain instead of folded into a float32 sum every
  64-sample stage) and ``no_turns`` (the two warpgroups start their wgmma
  without taking turns: the same sums);
* ``ms``: B1, B2, B5, B7 and B8 (one pass), B3, B4, B6, B9 and B10
  ("high") at the main path's shapes (one 131072-line buffer of shifted
  12-bit samples), B2 on unshifted samples (five terms) and B4 on uint8
  samples of the same shape,
  for the shipped kernel, ``one_chain``, ``no_turns``, and the timing-only
  variants that refill no stage after the ring's first fill
  (``no_loads``), issue no wgmma (``no_mma``), or both -- what is left is
  the consumers' own path: waits, decode, vote, fold and epilogue.

Only ``one_chain`` and ``no_turns`` compute the right terms; the other
variants' output is wrong by design and only their time is read.
"""

from __future__ import annotations

import contextlib
import json

import torch

from .. import bench
from . import build
from . import fused_prep as fp

VARIANTS = {"shipped": 0, "one_chain": 1, "no_turns": 8, "no_loads": 2, "no_mma": 4,
            "no_loads_no_mma": 6}
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
    for name, number in VARIANTS.items():
        with variant(number):
            if name in EXACT:
                record["rel_l2"][name] = errors(dev)
            record["ms"][name] = times(dev)
    print(json.dumps(record))


if __name__ == "__main__":
    main()
