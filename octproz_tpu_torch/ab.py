"""Two checkouts of the port timed against each other on one GPU.

    python -m octproz_tpu_torch.ab OTHER_ROOT      (from the root of a checkout)

runs four turns -- OTHER_ROOT, this checkout, this checkout, OTHER_ROOT --
each in a fresh process that imports that checkout's ``octproz_tpu_torch``
(and builds its kernels there), times the kernel families of ``KERNELS`` --
the ten float32-grade ones, the bf16 route of the five one-pass families
(``*_bf16``) and their one pass on float32 lines (``*_f32lines``) -- with
its own ``bench.kernel_times``, skipping a name that checkout's ``bench``
does not know, the steady state with ``bench.steady_ms_per_buffer`` at
every rung on the fold path and at the default, "high" and bf16 rungs on
the concat fold path (``fold_concat``), at the default, "high" and bf16
rungs on the FFT path and at the default and bf16 rungs on the FFT path
without dispersion, and the FFT path's stages with ``bench.fft_stage_ms``
at those five settings (a setting that checkout's ``bench`` cannot make is
skipped), and the steady state at the default rung of the fold path, the
concat fold path and the FFT path with and without dispersion on 24-bit
samples in uint32 containers (``bench.WIDE_ACQ`` and
``bench.wide_config``; for a checkout whose ``bench`` has no 24-bit
buffers, the same buffers from the same seed, made and timed in the turn
itself), and the steady state of the fold path with continuous FPN
(``FpnMode.CONTINUOUS``: the FPN mean determined anew on every buffer, so
the planar kernel B1 runs on every one) on 12-bit and on 24-bit samples,
and prints one JSON line: the card's name and power limit, and per turn
the kernel, plain-version and library milliseconds, the steady
milliseconds per buffer of each path (``wide_steady_ms`` at 24 bits,
``continuous_steady_ms`` with continuous FPN) and the FFT path's stage
milliseconds, and ``sass``: the two builds' kernels compared by their SASS
(``cuobjdump -sass``) -- how many both have, which of those differ, and
which only one has -- so a difference in time between kernels whose code
is equal reads as noise.  Both checkouts are timed on one card in one call, so power
limit and neighbours are the same; the spread between a checkout's two
turns is the noise.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

from .bench import device_info

KERNELS = ("depth", "depth_split", "depth_scale", "depth_scale_split", "depth_scale_concat",
           "depth_scale_concat_split", "prep_phase", "prep_phase_split", "prep_real",
           "prep_real_split", "depth_bf16", "depth_scale_bf16", "depth_scale_concat_bf16",
           "prep_phase_bf16", "prep_real_bf16", "depth_f32lines", "depth_scale_f32lines",
           "depth_scale_concat_f32lines", "prep_phase_f32lines", "prep_real_f32lines")

_TURN = """
import dataclasses, itertools, json, math, sys
sys.path.insert(0, {root!r})
import torch
from octproz_tpu_torch import bench
from octproz_tpu_torch.kernels import build
from octproz_tpu_torch.params import FpnMode
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
known = set(bench.FOLD_KERNELS + bench.PREP_KERNELS + getattr(bench, "F32_LINE_KERNELS", ()))
k = bench.kernel_times(dev, [n for n in {names!r} if n in known])
s = {{r: bench.steady_ms_per_buffer(bench.at_rung(bench.bench_config(), r), dev)
     for r in ("default", "high", "highest", "bfloat16")}}
c = {{r: bench.steady_ms_per_buffer(bench.at_rung(bench.bench_config(fold_concat=True), r), dev)
     for r in ("default", "high", "bfloat16")}}
fft = {{r: bench.fft_config(matmul_precision=r) for r in ("default", "high")}}
fft["default, no dispersion"] = bench.fft_config(dispersion=False)
for name, kw in (("bfloat16", {{}}), ("bfloat16, no dispersion", {{"dispersion": False}})):
    try:
        fft[name] = bench.fft_config(compute_dtype="bfloat16", **kw)
    except (TypeError, ValueError):
        pass
f = {{r: bench.steady_ms_per_buffer(cfg, dev) for r, cfg in fft.items()}}
st = {{r: bench.fft_stage_ms(cfg, dev) for r, cfg in fft.items()}}
acq24 = dataclasses.replace(bench.FULL_ACQ, bit_depth=24)
def wide_ms(cfg):
    if hasattr(bench, "WIDE_ACQ"):
        return bench.steady_ms_per_buffer(bench.wide_config(cfg), dev, acq=bench.WIDE_ACQ)
    from octproz_tpu_torch.models.fdoct import FdOctModel
    gain = 20.0 * math.log10(2.0 ** 16)
    cfg = dataclasses.replace(cfg, bitshift=False, grayscale_min=cfg.grayscale_min + gain,
                              grayscale_max=cfg.grayscale_max + gain)
    model = FdOctModel(acq24, cfg, **bench.CURVE_KW, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    bufs = torch.randint(0, 1 << 24, (4, *acq24.buffer_shape), dtype=torch.int32,
                         generator=g, device=dev).view(torch.uint32)
    model.process_buffer(bufs[0])
    n = itertools.count()
    return bench.cuda_ms(lambda: model.process_buffer(bufs[next(n) % 4]), iters=12)
w = {{"fold": wide_ms(bench.bench_config()),
     "concat": wide_ms(bench.bench_config(fold_concat=True)),
     "fft": wide_ms(bench.fft_config()),
     "fft, no dispersion": wide_ms(bench.fft_config(dispersion=False))}}
try:
    cont = bench.bench_config(fpn_mode=FpnMode.CONTINUOUS)
except (TypeError, ValueError):
    cont = None
fpn = {{}} if cont is None else {{"12-bit": bench.steady_ms_per_buffer(cont, dev),
                                "24-bit": wide_ms(cont)}}
print(json.dumps({{"kernels": {{n: {{"ms": v["ms"], "plain_ms": v["plain_ms"],
                                  "library_ms": v["library_ms"]}} for n, v in k.items()}},
                  "steady_ms": s, "concat_steady_ms": c,
                  "fft_steady_ms": f, "fft_stage_ms": st, "wide_steady_ms": w,
                  "continuous_steady_ms": fpn, "library": str(build.library_path())}}))
"""


def turn(root: str) -> dict:
    """One checkout's times, measured in a fresh process from its root."""
    done = subprocess.run([sys.executable, "-c", _TURN.format(root=root, names=KERNELS)],
                          cwd=root, capture_output=True, text=True, timeout=1800)
    if done.returncode != 0:
        raise RuntimeError(f"turn in {root} failed ({done.returncode}):\n{done.stderr[-4000:]}")
    return json.loads(done.stdout.strip().splitlines()[-1])


def sass(lib: str) -> dict:
    """Each kernel's SASS in the library ``lib`` (``cuobjdump -sass``), its
    instructions by kernel name; the anonymous namespace's per-file tag is
    taken out of the names, so two builds of one source name a kernel
    alike."""
    from torch.utils.cpp_extension import CUDA_HOME

    out = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass", lib],
                         capture_output=True, text=True, check=True).stdout
    kernels, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "_GLOBAL__N_", m.group(1))
            kernels[name] = []
        elif name and "/*" in line:
            kernels[name].append(" ".join(line.split()))
    return kernels


def sass_diff(lib_a: str, lib_b: str) -> dict:
    """The kernels of two libraries by their SASS: how many both have, the
    names of those whose SASS differs, and those only one has."""
    a, b = sass(lib_a), sass(lib_b)
    shared = set(a) & set(b)
    return {"shared": len(shared), "differ": sorted(n for n in shared if a[n] != b[n]),
            "only_A": sorted(set(a) - set(b)), "only_B": sorted(set(b) - set(a))}


def main() -> None:
    import torch

    if len(sys.argv) != 2:
        raise SystemExit("usage: python -m octproz_tpu_torch.ab OTHER_ROOT")
    if not torch.cuda.is_available():
        raise SystemExit("octproz_tpu_torch.ab: no CUDA device; it times the GPU only")
    other = os.path.abspath(sys.argv[1])
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    info = device_info()
    turns = []
    for tag, root in (("A", other), ("B", here), ("B", here), ("A", other)):
        turns.append({"checkout": tag, "root": root, **turn(root)})
        print(f"[ab] turn {len(turns)} ({tag}) done", file=sys.stderr, flush=True)
    print(json.dumps({"device_name": info["device_name"], "power_limit": info["power_limit"],
                      "A": other, "B": here, "turns": turns,
                      "sass": sass_diff(turns[0]["library"], turns[1]["library"])}))


if __name__ == "__main__":
    main()
