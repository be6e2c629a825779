"""Per-buffer latency of the port: the real-time side of the throughput
bench.

Counterpart of ``benchmarks/latency.py``.  The reference is a live
instrument: each acquired buffer must be processed before the
acquisition's double buffer wraps (the blocking CUDA event,
octproz_project/octproz/src/cuda_code.cu:1416-1420, is its back-pressure).
The bench amortizes dispatch over steady runs; this harness measures the
other regime -- one dispatch and one sync per buffer, the latency a
streaming client sees -- and reports its distribution (p50/p90/p99/max)
rather than its mean, since a real-time system is sized by its tail.

Each buffer's latency is ``FdOctModel.process_buffer`` followed by
``torch.cuda.synchronize`` on the host clock: from the call until the
result can be seen.  Buffer 0 (the FPN determination) is warm-up, outside
the timed loop; the loop stops after ``--n`` buffers or 60 s.  The
companion ``amortized_pipelined_ms`` is ``m = max(8, min(32, n))``
buffers with one sync at the end: the floor the chunked paths amortize
toward.

    python -m octproz_tpu_torch.latency [--n 60] [--small] [--backend pallas|xla]
        [--compute-dtype bfloat16|float32] [--device cuda|cpu]

``--backend pallas`` is the kernel route, ``xla`` the ``torch.matmul``
route of the fold path; ``--compute-dtype float32`` is the "default" rung.
Prints ONE JSON line with the card's name and power limit.  ``--device
cuda`` (the default) without a CUDA device exits with an error; ``--device
cpu`` runs the kernels' plain versions and times the CPU.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Optional

import numpy as np
import torch

from .params import AcqParams, FpnMode, Interpolation, ProcConfig
#: The JAX harness's curves (``benchmarks/latency.py:73-77``) and its
#: ``--small`` geometry are the JAX soak's; the full one is ``bench.FULL_ACQ``.
from .soak import SMALL_ACQ, curve_kwargs
#: Wall-clock cap of the timed loop (s).
CAP_S = 60.0
#: Distinct buffers the loop cycles over.
RING = 4


def latency_config(backend: str = "pallas", compute_dtype: str = "bfloat16") -> ProcConfig:
    """The JAX harness's chain (``benchmarks/latency.py:66-72``): cubic
    k-linearization, window, dispersion, FPN once from one B-scan, log
    scaling, on the fold path."""
    return ProcConfig(bitshift=True, resampling=True, interpolation=Interpolation.CUBIC,
                      windowing=True, dispersion=True, fpn_mode=FpnMode.ONCE,
                      bscans_for_noise=1, log_scaling=True, fft_via_matmul=True,
                      fold_backend=backend, compute_dtype=compute_dtype)


def pipelined_count(n: int) -> int:
    """Buffers of the pipelined companion run."""
    return max(8, min(32, n))


def measure(acq: AcqParams, cfg: ProcConfig, device, n: int = 60,
            seed: int = 0) -> Dict[str, object]:
    """The latency record of ``cfg`` on ``acq``: buffer 0 determines the
    FPN outside the timed loop, then up to ``n`` buffers (or
    :data:`CAP_S`), each one call and one sync, cycling over
    :data:`RING` distinct buffers made on the device from ``seed``; then
    the pipelined companion.  The keys are the JAX harness's."""
    from .bench import random_buffers, sync
    from .models.fdoct import FdOctModel

    if n < 1:
        raise ValueError("n must be >= 1 (zero timed buffers yields no statistics)")
    device = torch.device(device)
    model = FdOctModel(acq, cfg, **curve_kwargs(acq), device=device)
    ring = random_buffers(acq, RING, device, seed=seed)
    model.process_buffer(ring[0])  # warm-up: the FPN determination
    sync([device])

    lat_ms = []
    t_start = time.perf_counter()
    for i in range(n):
        t0 = time.perf_counter()
        model.process_buffer(ring[i % RING])
        sync([device])
        lat_ms.append((time.perf_counter() - t0) * 1e3)
        if time.perf_counter() - t_start > CAP_S:
            break
    lat = np.asarray(lat_ms)

    m = pipelined_count(n)
    t0 = time.perf_counter()
    for i in range(m):
        model.process_buffer(ring[i % RING])
    sync([device])
    amortized_ms = (time.perf_counter() - t0) * 1e3 / m

    def q(p):
        return float(np.percentile(lat, p))

    return {
        "metric": "per_buffer_latency",
        "unit": "ms",
        "n": int(lat.size),
        "p50": q(50), "p90": q(90), "p99": q(99),
        "max": float(lat.max()),
        "mean": float(lat.mean()),
        "amortized_pipelined_ms": amortized_ms,
        "sync": ("torch.cuda.synchronize per buffer, host clock" if device.type == "cuda"
                 else "none (the CPU runs each call to its end), host clock"),
        "ascans_per_buffer": acq.ascans_per_buffer,
        "fold_backend": cfg.fold_backend,
        "compute_dtype": cfg.compute_dtype,
        "platform": "gpu" if device.type == "cuda" else "cpu",
    }


def device_fields(device) -> Dict[str, Optional[str]]:
    """The card's name and power limit (``bench.device_info``); on the CPU
    none."""
    if torch.device(device).type != "cuda":
        return {"device_name": None, "power_limit": None}
    from .bench import device_info

    info = device_info()
    return {"device_name": info["device_name"], "power_limit": info["power_limit"]}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=60, help="timed buffers")
    ap.add_argument("--small", action="store_true",
                    help="256 x 32 x 8 buffers (the CPU tests' geometry)")
    ap.add_argument("--backend", default="pallas", choices=["pallas", "xla"])
    ap.add_argument("--compute-dtype", default="bfloat16", choices=["float32", "bfloat16"])
    ap.add_argument("--device", default="cuda", help="torch device (default cuda:0)")
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.n < 1:
        ap.error("--n must be >= 1 (zero timed buffers yields no statistics)")
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("latency: no CUDA device (pass --device cpu for the plain "
                             "versions)")
        torch.backends.cuda.matmul.allow_tf32 = False  # the "xla" route in true float32
    from .bench import FULL_ACQ

    rec = measure(SMALL_ACQ if args.small else FULL_ACQ,
                  latency_config(args.backend, args.compute_dtype), device, args.n)
    print(json.dumps({**rec, **device_fields(device)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
