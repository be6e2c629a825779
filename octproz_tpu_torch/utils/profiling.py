"""Profiling helpers: device traces and per-stage wall-clock timing.

The counterpart of ``octproz_tpu/utils/profiling.py``.  The reference has
no built-in tracer (profiling is external nvvp/Nsight,
performance/v180/performance_v180.md:57-75); here ``trace()`` wraps
``torch.profiler`` (host activity, and the CUDA kernels and copies of the
device where there is one; view the JSON in Perfetto or chrome://tracing)
and ``StageTimer`` gives cheap named wall-clock sections with summaries,
the per-stage analog of the reference's live throughput box.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time
from typing import Dict, Iterator, List


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[str]:
    """Record a trace of the block -- the operators of every host thread,
    and with a CUDA device its kernels, copies and runtime calls -- into a
    Chrome/Perfetto trace JSON in ``log_dir`` (created if missing); yields
    the path the file is written to when the block ends.

    Usage::

        with profiling.trace("/tmp/oct-trace") as path:
            engine.run(max_buffers=100)
    """
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    # every thread's operators, not only the caller's: the engine's upload
    # and acquisition threads do host work between device operations
    config = _ExperimentalConfig(profile_all_threads=True)
    with profile(activities=activities, experimental_config=config) as prof:
        yield path
    prof.export_chrome_trace(path)


class StageTimer:
    """Named wall-clock sections with count/total/mean summaries.

    Synchronous measurement: call ``torch.cuda.synchronize()`` inside the
    section if you want device time included (CUDA launches are async).
    """

    def __init__(self):
        self._totals: Dict[str, float] = collections.defaultdict(float)
        self._counts: Dict[str, int] = collections.defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._totals[name] += time.perf_counter() - t0
            self._counts[name] += 1

    def summary(self) -> List[dict]:
        out = []
        for name in sorted(self._totals, key=self._totals.get, reverse=True):
            total = self._totals[name]
            n = self._counts[name]
            out.append({"stage": name, "calls": n,
                        "total_s": round(total, 4),
                        "mean_ms": round(total / n * 1e3, 3)})
        return out

    def report(self) -> str:
        lines = [f"{r['stage']:<24} {r['calls']:>6} calls  "
                 f"{r['total_s']:>9.3f} s total  {r['mean_ms']:>8.3f} ms/call"
                 for r in self.summary()]
        return "\n".join(lines)

    def reset(self) -> None:
        self._totals.clear()
        self._counts.clear()
