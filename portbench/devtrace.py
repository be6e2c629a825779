"""The device trace of a run's window, and its reduction.

``torch.profiler`` records the host's operators and, through CUPTI, the
card's kernels, copies and memsets.  The window is the host span
``portbench.window``; everything below is reckoned inside it: the device's
busy time (the union of kernel, copy and memset intervals over every
stream), the time by device operation, the host-to-device copies, and the
longest idle gaps, each named by the host span or operator that overlaps it
most (the harness's own spans say whether the host was dispatching,
waiting for its schedule or waiting for the card).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Tuple

WINDOW = "portbench.window"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_KINDS = ("cpu_op", "user_annotation")


@dataclasses.dataclass
class Summary:
    window_ns: int
    busy_ns: int
    kernel_ns: int                       # sum of kernel durations
    h2d_ns: int                          # sum of host-to-device copy durations
    h2d_count: int
    ops: List[Tuple[str, float]]         # (device op, seconds), most first
    gaps: List[Tuple[str, float]]        # (host activity, seconds), longest first
    device_events: int

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_ns / self.window_ns


def capture():
    """A ``torch.profiler.profile`` of the host and, where there is one,
    the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


def events(prof) -> List[dict]:
    """The profile's events as its Chrome trace has them (``cat``, ``name``,
    ``ts`` and ``dur`` in microseconds), through a file in the temporary
    directory that is removed again."""
    import json
    import os
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _span(e):
    s = int(round(float(e["ts"]) * 1e3))
    return s, s + int(round(float(e.get("dur", 0)) * 1e3))


def summarize(trace: List[dict], top: int = 10):
    """Reduce a profile's events (:func:`events`); None where the window
    holds no device operation."""
    win = [e for e in trace if e["name"] == WINDOW and e.get("cat") == "user_annotation"]
    if not win:
        raise ValueError(f"the trace has no {WINDOW!r} span")
    w0, w1 = _span(win[0])
    dev = []
    for e in trace:
        if e.get("cat") in DEVICE_KINDS:
            s, t = _span(e)
            s, t = max(s, w0), min(t, w1)
            if t > s:
                dev.append((s, t, e["name"], e["cat"]))
    if not dev:
        return None
    busy = _merge((s, t) for s, t, _, _ in dev)
    totals: Dict[str, int] = collections.defaultdict(int)
    for s, t, name, _ in dev:
        totals[name] += t - s
    kernel_ns = sum(t - s for s, t, _, kind in dev if kind == "kernel")
    h2d = [t - s for s, t, name, kind in dev
           if kind == "gpu_memcpy" and "htod" in name.lower()]
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    holes = sorted(((b - a, a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a),
                   reverse=True)[:top]
    host = [(*_span(e), e["name"]) for e in trace
            if e.get("cat") in HOST_KINDS and e["name"] != WINDOW]
    gaps = []
    for length, a, b in holes:
        best = max(((min(b, t) - max(a, s), -(t - s), name) for s, t, name in host
                    if min(b, t) > max(a, s)), default=(0, 0, "(no host span)"))
        gaps.append((best[2], length / 1e9))
    return Summary(window_ns=w1 - w0, busy_ns=sum(t - s for s, t in busy),
                   kernel_ns=kernel_ns, h2d_ns=sum(h2d), h2d_count=len(h2d),
                   ops=sorted(((n, v / 1e9) for n, v in totals.items()),
                              key=lambda r: -r[1])[:top],
                   gaps=gaps, device_events=len(dev))
