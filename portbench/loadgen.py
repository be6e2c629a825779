"""The load schedules that the traffic kinds (``kinds/<kind>.py``) drive
a system with, and what they measure.

``replay`` -- the buffers of a ring processed back to back, with at most
``ahead`` dispatched and not yet finished; the A-scan rate is every A-scan
of the window over the window's host-clock length, which starts and ends
at a synchronize.

``open_loop`` -- a scanner: buffer k comes due at k / ``rate`` after the
window opens and is handed over then, whatever is still in flight.  Its
latency runs from when it was due to its output being ready on the device:
a CUDA event recorded after the call, read against one recorded when the
window opened, so the device clock stamps completion.  Every buffer due in
the window is waited for, after the window too, and counts.

Outputs are kept only in ``Sample``: a reservoir drawn from the seed, the
outputs the comparison judges once the window has closed.  A window's
``notes`` are lines for standard error: what the host did besides the work.
"""

from __future__ import annotations

import math
import random
import time
from typing import List

import torch
from torch.profiler import record_function

from .devtrace import WINDOW


class HostEvent:
    """The CPU's stand-in for a CUDA event: a host-clock stamp (a CPU step
    has finished when its call returns)."""

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, other) -> float:
        return (other.t - self.t) * 1e3


def new_event(device):
    if device.type == "cuda":
        return torch.cuda.Event(enable_timing=True)
    return HostEvent()


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Sample:
    """A uniform reservoir of ``size`` (raw buffer, output) pairs over
    every buffer offered, drawn from ``seed``."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = random.Random(seed)
        self.kept: List[tuple] = []
        self.seen = 0

    def offer(self, raw, out) -> None:
        if len(self.kept) < self.size:
            self.kept.append((raw, out))
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.size:
                self.kept[j] = (raw, out)
        self.seen += 1


class HostWatch:
    """What the host did in a window besides the work: the longest calls
    with the thread's CPU time in each (a call whose CPU time is far below
    its wall time waited: preempted, or blocked in the driver), and the
    device segments the caching allocator took from the card (each a
    cudaMalloc, which stalls the host)."""

    def __init__(self, device):
        self.device = device
        self.calls = []  # (wall s, thread CPU s, index)
        self.segments = self._segments()

    def _segments(self) -> int:
        if self.device.type != "cuda":
            return 0
        return torch.cuda.memory_stats(self.device).get("segment.all.allocated", 0)

    def call(self, fn, *args):
        w, c = time.perf_counter(), time.thread_time()
        out = fn(*args)
        self.calls.append((time.perf_counter() - w, time.thread_time() - c, len(self.calls)))
        return out

    def report(self) -> str:
        worst = sorted(self.calls, reverse=True)[:3]
        return ("device segments allocated {}; longest calls (wall ms, thread CPU ms, index) "
                "{}".format(self._segments() - self.segments,
                            [(w * 1e3, c * 1e3, i) for w, c, i in worst]))


def nearest_rank(values, q: float) -> float:
    """The q-quantile by nearest rank: the smallest value with at least a
    share q of all values at or below it."""
    s = sorted(values)
    return s[max(math.ceil(q * len(s)) - 1, 0)]


def replay(model, ring, seconds: float, ahead: int, sample: Sample, device,
           spans: List[float]) -> dict:
    lines = model.acq.ascans_per_buffer
    marks = [new_event(device) for _ in range(ahead)]
    sync(device)
    watch = HostWatch(device)
    with record_function(WINDOW):
        t0 = time.perf_counter()
        i = 0
        while time.perf_counter() - t0 < seconds:
            if i >= ahead:
                with record_function("portbench.wait_card"):
                    marks[i % ahead].synchronize()
            raw = ring[i % len(ring)]
            with record_function("portbench.dispatch"):
                out = watch.call(model.process_buffer, raw)
            spans.append(watch.calls[-1][0])
            marks[i % ahead].record()
            sample.offer(raw, out)
            i += 1
        with record_function("portbench.wait_card"):
            sync(device)
        window = time.perf_counter() - t0
    return {"buffers": i, "window_s": window, "ascan_rate": i * lines / window / 1e6,
            "notes": [f"[window] {i} buffers in {window} s; {watch.report()}"]}


def wait_until(t: float) -> None:
    """Sleep to within two milliseconds of ``t``, then spin: a sleep may
    overshoot by a millisecond or more on a shared host."""
    while True:
        left = t - time.perf_counter()
        if left <= 0:
            return
        if left > 0.003:
            time.sleep(left - 0.002)


def open_loop(model, ring, rate: float, seconds: float, sample: Sample, device,
              spans: List[float]) -> dict:
    due_count = math.ceil(seconds * rate)
    done = [new_event(device) for _ in range(due_count)]
    opened = new_event(device)
    late = []
    sync(device)
    watch = HostWatch(device)
    with record_function(WINDOW):
        opened.record()
        t0 = time.perf_counter()
        for k in range(due_count):
            due = t0 + k / rate
            with record_function("portbench.schedule"):
                wait_until(due)
            late.append(time.perf_counter() - due)
            raw = ring[k % len(ring)]
            with record_function("portbench.dispatch"):
                out = watch.call(model.process_buffer, raw)
            spans.append(watch.calls[-1][0])
            done[k].record()
            sample.offer(raw, out)
        with record_function("portbench.wait_card"):
            sync(device)
        window = time.perf_counter() - t0
    latency = [opened.elapsed_time(done[k]) - k / rate * 1e3 for k in range(due_count)]
    quarter = max(due_count // 4, 1)
    w = {"buffers": due_count, "window_s": window,
         "latency_ms": latency,
         "latency_p95_ms": nearest_rank(latency, 0.95),
         "latency_p50_ms": nearest_rank(latency, 0.50),
         "latency_max_ms": max(latency),
         # a backlog that grows shows as later buffers waiting longer
         "latency_growth_ms": (sum(latency[-quarter:]) - sum(latency[:quarter])) / quarter,
         "late_p50_ms": nearest_rank(late, 0.50) * 1e3,
         "late_p95_ms": nearest_rank(late, 0.95) * 1e3,
         "late_max_ms": max(late) * 1e3,
         "dispatch_p50_ms": nearest_rank(spans, 0.50) * 1e3,
         "dispatch_max_ms": max(spans) * 1e3}
    w["notes"] = [
        f"[schedule] {due_count} buffers due at {rate}/s; submitter late p50 "
        f"{w['late_p50_ms']} ms, p95 {w['late_p95_ms']} ms, max {w['late_max_ms']} ms; "
        f"latency p50 {w['latency_p50_ms']} ms, max {w['latency_max_ms']} ms, growth "
        f"{w['latency_growth_ms']} ms; the call's host time p50 {w['dispatch_p50_ms']} ms, "
        f"max {w['dispatch_max_ms']} ms",
        f"[window] {due_count} buffers in {window} s; {watch.report()}"]
    return w
