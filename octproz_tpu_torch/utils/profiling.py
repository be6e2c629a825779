"""Profiling helpers: device traces, per-stage wall-clock timing, and the
spans and counters the port records inside its step while a profile runs.

The counterpart of ``octproz_tpu/utils/profiling.py``.  The reference has
no built-in tracer (profiling is external nvvp/Nsight,
performance/v180/performance_v180.md:57-75); here ``trace()`` wraps
``torch.profiler`` (host activity, and the CUDA kernels and copies of the
device where there is one; view the JSON in Perfetto or chrome://tracing)
and ``StageTimer`` gives cheap named wall-clock sections with summaries,
the per-stage analog of the reference's live throughput box.

``RECORDER`` is the process's :class:`SpanRecorder`.  The port's step opens
its spans through it (``octproz.step``: ``FdOctModel.process_buffer``;
``octproz.depth``: stages 1-6; ``octproz.post``: the post stages) and adds
to its counters (``launches.<family>``: each hand-written kernel launch).
It records only while a ``torch.profiler`` profile records -- ``trace()``,
or any other -- and then on the profile's own timeline, so an exported
trace puts each device gap down to the port stage the host was in.  It is
one per process because the profile it follows is.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[str]:
    """Record a trace of the block -- the operators of every host thread,
    and with a CUDA device its kernels, copies and runtime calls -- into a
    Chrome/Perfetto trace JSON in ``log_dir`` (created if missing); yields
    the path the file is written to when the block ends.  The port's
    spans (``octproz.*``) are in it as user annotations, and ``RECORDER``
    holds this block's record.

    Usage::

        with profiling.trace("/tmp/oct-trace") as path:
            engine.run(max_buffers=100)
    """
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
    RECORDER._between = True  # a new profile: the record starts afresh
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
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        """One call of ``name`` that took ``seconds``."""
        self._totals[name] += seconds
        self._counts[name] += 1

    def stats(self) -> Dict[str, dict]:
        """Per name, unrounded: ``calls``, ``total_s`` and ``mean_ms``."""
        return {name: {"calls": n, "total_s": self._totals[name],
                       "mean_ms": self._totals[name] / n * 1e3}
                for name, n in self._counts.items()}

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


class Span(NamedTuple):
    """One recorded span, kept when it ends: its ``id``, ``name``, the
    ``parent`` span's id (the span open around it on the same thread; None
    for a root), the buffer's sequence number ``seq`` (a root's own,
    shared by its children), host ``start`` and ``end``
    (``time.perf_counter`` seconds), and ``self_s``: its duration less
    what its children cover.  A tuple of plain values: the collector stops
    tracking it, however many a long profile keeps."""

    id: int
    name: str
    parent: Optional[int]
    seq: Optional[int]
    start: float
    end: float
    self_s: float


class _Recording:
    """:meth:`SpanRecorder.span` while a profile records, the span while it is
    open: a ``record_function`` range, and for a device stage a pair of
    CUDA events on the current stream."""

    __slots__ = ("rec", "name", "tensor", "seq", "id", "parent", "start", "children_s",
                 "range", "events")

    def __init__(self, rec: "SpanRecorder", name: str, tensor, seq: Optional[int]):
        self.rec, self.name, self.tensor, self.seq = rec, name, tensor, seq

    def __enter__(self) -> "_Recording":
        rec = self.rec
        stack = rec._stack()
        parent = stack[-1] if stack else None
        if parent is not None and self.seq is None:
            self.seq = parent.seq
        self.parent = None if parent is None else parent.id
        self.id = next(rec._ids)
        self.children_s = 0.0
        self.range = _autograd_profiler.record_function(self.name)
        self.range.__enter__()
        self.events = rec._start_events(self.tensor)
        stack.append(self)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        end = time.perf_counter()
        if self.events is not None:
            self.events[2].record(self.events[3])
        self.range.__exit__(*exc)
        stack = self.rec._stack()
        stack.pop()
        self.rec._close(self, end, stack[-1] if stack else None)


class SpanRecorder:
    """Spans and counters inside the port's step, recorded only while a
    ``torch.profiler`` profile records.

    Off (no profile), :meth:`span` reads the profiler's flag, notes that
    no profile runs and returns a shared null context, and :meth:`count`
    reads the flag and returns: nothing is allocated, timed, locked or
    appended.  On, a span is one ``record_function`` range on the
    profile's clock, and a :class:`Span` in :attr:`spans`; a device stage
    also records two CUDA events on its tensor's current stream, from a
    pool of pairs reused once ``query()`` shows them done, so recording
    never waits for the device.  Per name, ``host``, ``self`` (host less
    children) and ``device`` totals are kept in :class:`StageTimer`'s
    form; the device times are folded in by :meth:`summary`, which waits
    for the device once.  The record starts afresh at the first span or
    count of a new profile.
    """

    def __init__(self):
        self._local = threading.local()
        self._lock = threading.Lock()
        self._free: Dict[int, List[tuple]] = collections.defaultdict(list)  # device -> event pairs
        self._ids = itertools.count()
        self._restart()

    def _restart(self) -> None:
        self.spans: List[Span] = []
        self.host, self.self_time, self.device = StageTimer(), StageTimer(), StageTimer()
        self.counts: Dict[str, int] = collections.defaultdict(int)
        self._pending = collections.deque()  # (name, device, start, end), oldest first
        # True once no profile has been seen since the record was last written
        self._between = False

    @property
    def recording(self) -> bool:
        """True while a profile records."""
        return _autograd_profiler._is_profiler_enabled

    def span(self, name: str, tensor=None, seq: Optional[int] = None):
        """A context for the stage ``name`` (``octproz.<stage>``).
        ``tensor``: for a device stage, a tensor of the stage; on a CUDA
        device the span also times the device between its two events.
        ``seq``: a root's buffer sequence number (children take their
        root's)."""
        if not _autograd_profiler._is_profiler_enabled:
            self._between = True
            return _NULL
        if self._between:
            self._begin()
        return _Recording(self, name, tensor, seq)

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to the counter ``name`` while a profile records."""
        if not _autograd_profiler._is_profiler_enabled:
            return
        if self._between:
            self._begin()
        with self._lock:
            self.counts[name] += n

    def summary(self) -> dict:
        """The record's per-name totals: ``host``, ``self`` and ``device``
        as :meth:`StageTimer.stats` gives them, and ``counts``.  Waits
        once for the device to fold in every pending device time."""
        with self._lock:
            if self._pending:
                for device in {p[1] for p in self._pending}:
                    torch.cuda.synchronize(device)
                self._fold(wait=True)
            out = {"host": self.host.stats(), "self": self.self_time.stats(),
                   "device": self.device.stats(), "counts": dict(self.counts)}
        if not self.recording:
            self._between = True
        return out

    def _begin(self) -> None:
        with self._lock:
            if self._between:
                self._restart()

    def _stack(self) -> List[_Recording]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _start_events(self, tensor):
        """(device, start, end, stream) with ``start`` recorded, or None
        where ``tensor`` is not on a CUDA device."""
        if tensor is None or not tensor.is_cuda:
            return None
        device = tensor.get_device()
        with self._lock:
            free = self._free[device]
            if not free:
                self._fold(wait=False)
            pair = free.pop() if free else (torch.cuda.Event(enable_timing=True),
                                            torch.cuda.Event(enable_timing=True))
        stream = torch.cuda.current_stream(device)
        pair[0].record(stream)
        return (device, *pair, stream)

    def _close(self, span: _Recording, end: float, parent: Optional[_Recording]) -> None:
        duration = end - span.start
        with self._lock:
            if parent is not None:
                parent.children_s += duration
            self.spans.append(Span(span.id, span.name, span.parent, span.seq, span.start, end,
                                   duration - span.children_s))
            self.host.add(span.name, duration)
            self.self_time.add(span.name, duration - span.children_s)
            if span.events is not None:
                self._pending.append((span.name, *span.events[:3]))

    def _fold(self, wait: bool) -> None:
        """Device times of the pending pairs into ``device``, oldest first,
        each pair back to the pool; without ``wait`` up to the first pair
        the device has not passed yet.  Under the lock."""
        while self._pending:
            name, device, start, end = self._pending[0]
            if not wait and not end.query():
                return
            self._pending.popleft()
            self.device.add(name, start.elapsed_time(end) / 1e3)
            self._free[device].append((start, end))


_NULL = contextlib.nullcontext()

#: The process's recorder.
RECORDER = SpanRecorder()
