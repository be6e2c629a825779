"""The port's spans and counters (``utils.profiling.RECORDER``): nothing is
recorded, and no profiler range entered, without a profile; inside one,
``FdOctModel.process_buffer`` records ``octproz.step`` per buffer with its
``octproz.depth`` child and, where a post stage runs, ``octproz.post``,
all sharing the buffer's sequence number, on the profile's own timeline;
self times on a fake clock; device times from CUDA events (stood in for
here) that the hot path never waits for; the launch counters; a new
profile starts the record afresh."""

import json
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler

from octproz_tpu_torch.kernels import fused_prep
from octproz_tpu_torch.models import presets
from octproz_tpu_torch.models.fdoct import FdOctModel
from octproz_tpu_torch.params import AcqParams
from octproz_tpu_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

ACQ = AcqParams(samples_per_line=64, ascans_per_bscan=16, bscans_per_buffer=4,
                buffers_per_volume=1, bit_depth=12)
CONFIGS = {"benchmark": presets.benchmark_config(tpu=True),
           "handheld": presets.handheld_sinusoidal_config(tpu=True)}


def _model(name="handheld"):
    return FdOctModel(ACQ, CONFIGS[name], resample_coeffs=(0.0, 63.0, 0.0, 0.0),
                      device="cpu")


def _raw(seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 4096, ACQ.buffer_shape, dtype=np.uint16) << 4)


def _profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _steps(rec):
    return [s for s in rec.spans if s.name == "octproz.step"]


def test_no_profile_records_nothing_and_enters_no_range(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a profiler range entered without a profile")

    model = _model()
    raw = _raw()
    rec = profiling.RECORDER
    before = (len(rec.spans), rec.summary())
    monkeypatch.setattr(autograd_profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    for _ in range(3):
        model.process_buffer(raw)
    fused_prep._count_launch("depth_scale", None)
    fused_prep.LAUNCHES["depth_scale"] -= 1
    assert not rec.recording
    assert (len(rec.spans), rec.summary()) == before
    assert model.sequence == 3


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_a_profile_records_each_buffer_as_a_step_with_its_stages(name):
    model = _model(name)
    raw = _raw()
    model.process_buffer(raw)  # the FPN buffer, before the profile
    with _profile():
        outs = [model.process_buffer(raw) for _ in range(3)]
    rec = model.recorder
    assert rec is profiling.RECORDER
    steps = _steps(rec)
    assert [s.seq for s in steps] == [1, 2, 3] and all(s.parent is None for s in steps)
    post = name == "handheld"
    for step in steps:
        children = sorted((s for s in rec.spans if s.parent == step.id), key=lambda s: s.start)
        assert [c.name for c in children] == ["octproz.depth"] + ["octproz.post"] * post
        assert all(c.seq == step.seq for c in children)
        assert all(step.start <= c.start <= c.end <= step.end for c in children)
    summary = rec.summary()
    assert summary["host"]["octproz.step"]["calls"] == 3
    assert ("octproz.post" in summary["host"]) == post
    assert summary["device"] == {} and summary["counts"] == {}  # the CPU: no events, no launches
    step_s = summary["host"]["octproz.step"]["total_s"]
    parts = (summary["self"]["octproz.step"]["total_s"]
             + sum(summary["host"][n]["total_s"] for n in ("octproz.depth", "octproz.post")
                   if n in summary["host"]))
    assert parts == pytest.approx(step_s, rel=1e-9)
    # recording changes no output
    assert all(torch.equal(o, model.process_buffer(raw)) for o in outs[-1:])


def test_self_time_on_a_fake_clock(monkeypatch):
    rec = profiling.SpanRecorder()
    with _profile():
        ticks = iter([0.0, 1.0, 4.0, 5.0, 9.0, 10.0])
        monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
        with rec.span("octproz.step", seq=7):
            with rec.span("octproz.depth"):
                pass
            with rec.span("octproz.post"):
                pass
        monkeypatch.undo()
    depth, post, step = rec.spans  # in the order they ended
    assert (step.start, step.end, depth.start, depth.end, post.start, post.end) == (
        0.0, 10.0, 1.0, 4.0, 5.0, 9.0)
    assert (step.self_s, depth.self_s, post.self_s) == (3.0, 3.0, 4.0)
    assert depth.seq == post.seq == 7 and depth.parent == step.id == post.parent
    s = rec.summary()
    assert s["self"]["octproz.step"] == {"calls": 1, "total_s": 3.0, "mean_ms": 3000.0}
    assert s["host"]["octproz.step"]["total_s"] == 10.0


def test_the_exported_trace_holds_the_spans_as_user_annotations(tmp_path):
    model = _model()
    raw = _raw()
    with profiling.trace(str(tmp_path)) as path:
        model.process_buffer(raw)
        model.process_buffer(raw)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert {n: names.count(n) for n in set(names) if n.startswith("octproz.")} == {
        "octproz.step": 2, "octproz.depth": 2, "octproz.post": 2}


def _between(kind, model, raw):
    if kind == "summary":
        model.recorder.summary()
    elif kind == "an unrecorded buffer":
        model.process_buffer(raw)


@pytest.mark.parametrize("kind", ["summary", "an unrecorded buffer", "trace"])
def test_a_second_profile_starts_afresh(kind, tmp_path):
    model = _model()
    raw = _raw()
    first = (lambda: profiling.trace(str(tmp_path))) if kind == "trace" else _profile
    with first():
        model.process_buffer(raw)
        model.process_buffer(raw)
    _between(kind, model, raw)
    seq = model.sequence
    with first():
        for _ in range(3):
            model.process_buffer(raw)
    assert [s.seq for s in _steps(model.recorder)] == [seq, seq + 1, seq + 2]
    assert model.recorder.summary()["host"]["octproz.step"]["calls"] == 3


def test_launches_are_counted_while_recording():
    key = "depth_scale"
    was = fused_prep.LAUNCHES[key]
    try:
        fused_prep._count_launch(key, None)  # no profile: LAUNCHES only
        with _profile():
            fused_prep._count_launch(key, None)
            fused_prep._count_launch(key, None)
            fused_prep._count_launch("prep_real", None)
        counts = profiling.RECORDER.summary()["counts"]
        assert counts == {"launches.depth_scale": 2, "launches.prep_real": 1}
        assert fused_prep.LAUNCHES[key] == was + 3
    finally:
        fused_prep.LAUNCHES[key] = was
        fused_prep.LAUNCHES["prep_real"] -= 1


class _Event:
    """A CUDA event's stand-in on a fake device clock: done once the test
    says so, stamped when recorded."""

    clock = [0.0]
    made = []

    def __init__(self, enable_timing=False):
        self.t, self.done = None, False
        _Event.made.append(self)

    def record(self, stream=None):
        self.t, self.done = self.clock[0], False

    def query(self):
        return self.done

    def elapsed_time(self, other):
        assert self.done and other.done
        return (other.t - self.t) * 1e3


class _CudaTensor:
    is_cuda = True

    def get_device(self):
        return 0


def test_device_times_from_pooled_events_without_waiting(monkeypatch):
    waits = []
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: "stream")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: waits.append(device)
                        or [setattr(e, "done", True) for e in _Event.made])
    _Event.made.clear()
    rec = profiling.SpanRecorder()
    x = _CudaTensor()
    with _profile():
        for i in range(4):
            with rec.span("octproz.step", seq=i):
                _Event.clock[0] += 1.0
                with rec.span("octproz.depth", x):
                    _Event.clock[0] += 2.0      # the stage's kernels
                with rec.span("octproz.post", x):
                    _Event.clock[0] += 0.5
            if i == 1:  # the device passes the first two buffers' events
                for e in _Event.made:
                    e.done = True
    # buffers 0-1 made 2 pairs each; buffer 2 took them back from the pool
    assert len(_Event.made) == 2 * 2 * 2 and waits == []
    s = rec.summary()
    assert waits == [0]  # one wait, in the summary
    assert s["device"]["octproz.depth"] == {"calls": 4, "total_s": 8.0, "mean_ms": 2000.0}
    assert s["device"]["octproz.post"]["total_s"] == 2.0
    assert "octproz.step" not in s["device"]  # a host-only span


def test_spans_of_many_threads_keep_their_own_parents():
    """More threads than cores, the interpreter switching often: every
    thread's children hang under its own root, and no total is lost."""
    rec = profiling.SpanRecorder()
    n_threads, n_spans = 16, 200
    switch = sys.getswitchinterval()
    wrong = []

    def work(t):
        for i in range(n_spans):
            with rec.span("octproz.step", seq=t * n_spans + i) as root:
                with rec.span("octproz.depth") as child:
                    if child.parent != root.id or child.seq != root.seq:
                        wrong.append((t, i))

    sys.setswitchinterval(1e-6)
    try:
        with _profile():
            threads = [threading.Thread(target=work, args=(t,)) for t in range(n_threads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(th.is_alive() for th in threads) and wrong == []
    s = rec.summary()
    assert s["host"]["octproz.step"]["calls"] == s["host"]["octproz.depth"]["calls"] == (
        n_threads * n_spans)
    assert len({sp.seq for sp in rec.spans}) == n_threads * n_spans


def test_stage_timer_stats_are_unrounded(monkeypatch):
    ticks = iter([0.0, 0.00012345, 1.0, 1.5])
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
    t = profiling.StageTimer()
    for _ in range(2):
        with t.section("a"):
            pass
    assert t.stats() == {"a": {"calls": 2, "total_s": 0.00012345 + 0.5,
                               "mean_ms": (0.00012345 + 0.5) / 2 * 1e3}}
