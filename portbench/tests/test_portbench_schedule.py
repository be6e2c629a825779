"""The open-loop schedule on a fake clock: due times, the submitter's
lateness, latency from the due time, buffers finishing after the window
counted at their whole latency, the nearest-rank p95, and the replay
window's throttle and rate."""

from __future__ import annotations

import pytest
import torch

from portbench import loadgen


class FakeClock:
    """``time`` for loadgen: sleeping advances it, so does each step, and
    each reading by a microsecond (a spin ends)."""

    def __init__(self):
        self.now = 100.0

    def perf_counter(self):
        self.now += 1e-6
        return self.now

    def thread_time(self):
        return self.now

    def sleep(self, s):
        self.now += s


class FakeModel:
    """A step that takes ``service_s`` of the fake clock and returns which
    ring slot it was given."""

    def __init__(self, clock, service_s, lines=8):
        self.clock, self.service_s = clock, service_s
        self.acq = type("Acq", (), {"ascans_per_buffer": lines})()
        self.calls = []

    def process_buffer(self, raw):
        self.calls.append(self.clock.now)
        self.clock.now += self.service_s
        return raw


@pytest.fixture
def clock(monkeypatch):
    c = FakeClock()
    monkeypatch.setattr(loadgen, "time", c)
    return c


def test_nearest_rank():
    values = list(range(1, 101))
    assert loadgen.nearest_rank(values, 0.95) == 95
    assert loadgen.nearest_rank(values, 0.50) == 50
    assert loadgen.nearest_rank([3.0], 0.95) == 3.0
    assert loadgen.nearest_rank(list(range(1, 21)), 0.95) == 19


def test_due_times_and_latency_under_capacity(clock):
    model = FakeModel(clock, service_s=0.004)
    w = loadgen.open_loop(model, [0, 1, 2], rate=100.0, seconds=1.0,
                          sample=loadgen.Sample(2, 0), device=torch.device("cpu"), spans=[])
    assert w["buffers"] == 100
    t0 = model.calls[0]
    # each buffer handed over at its due time, not before, not late
    assert all(abs(c - (t0 + k / 100.0)) < 1e-5 for k, c in enumerate(model.calls))
    assert w["late_max_ms"] < 0.01  # the fake clock's ticks
    assert w["latency_p95_ms"] == pytest.approx(4.0, abs=0.01)
    assert w["latency_growth_ms"] == pytest.approx(0.0, abs=0.01)


def test_backlog_counts_from_due_time_and_after_the_window(clock):
    """Service 15 ms against a 10 ms period: the submitter falls behind,
    each buffer's latency counts from when it was due (its lateness
    included), and the buffers that finish after the window's end count
    at their whole latency."""
    model = FakeModel(clock, service_s=0.015)
    w = loadgen.open_loop(model, [0], rate=100.0, seconds=1.0,
                          sample=loadgen.Sample(0, 0), device=torch.device("cpu"), spans=[])
    n = w["buffers"]
    assert n == 100
    latency = w["latency_ms"]
    # buffer k starts when k-1 ends (at 15 k ms), ends at 15 (k+1), was due at 10 k
    assert latency == pytest.approx([15.0 * (k + 1) - 10.0 * k for k in range(n)], abs=1.0)
    assert w["late_max_ms"] == pytest.approx(5.0 * (n - 1), abs=1.0)
    assert w["window_s"] == pytest.approx(1.5, abs=1e-3)  # it waits for every due buffer
    assert w["latency_p95_ms"] == sorted(latency)[94]
    assert w["latency_max_ms"] == pytest.approx(15.0 + 5.0 * (n - 1), abs=1.0)
    assert w["latency_growth_ms"] > 100.0


def test_replay_rate_and_throttle(clock):
    model = FakeModel(clock, service_s=0.002, lines=1000)
    spans = []
    w = loadgen.replay(model, list(range(8)), seconds=0.1, ahead=4,
                       sample=loadgen.Sample(3, 1), device=torch.device("cpu"), spans=spans)
    assert w["buffers"] == 50 and len(spans) == 50
    assert w["ascan_rate"] == pytest.approx(50 * 1000 / w["window_s"] / 1e6)
    assert w["window_s"] == pytest.approx(0.1, abs=1e-3)


def test_sample_is_uniform_and_seeded():
    def draw(seed):
        s = loadgen.Sample(4, seed)
        for i in range(1000):
            s.offer(i % 8, i)
        return [out for _, out in s.kept]

    assert draw(5) == draw(5) and draw(5) != draw(6)
    counts = [0] * 10
    for seed in range(400):
        for out in draw(seed):
            counts[out // 100] += 1
    assert min(counts) > 100  # about 160 each: every part of the window is drawn
