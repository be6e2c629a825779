"""The readers of what the port records inside its step (``recorded.py``
and the ``program_span`` / ``program_counter`` metrics): on the CPU, from a
traced run of each cell cut small -- host times, no device time, no kernel
launch -- and nothing where the model has no recorder; on the card (marked
``cuda``), one traced run per cell against the same run's trace."""

from __future__ import annotations

import time
import types

import pytest

from portbench import cells, recorded, run

SPANS = ("host_depth_ms.replay", "host_post_ms.replay", "host_step_self_ms.replay",
         "depth_device_ms", "post_device_ms", "kernel_launches_per_buffer")
HOST = ("host_depth_ms.replay", "host_post_ms.replay", "host_step_self_ms.replay")
CELLS = ("figshare.replay", "handheld.replay")


def _traced(cell, device, seconds):
    """A traced run of ``cell`` and the port's record of its window (the
    reference that judges it runs no step)."""
    from octproz_tpu_torch.utils.profiling import RECORDER

    r = run.run_cell(cell, 2**31 + 23, seconds, True, device, time.perf_counter())
    return r, RECORDER.summary()


@pytest.fixture(scope="module")
def cpu_runs():
    from conftest import load, shrink

    return {name: _traced(shrink(load(name)), "cpu", 0.2) for name in CELLS}


@pytest.mark.parametrize("name", CELLS)
def test_readers_on_a_traced_cpu_run(cpu_runs, name):
    r, summary = cpu_runs[name]
    listed = {m["name"] for m in cells.load_cell(name).per_layer} & set(SPANS)
    got = {k: v["value"] for k, v in r["metrics"].items() if k in SPANS}
    assert r["correct"], r["checks"]
    # host times where the cell runs the stage; no device time and no
    # launch on the CPU, whose plain versions launch no kernel
    assert set(got) == listed - {"depth_device_ms", "post_device_ms"}
    assert all(got[k] > 0 for k in HOST if k in got)
    assert got["kernel_launches_per_buffer"] == 0.0
    steps = summary["host"]["octproz.step"]
    assert steps["calls"] == r["attempted"]
    parts = sum(got.get(k, 0.0) for k in HOST)
    assert parts == pytest.approx(steps["mean_ms"], rel=1e-9)


def _run_with(model):
    class Setup:
        def steady_ms(self):
            return 0.0

    s = Setup()
    s.model = model
    return types.SimpleNamespace(steady_ms=s.steady_ms)


@pytest.mark.parametrize("metric", SPANS)
def test_nothing_without_a_recorder_or_a_step(metric):
    from octproz_tpu_torch.utils.profiling import SpanRecorder

    read = cells.metric_reader(metric)
    assert read(_run_with(object())) is None                       # a port without one
    assert read(_run_with(types.SimpleNamespace(recorder=SpanRecorder()))) is None  # no step
    assert read(types.SimpleNamespace(steady_ms=lambda: 0.0)) is None  # no set-up behind it
    assert recorded.per_buffer(_run_with(None)) is None


def _gaps_inside_steps(cell, device, seconds):
    """The names ``devtrace.summarize`` gives the idle gaps of a traced
    window of ``cell`` that lie wholly inside an ``octproz.step`` span."""
    from portbench import devtrace, loadgen

    kind = cells.kind_module(cell.traffic["kind"])
    s = kind.setup(cell, 2**31 + 29, device)
    with devtrace.capture() as prof:
        kind.drive(cell, s, seconds, loadgen.Sample(0, 1), [])
    events = devtrace.events(prof)
    top = 100
    names = [n for n, _ in devtrace.summarize(events, top=top).gaps]
    w0, w1 = devtrace._span(next(e for e in events if e["name"] == devtrace.WINDOW))
    busy = devtrace._merge(
        (max(a, w0), min(b, w1)) for a, b in (devtrace._span(e) for e in events
                                              if e.get("cat") in devtrace.DEVICE_KINDS)
        if min(b, w1) > max(a, w0))
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    holes = sorted(((b - a, a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a),
                   reverse=True)[:top]
    steps = [devtrace._span(e) for e in events
             if e["name"] == "octproz.step" and e.get("cat") == "user_annotation"]
    return [n for (_, a, b), n in zip(holes, names)
            if any(s0 <= a and b <= s1 for s0, s1 in steps)]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_card_spans_against_the_trace(card, name):
    """A traced run of the cell as listed, 3 s: the depth stage's device
    time is the fold kernel's time per buffer in the trace, the post
    stages' is ``post_ms``, one launch a steady buffer, and the host's
    parts add up to the step; an idle gap inside a step is named after a
    span of the port or an operator under one, not the harness's."""
    from conftest import load

    r, summary = _traced(load(name), card, 3.0)
    got = {k: v["value"] for k, v in r["metrics"].items()}
    buffers = r["attempted"]
    fold = sum(s for op, s in r["breakdown"]["device_ops"] if "fold_split" in op)
    assert got["depth_device_ms"] == pytest.approx(1e3 * fold / buffers, rel=0.03)
    if "post_ms" in got:
        assert got["post_device_ms"] == pytest.approx(got["post_ms"], rel=0.10)
    assert got["kernel_launches_per_buffer"] == 1.0
    parts = sum(got.get(k, 0.0) for k in HOST)
    assert parts == pytest.approx(summary["host"]["octproz.step"]["mean_ms"], rel=0.05)
    inside = _gaps_inside_steps(load(name), card, 3.0)
    assert not [n for n in inside if n.startswith("portbench.")], inside
