"""The port's host utilities against the JAX package's: the message
console and the stage timer (same messages, summaries and reports with the
clock patched), the device report (its shape on a machine without CUDA)
and the trace (a readable Chrome trace file on the CPU)."""

import json
import time

import pytest
import torch

import octproz_tpu.utils.console as jconsole
import octproz_tpu.utils.profiling as jprofiling
import octproz_tpu_torch.utils as tutils
from octproz_tpu_torch.utils import console as tconsole
from octproz_tpu_torch.utils import deviceinfo as tdeviceinfo
from octproz_tpu_torch.utils import profiling as tprofiling


def _drive_console(module, monkeypatch, echo):
    monkeypatch.setattr(time, "strftime", lambda fmt: "12:34:56")
    c = module.MessageConsole(max_messages=3, echo=echo)
    seen = []
    c.subscribe(seen.append)
    c.subscribe(lambda msg: 1 / 0)  # a broken subscriber is reported, not raised
    c.info("hello")
    c.error("boom")
    for i in range(3):
        c.info(f"m{i}")
    return [tuple(m) for m in seen], c.dump()


def test_message_console_matches_jax(monkeypatch, capsys):
    got = _drive_console(tconsole, monkeypatch, echo=True)
    out_t = capsys.readouterr().out
    want = _drive_console(jconsole, monkeypatch, echo=True)
    out_j = capsys.readouterr().out
    assert got == want and out_t == out_j
    assert got[0][1] == ("12:34:56", "error", "boom")
    assert got[1] == "[12:34:56] m0\n[12:34:56] m1\n[12:34:56] m2"  # bounded at 3
    assert "subscriber failed" in out_t
    assert tutils.MessageConsole is tconsole.MessageConsole
    assert tconsole.Message("t", "error", "x").format() == "[t] ERROR: x"


def _drive_timer(module, monkeypatch):
    ticks = iter([0.0, 0.25, 1.0, 1.5, 2.0, 2.125, 3.0, 3.001])
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
    t = module.StageTimer()
    for name in ("upload", "step", "upload", "fetch"):
        with t.section(name):
            pass
    summary, report = t.summary(), t.report()
    t.reset()
    return summary, report, t.summary()


def test_stage_timer_matches_jax(monkeypatch):
    got = _drive_timer(tprofiling, monkeypatch)
    want = _drive_timer(jprofiling, monkeypatch)
    assert got == want
    summary, report, after_reset = got
    assert [r["stage"] for r in summary] == ["step", "upload", "fetch"]  # by total time
    assert summary[1] == {"stage": "upload", "calls": 2, "total_s": 0.375, "mean_ms": 187.5}
    assert len(report.splitlines()) == 3 and after_reset == []


def test_stage_timer_counts_a_section_that_raises():
    t = tprofiling.StageTimer()
    with pytest.raises(RuntimeError):
        with t.section("bad"):
            raise RuntimeError("x")
    assert t.summary()[0]["calls"] == 1


def test_device_report_on_the_cpu(monkeypatch):
    """Without CUDA the report lists the CPU it runs on, as the JAX report
    lists its CPU device; the format names it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rep = tdeviceinfo.device_report()
    assert rep == [{"id": 0, "platform": "cpu", "device_kind": "cpu", "process_index": 0}]
    assert tdeviceinfo.format_report() == "device 0: cpu (cpu)"
    assert tutils.device_report is tdeviceinfo.device_report


def test_device_report_shape_with_cuda(monkeypatch):
    """One entry per CUDA device with its name and memory (the CUDA calls
    stood in for: the report's shape, not a device)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: f"card{i}")
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda i: (30e9, 80e9))
    rep = tdeviceinfo.device_report()
    assert [r["id"] for r in rep] == [0, 1]
    assert rep[1] == {"id": 1, "platform": "gpu", "device_kind": "card1", "process_index": 0,
                      "memory_limit_mb": 80000.0, "memory_in_use_mb": 50000.0}
    assert tdeviceinfo.format_report().splitlines()[0] == "device 0: card0 (gpu), 50000/80000 MB HBM"


def test_trace_writes_a_readable_trace(tmp_path):
    """On the CPU the trace holds the host's operations, in a Chrome trace
    JSON file in the directory given (created if missing)."""
    log_dir = tmp_path / "traces"
    with tprofiling.trace(str(log_dir)) as path:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert path.startswith(str(log_dir))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ops = [e["name"] for e in events if e.get("cat") == "cpu_op"]
    assert any("matmul" in name or "mm" in name for name in ops), ops
    assert all("dur" in e for e in events if e.get("cat") == "cpu_op")
