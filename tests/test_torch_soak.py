"""The port's soak (``octproz_tpu_torch.soak``) on the CPU: one cycle at
the small geometry asserts what ``tests/test_benchmarks.py`` asserts of
the JAX soak's cycle, the summary picks what ``scripts/e2e_soak.py``'s
``pct`` picks, the upload-only window waits for each upload's events, and
the engine window's launch counts are those the smoke holds per chunk."""

import ast
import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from octproz_tpu_torch import runtime, soak
from octproz_tpu_torch.kernels import fused_prep as tfp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401  (autouse: one intra-op thread)
JAX_SOAK = os.path.join(ROOT, "scripts", "e2e_soak.py")


def _jax_main():
    tree = ast.parse(open(JAX_SOAK).read(), JAX_SOAK)
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")


def _jax_pct(ratios):
    """``pct`` as ``scripts/e2e_soak.py``'s ``main`` defines it, over
    ``ratios`` (compiled from the script's own source: it is a closure
    there)."""
    pct = next(n for n in ast.walk(_jax_main())
               if isinstance(n, ast.FunctionDef) and n.name == "pct")
    space = {"ratios": ratios}
    exec(compile(ast.Module(body=[pct], type_ignores=[]), JAX_SOAK, "exec"), space)
    return space["pct"]


def _check_cycle(rec):
    """tests/test_benchmarks.py:48-60's assertions on a cycle record."""
    assert rec["engine_buffers"] > 0 and rec["upload_buffers"] > 0
    assert rec["upload_before_mhz"] > 0 and rec["upload_after_mhz"] > 0
    assert rec["ratio"] is not None and rec["ratio"] > 0


def test_cycle_cpu_small():
    """One cycle, upload-only / engine / upload-only windows of 2 s,
    chunks of 4, the packed-12 wire, on the CPU."""
    rec = soak.run_cycle(2.0, 4, "packed12", model=soak.soak_model(soak.SMALL_ACQ, "cpu"))
    _check_cycle(rec)
    assert rec["wire"] == "packed12" and rec["chunk"] == 4
    assert rec["ratio"] == pytest.approx(
        rec["engine_mhz"] / ((rec["upload_before_mhz"] + rec["upload_after_mhz"]) / 2))


def test_main_cpu_small(tmp_path, capsys):
    """``python -m octproz_tpu_torch.soak --small --device cpu``: one
    cycle on the uint16 wire, its record and the summary in ``--out``."""
    out = tmp_path / "soak.json"
    argv = ["--small", "--device", "cpu", "--cycles", "1", "--window-s", "2", "--chunk", "4",
            "--wire", "uint16", "--out", str(out)]
    assert soak.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    _check_cycle(json.loads(lines[0]))
    report = json.loads(out.read_text())
    assert report["cycles"] == 1 and report["failed_cycles"] == 0
    assert report["ratio_median"] == report["ratio_p10"] == report["records"][0]["ratio"]
    assert json.loads(lines[-1]) == {k: v for k, v in report.items() if k != "records"}


@pytest.mark.parametrize("ratios", [[1.0], [0.3, 1.2], [0.9, 0.1, 0.5],
                                    [0.7, 0.2, 1.4, 0.9, 1.1, 0.4, 0.8],
                                    [float(x) for x in range(20, 0, -1)]])
@pytest.mark.parametrize("p", [50, 10])
def test_pct_picks_as_the_jax_soak(ratios, p):
    """The median and p10 pick the element the JAX soak's ``pct`` picks."""
    ordered = sorted(ratios)
    assert soak.pct(ordered, p) == _jax_pct(ordered)(p)


def test_pct_of_no_cycles():
    assert soak.pct([], 50) is None and _jax_pct([])(50) is None


def test_summary_keys_are_the_jax_soaks():
    """``summarize`` writes the JAX soak report's keys."""
    report = next(n for n in ast.walk(_jax_main()) if isinstance(n, ast.Assign)
                  and getattr(n.targets[0], "id", None) == "report")
    keys = {k.value for k in report.value.keys}
    rec = {"ratio": 0.5, "upload_before_mhz": 1.0, "upload_after_mhz": 2.0}
    summary = soak.summarize([rec], "packed12", 8, 3.0)
    assert set(summary) == keys
    assert summary["upload_mhz_range"] == [1.0, 2.0]


class _Event:
    def __init__(self, log):
        self.log = log

    def synchronize(self):
        self.log.append("synchronized")


def test_upload_window_waits_for_each_upload(monkeypatch):
    """On the card the feeder hands a buffer over before its copy ends;
    the upload-only window synchronizes every event of every buffer
    before it counts the buffer."""
    events = []

    class Feeder(runtime._DeviceFeeder):
        def _items(self):
            for raw, dev, _ in super()._items():
                events.append("handed over")
                yield raw, dev, [("dev0", _Event(events)), ("dev1", _Event(events))]

    monkeypatch.setattr(runtime, "_DeviceFeeder", Feeder)
    model = soak.soak_model(soak.SMALL_ACQ, "cpu")
    _, n = soak.upload_window(model, soak.host_ring(model.acq, "uint16"), "uint16", 1, 0.3)
    assert n > 0 and events.count("synchronized") >= 2 * n


@pytest.mark.parametrize("chunk", [1, 8])
def test_upload_window_builds_the_engines_feeder(monkeypatch, chunk):
    """Both window kinds build the feeder alike: the queue depth and the
    pinned slots the engine's run gives it for ``chunk``."""
    built = []

    class Feeder(runtime._DeviceFeeder):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            built.append((self._queue.maxsize, len(self._ring)))

    monkeypatch.setattr(runtime, "_DeviceFeeder", Feeder)
    model = soak.soak_model(soak.SMALL_ACQ, "cpu")
    ring = soak.host_ring(model.acq, "uint16")
    soak.warm_up(model, ring, "uint16", chunk)
    soak.upload_window(model, ring, "uint16", chunk, 0.2)
    soak.engine_window(model, ring, "uint16", chunk, 0.2)
    depth = max(soak.PREFETCH_DEPTH, chunk)
    assert built == [(depth, depth + 1)] * 2


def test_host_ring_draws():
    """The JAX soak's draws at 12 bits (seed 0); 24-bit samples in uint32;
    the packed-12 wire 1.5 bytes a sample."""
    acq = soak.SMALL_ACQ
    ring = soak.host_ring(acq, "uint16")
    want = np.random.default_rng(0).integers(0, 4096, size=acq.buffer_shape).astype(np.uint16)
    np.testing.assert_array_equal(ring[0], want)
    wide = soak.host_ring(dataclasses.replace(acq, bit_depth=24), "uint16", count=1)[0]
    assert wide.dtype == np.uint32 and int(wide.max()) < 1 << 24 and int(wide.max()) >= 1 << 16
    packed = soak.host_ring(acq, "packed12", count=1)[0]
    assert packed.dtype == np.uint8 and packed.size == acq.samples_per_buffer * 3 // 2


@pytest.fixture
def counted(monkeypatch):
    """The kernels' public wrappers counting as their launches do, then
    running the plain versions (as ``tests/test_torch_card_configs.py``)."""
    wrappers = {"fold_depth": ("depth", 3), "fold_depth_scale": ("depth_scale", 3),
                "prep_phase": ("prep_phase", 2)}
    for name, (family, axes) in wrappers.items():
        plain = getattr(tfp, name)

        def wrapper(raw, *args, plain=plain, family=family, axes=axes, **kw):
            _, _, key, route = tfp._kernel_operands(raw, args[:axes - 1], family)
            tfp._count_launch(key, route)
            return plain(raw, *args, **kw)

        monkeypatch.setattr(tfp, name, wrapper)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "host_memory_stats", lambda: {"num_host_alloc": 0})
    tfp.reset_launch_counts()
    yield
    tfp.reset_launch_counts()


@pytest.mark.parametrize("chunk", [1, 4])
def test_engine_window_counts_one_launch_per_chunk(counted, chunk):
    """The engine window's launches (after the warm-up determined the FPN):
    the bf16 steady-state family, on the bf16 route, once per chunk the
    engine began -- the smoke's check (``chip_smoke._soak_chain``)."""
    model = soak.soak_model(soak.SMALL_ACQ, "cpu")
    ring = soak.host_ring(model.acq, "packed12")
    soak.warm_up(model, ring, "packed12", chunk)
    tfp.reset_launch_counts()
    eng = soak.engine_window(model, ring, "packed12", chunk, 0.5)
    n, chunks = tfp.LAUNCHES["depth_scale"], -(-eng["buffers"] // chunk)
    assert eng["buffers"] >= chunk and chunks <= n <= chunks + 1
    assert {k: v for k, v in tfp.LAUNCHES.items() if v} == {"depth_scale": n}
    assert tfp.ONE_PASS_ROUTES["depth_scale"]["tensor_core_bf16"] == n


def test_smoke_soak_chain_holds_the_stream(counted, monkeypatch, tmp_path):
    """The smoke's soak phase on a small model: the launch check per
    chunk, the summary and the streamed output against ``process_buffer``
    (a bf16 store)."""
    monkeypatch.setattr(chip_smoke, "SOAK_WINDOW_S", 0.5)
    model = soak.soak_model(soak.SMALL_ACQ, "cpu")
    info = {"device_name": "cpu", "power_limit": "n/a"}
    counts = chip_smoke._soak_chain(info, "small", model, "packed12", 4, 1, "depth_scale",
                                    str(tmp_path))
    assert list(counts) == ["depth_scale_bf16"] and counts["depth_scale_bf16"] >= 1


def test_smoke_soak_chain_refuses_a_missing_family(counted, monkeypatch, tmp_path):
    """A chain whose engine did not launch the named family (here the FFT
    path's, on a fold-path model) fails the check."""
    monkeypatch.setattr(chip_smoke, "SOAK_WINDOW_S", 0.3)
    model = soak.soak_model(soak.SMALL_ACQ, "cpu")
    info = {"device_name": "cpu", "power_limit": "n/a"}
    with pytest.raises(AssertionError, match="want the families"):
        chip_smoke._soak_chain(info, "small", model, "uint16", 1, 1, "prep_phase",
                               str(tmp_path))


def test_smoke_soak_chain_refuses_a_pinned_allocation(counted, monkeypatch, tmp_path):
    """A pinned host block allocated inside a cycle's timed windows (not
    by the warm-up) fails the check."""
    monkeypatch.setattr(chip_smoke, "SOAK_WINDOW_S", 0.3)
    allocs = iter(range(100))
    monkeypatch.setattr(torch.cuda, "host_memory_stats", lambda: {"num_host_alloc": next(allocs)})
    model = soak.soak_model(soak.SMALL_ACQ, "cpu")
    info = {"device_name": "cpu", "power_limit": "n/a"}
    with pytest.raises(AssertionError, match="pinned host blocks"):
        chip_smoke._soak_chain(info, "small", model, "uint16", 1, 1, "depth_scale",
                               str(tmp_path))
