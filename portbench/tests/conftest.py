"""Fixtures of the benchmark's own tests: a cell cut to a size the CPU
runs in well under a second, and the card, whose absence skips a test."""

from __future__ import annotations

import copy
import json

import pytest
import torch

from portbench import cells


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the tests share a machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def shrink(cell: cells.Cell, samples: int = 64, ascans: int = 16, bscans: int = 4,
           volumes: int = 3, compare: int = 2) -> cells.Cell:
    """``cell`` at a small geometry: the k-linearization's linear term
    follows the line length (the GUI coefficients are normalised by
    (samples - 1)), everything else is the cell's own."""
    cell = copy.deepcopy(cell)
    cell.config["acq"].update(samples_per_line=samples, ascans_per_bscan=ascans,
                              bscans_per_buffer=bscans)
    coeffs = cell.config["curves"]["resample_coeffs"]
    cell.config["curves"]["resample_coeffs"] = [coeffs[0], float(samples - 1), *coeffs[2:]]
    cell.traffic = dict(cell.traffic, volumes=volumes, compare=compare, warmup=1)
    return cell


#: The open-loop cells that PERF.md keeps under Open questions (their p95
#: spreads too widely between runs on a shared host for a bound), as a
#: later benchmark would list them: the kind, its mixes and its readers
#: stay tested.
LIVE = {
    "workloads": [
        {"name": "figshare.live", "config": "octproz-figshare-12bit", "traffic": "open_loop_83",
         "chips": 1, "why": "open-loop scanner at 83 buffers/s from pinned host memory"},
        {"name": "handheld.live", "config": "octproz-handheld-12bit", "traffic": "open_loop_70",
         "chips": 1, "why": "open-loop handheld probe at 70 buffers/s"}],
    "end_to_end": [
        {"name": "latency_p95_ms", "unit": "ms", "better": "lower", "bound": 0.25,
         "source": "host_clock", "workloads": ["figshare.live", "handheld.live"]}],
    "per_layer": [
        {"name": "device_idle_pct.live", "unit": "%", "better": "lower", "source": "device_trace",
         "layer": "device", "moves": "latency_p95_ms",
         "workloads": ["figshare.live", "handheld.live"]},
        {"name": "upload_ms", "unit": "ms", "better": "lower", "source": "device_trace",
         "layer": "upload", "moves": "latency_p95_ms",
         "workloads": ["figshare.live", "handheld.live"]}],
}


def bench_with_live() -> dict:
    """``BENCHMARK.json`` with :data:`LIVE` added."""
    bench = json.loads((cells.REPO / "BENCHMARK.json").read_text())
    for group, entries in LIVE.items():
        bench[group] = bench[group] + entries
    return bench


def load(name: str) -> cells.Cell:
    """A cell of ``BENCHMARK.json`` or of :data:`LIVE`."""
    return cells.load_cell(name, bench_with_live())


@pytest.fixture
def small_cell():
    def make(name: str, **sizes) -> cells.Cell:
        return shrink(load(name), **sizes)
    return make


@pytest.fixture
def card():
    """The CUDA card, or a skip: decided here, when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
