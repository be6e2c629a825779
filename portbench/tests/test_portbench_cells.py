"""BENCHMARK.json against the benchmark's contract, and cells, mixes and
metrics found by name: a file added is found without an edit."""

from __future__ import annotations

import dataclasses
import json
import re
import shutil

import pytest

from portbench import cells, loadgen

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
BENCH = json.loads((cells.REPO / "BENCHMARK.json").read_text())


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])
    assert len(json.dumps(BENCH)) < 64 * 1024
    # a full check of 24 cells: 2 + 14 runs a cell, each run_seconds + 60 s,
    # 2 x 90 s a cell to compile, 1200 s spare, within 43,200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_entries():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
    for group, allowed in keys.items():
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names)), group
        for e in BENCH[group]:
            assert set(e) - {"workloads"} == allowed, (group, e["name"])
            assert NAME.fullmatch(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.fullmatch(e["unit"]) and e["better"] in ("lower", "higher")
            for text in ("why", "layer", "source"):
                if text in e:
                    assert 1 <= len(e[text]) <= 200 and "\n" not in e[text]
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_bounds_and_sources():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] == 0.25 and "workloads" not in setup[0]
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "roofline" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_and_config_is_whole():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert w["chips"] == 1
        cell = cells.load_cell(w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2, w["name"]
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert m["moves"] in names, (w["name"], m["name"])
        cell.proc(), cell.acq(), cell.curve_kwargs()  # every field builds
        assert set(cell.limits) == {"rms", "max_abs", "nan"}


def test_config_files_name_their_cuts():
    for c in BENCH["configs"]:
        data = json.loads((cells.REPO / c["file"]).read_text())
        assert c["file"].startswith("portbench/configs/")
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
        assert data["source"].split()[0] == c["source"].split()[0]
        proc_fields = {f.name for f in dataclasses.fields(cells.load_cell(
            next(w["name"] for w in BENCH["workloads"] if w["config"] == c["name"])).proc())}
        assert set(data["proc"]) == proc_fields  # the configuration as it is run, whole


def test_every_metric_has_a_reader():
    for m in BENCH["per_layer"]:
        assert callable(cells.metric_reader(m["name"]))


def test_new_files_are_found_without_an_edit(tmp_path):
    """A later PR adds a traffic file, a metric reader and entries: the
    loader finds them by name, and no existing file changes."""
    shutil.copytree(cells.REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    mix = json.loads((tmp_path / "portbench/traffic/replay.json").read_text())
    mix["volumes"] = 3
    (tmp_path / "portbench/traffic/replay_three.json").write_text(json.dumps(mix))
    (tmp_path / "portbench/metrics/buffers_seen.py").write_text(
        "def read(run):\n    return float(run.window['buffers'])\n")
    bench["workloads"].append({"name": "figshare.replay3", "config": "octproz-figshare-12bit",
                               "traffic": "replay_three", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "buffers_seen", "unit": "buffers", "better": "higher",
                               "source": "host_clock", "layer": "model step",
                               "moves": "ascan_rate", "workloads": ["figshare.replay3"]})
    cell = cells.load_cell("figshare.replay3", bench, repo=tmp_path)
    assert cell.traffic["volumes"] == 3
    assert [m["name"] for m in cell.per_layer] == ["buffers_seen"]
    read = cells.metric_reader("buffers_seen", repo=tmp_path)
    assert read(type("Run", (), {"window": {"buffers": 7}})()) == 7.0
    with pytest.raises(KeyError):
        cells.load_cell("no.such.cell", bench, repo=tmp_path)


def test_every_mix_names_a_kind_that_is_a_file():
    for w in BENCH["workloads"]:
        kind = cells.kind_module(cells.load_cell(w["name"]).traffic["kind"])
        assert callable(kind.setup) and callable(kind.drive), w["name"]


NEW_KIND = """
from portbench import loadgen, system


def setup(cell, seed, device, changes=None, wrap=None, log=None):
    return system.fdoct(cell, seed, device, pinned=False, changes=changes, wrap=wrap, log=log)


def drive(cell, s, seconds, sample, spans):
    # every second buffer of the ring, back to back
    w = loadgen.replay(s.model, s.ring[::cell.traffic["stride"]], seconds, 1, sample,
                       s.device, spans)
    w["buffers_driven"] = float(w["buffers"])
    return w
"""


def test_a_new_kind_of_load_is_a_file_found_by_name(tmp_path):
    """A load that no kind has yet is ``kinds/<kind>.py`` beside the others,
    named by a traffic file's ``kind``: set up and driven without an edit."""
    import torch

    from conftest import shrink

    shutil.copytree(cells.REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (tmp_path / "portbench/kinds/strided.py").write_text(NEW_KIND)
    (tmp_path / "portbench/traffic/strided.json").write_text(json.dumps(
        {"kind": "strided", "volumes": 4, "stride": 2, "warmup": 1, "compare": 1}))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "figshare.strided", "config": "octproz-figshare-12bit",
                               "traffic": "strided", "chips": 1, "why": "a test"})
    cell = shrink(cells.load_cell("figshare.strided", bench, repo=tmp_path), volumes=4)
    kind = cells.kind_module(cell.traffic["kind"], repo=tmp_path)
    device = torch.device("cpu")
    s = kind.setup(cell, 7, device)
    sample = loadgen.Sample(1, 7)
    w = kind.drive(cell, s, 0.05, sample, [])
    assert w["buffers_driven"] == w["buffers"] > 0
    assert len(sample.kept) == 1 and any(sample.kept[0][0] is r for r in s.ring[::2])
