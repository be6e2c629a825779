"""Cells by name: ``BENCHMARK.json``'s entry, its configuration file, its
traffic file, the kind of load that file names, and the readers of its
per-layer metrics.

Nothing here knows a cell, a configuration or a metric by name: every one
is found through ``BENCHMARK.json`` and a file under this directory, so a
later cell, mix or metric is a file added, not an edit.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict          # the configuration file as it is run
    traffic_name: str
    traffic: dict         # the traffic file's parameters
    end_to_end: List[dict]
    per_layer: List[dict]

    def acq(self):
        from octproz_tpu_torch.params import AcqParams

        return AcqParams(**self.config["acq"])

    def proc(self, **changes):
        """The configuration's ``ProcConfig``, with ``changes`` applied (the
        control's lower precision, a post-stage variant)."""
        from octproz_tpu_torch.params import FpnMode, Interpolation, ProcConfig

        fields = dict(self.config["proc"])
        fields["interpolation"] = Interpolation(fields["interpolation"])
        fields["fpn_mode"] = FpnMode(fields["fpn_mode"])
        fields.update(changes)
        return ProcConfig(**fields)

    def curve_kwargs(self) -> dict:
        from octproz_tpu_torch.params import WindowType

        c = dict(self.config["curves"])
        c["resample_coeffs"] = tuple(c["resample_coeffs"])
        c["dispersion_coeffs"] = tuple(c["dispersion_coeffs"])
        c["window_type"] = WindowType(c["window_type"])
        return c

    @property
    def limits(self) -> Dict[str, float]:
        return self.config["correct"]

    @property
    def signal(self) -> Optional[dict]:
        """The configuration's interferogram model, or None for
        ``interferograms.SIGNAL``."""
        return self.config.get("signal")


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _for_cell(metric: dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in e2e_names


def load_cell(name: str, benchmark: Optional[dict] = None, repo: Path = REPO) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (or of ``benchmark``) with
    its files loaded from the checkout ``repo``."""
    bench = benchmark if benchmark is not None else _load_json(repo / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"known: {sorted(entries)}")
    w = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(repo / configs[w["config"]]["file"])
    traffic = _load_json(repo / "portbench" / "traffic" / f"{w['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if _for_cell(m, name, ())]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _for_cell(m, name, e2e_names)]
    return Cell(name=name, chips=w["chips"], config_name=w["config"], config=config,
                traffic_name=w["traffic"], traffic=traffic, end_to_end=e2e,
                per_layer=per_layer)


def _module(folder: str, name: str, repo: Path):
    path = repo / "portbench" / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.{folder}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str, repo: Path = REPO) -> Callable:
    """``read(run) -> float | None`` of ``metrics/<name>.py``."""
    return _module("metrics", name, repo).read


def kind_module(kind: str, repo: Path = REPO):
    """``kinds/<kind>.py``, the load a traffic file's ``kind`` names:
    ``setup(cell, seed, device, changes, wrap, log) -> system.Setup`` and
    ``drive(cell, setup, seconds, sample, spans) -> window``."""
    return _module("kinds", kind, repo)
