"""The comparison that decides ``correct``.

Each output the window produced (a sample drawn from the seed, and the
FPN buffer's) is held to the plain reference run on the same raw buffer.
Both are compared in the display range, as OCTproZ shows a processed
volume: the scaled value clipped to [0, 1] (the grayscale minimum and
maximum).  The numbers, each against the configuration file's limit:

* ``rms``: the root mean square of the difference over every compared
  voxel -- what a lower precision moves everywhere;
* ``max_abs``: the largest difference at any voxel -- what a fault in one
  B-scan, one A-scan or one voxel moves;
* ``nan``: voxels of the output that are NaN, limit 0.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch

NUMBERS = ("rms", "max_abs", "nan")


class Tally:
    def __init__(self):
        self.sq = 0.0
        self.count = 0
        self.max_abs = 0.0
        self.nan = 0

    def add(self, out: torch.Tensor, ref: torch.Tensor) -> None:
        out = out.to(device=ref.device, dtype=torch.float64)
        self.nan += int(torch.isnan(out).sum())
        d = torch.clamp(out, 0.0, 1.0) - torch.clamp(ref, 0.0, 1.0)
        d = torch.nan_to_num(d, nan=1.0)
        self.sq += float((d * d).sum())
        self.count += d.numel()
        self.max_abs = max(self.max_abs, float(d.abs().max()))

    def numbers(self) -> Dict[str, float]:
        return {"rms": math.sqrt(self.sq / max(self.count, 1)),
                "max_abs": self.max_abs, "nan": float(self.nan)}


def compare(pairs: Iterable[Tuple[torch.Tensor, torch.Tensor, object]], reference
            ) -> Dict[str, float]:
    """``pairs`` of (output (bscans, ascans, half), raw buffer, FPN mean line
    or None): every output against ``reference.buffer(raw, mean)``."""
    tally = Tally()
    for out, raw, mean in pairs:
        for b0, ref in reference.buffer(raw, mean):
            tally.add(out[b0:b0 + ref.shape[0]], ref)
    return tally.numbers()


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit."""
    checks = {name: {"value": numbers[name], "limit": limits[name]} for name in NUMBERS}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
