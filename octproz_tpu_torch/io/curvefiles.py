"""Curve CSV persistence: custom resampling / background curves.

A copy of ``octproz_tpu/io/curvefiles.py`` (numpy only).
Capability-equivalent of the reference's ``OctAlgorithmParametersManager``
(octproz_project/octproz/src/octalgorithmparametersmanager.{h,cpp}): loads
and saves curves as ``index;value`` CSV (octalgorithmparametersmanager.cpp:
12-45), the format its Phase Extraction plugin and sidebar mini-plots
exchange (octprozapp.cpp:585-608 custom resampling curve loader).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def save_curve_csv(path: str, curve: np.ndarray) -> str:
    """Write ``index;value`` lines (MiniCurvePlot save convention)."""
    curve = np.asarray(curve, np.float64).ravel()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for i, v in enumerate(curve):
            f.write(f"{i};{v:.9g}\n")
    return path


def load_curve_csv(path: str, expected_size: Optional[int] = None) -> np.ndarray:
    """Read an ``index;value`` CSV -> float32 curve.

    Tolerates a header line, blank lines, and ','-decimal locales (the
    reference reads with QString::toDouble which is locale-lenient).
    Values are placed at their stated indices; missing indices become 0.
    """
    pairs = []
    with open(path) as f:
        for line_nr, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            parts = line.split(";")
            if len(parts) < 2:
                raise ValueError(f"{path}:{line_nr + 1}: expected 'index;value'")
            try:
                idx = int(float(parts[0]))
                val = float(parts[1].replace(",", "."))
            except ValueError:
                if line_nr == 0:
                    continue  # header
                raise ValueError(f"{path}:{line_nr + 1}: bad entry {line!r}")
            pairs.append((idx, val))
    if not pairs:
        raise ValueError(f"{path}: no curve points")
    points = max(i for i, _ in pairs) + 1
    if expected_size is not None and points != expected_size:
        # a curve recorded for a different geometry must not silently load
        # truncated / zero-padded
        raise ValueError(
            f"{path}: curve has {points} points but the configuration "
            f"needs {expected_size} (samples_per_line mismatch?)")
    size = expected_size if expected_size is not None else points
    curve = np.zeros(size, np.float32)
    for i, v in pairs:
        if i < 0 or i >= size:
            raise ValueError(f"{path}: curve index {i} out of range [0, {size})")
        curve[i] = v
    return curve
