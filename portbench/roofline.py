"""Peaks of the card, and the least work a buffer needs.

The least time one card could take for a buffer counts only what the
inputs and outputs need, whatever implements the chain: every raw sample
read once and every output voxel written once over the memory bandwidth,
and an FFT-based transform's 5 N log2 N operations per line over the
tensor cores' peak.  The larger of the two bounds it.
"""

from __future__ import annotations

import math

#: Published peaks (NVIDIA's data sheet, SXM part, dense, at 700 W).
PEAKS = {
    "H100": {"hbm_bytes_per_s": 3.35e12, "tensor_flops": 989e12},
}


def peaks(device_kind: str):
    """The peak table's row for a card's name, or None."""
    for key, row in PEAKS.items():
        if key in device_kind:
            return row
    return None


def buffer_bytes(acq: dict, output_bytes: int = 4) -> int:
    """Raw samples in (their container's bytes) and output voxels out."""
    lines = acq["ascans_per_bscan"] * acq["bscans_per_buffer"]
    n = acq["samples_per_line"]
    container = 1 if acq["bit_depth"] <= 8 else 2 if acq["bit_depth"] <= 16 else 4
    return lines * n * container + lines * (n // 2) * output_bytes


def buffer_flops(acq: dict) -> float:
    lines = acq["ascans_per_bscan"] * acq["bscans_per_buffer"]
    n = acq["samples_per_line"]
    return 5.0 * n * math.log2(n) * lines


def least_seconds(acq: dict, device_kind: str):
    """(seconds, "bytes" or "flops") of one buffer on the card, or None for
    a card the table does not hold."""
    row = peaks(device_kind)
    if row is None:
        return None
    by_bytes = buffer_bytes(acq) / row["hbm_bytes_per_s"]
    by_flops = buffer_flops(acq) / row["tensor_flops"]
    return (by_bytes, "bytes") if by_bytes >= by_flops else (by_flops, "flops")
