"""Image statistics and raw-signal monitoring extensions.

A copy of ``octproz_tpu/extensions/statistics.py`` (numpy only).

Capability-equivalents of the reference's Image Statistics Extension
(histogram + statistics of the currently displayed image) and Signal Monitor
Extension (raw digitizer signal level / saturation check)
(docs/docs/plugins.md:22-27).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..plugins import Extension


@dataclasses.dataclass
class FrameStats:
    minimum: float
    maximum: float
    mean: float
    std: float
    histogram: np.ndarray       # counts, n_bins
    bin_edges: np.ndarray


class ImageStatisticsExtension(Extension):
    """Histogram + min/max/mean/sigma of processed frames."""

    name = "image-statistics"
    wants_processed_data = True

    def __init__(self, n_bins: int = 64, frame_decimation: int = 1):
        super().__init__()
        self.n_bins = n_bins
        self.frame_decimation = max(1, frame_decimation)
        self.last: Optional[FrameStats] = None
        self._count = 0

    def processed_data_received(self, buffer, bit_depth, spl, apb, bpb, bpv, nr):
        self._count += 1
        if (self._count - 1) % self.frame_decimation:
            return
        data = np.asarray(buffer)
        # float range: the true (min, max); numpy auto-expands an equal
        # range, so no falsy-zero substitute (which skewed non-positive data)
        hist_range = (0, 2 ** bit_depth - 1) if np.issubdtype(data.dtype, np.integer) \
            else (float(data.min()), float(data.max()))
        counts, edges = np.histogram(data, bins=self.n_bins, range=hist_range)
        self.last = FrameStats(
            minimum=float(data.min()), maximum=float(data.max()),
            mean=float(data.mean()), std=float(data.std()),
            histogram=counts, bin_edges=edges)

    def get_output(self):
        if self.last is None:
            return None
        s = self.last
        return {"scalars": {"minimum": s.minimum, "maximum": s.maximum,
                            "mean": s.mean, "std": s.std},
                "series": {"histogram": s.histogram.tolist()}}


@dataclasses.dataclass
class SignalLevel:
    minimum: int
    maximum: int
    mean: float
    saturation_fraction: float   # samples at full scale
    zero_fraction: float


class SignalMonitorExtension(Extension):
    """Raw digitizer level monitor: range usage and clipping detection."""

    name = "signal-monitor"
    wants_raw_data = True

    def __init__(self, frame_decimation: int = 1):
        super().__init__()
        self.frame_decimation = max(1, frame_decimation)
        self.last: Optional[SignalLevel] = None
        self._count = 0

    def raw_data_received(self, buffer, bit_depth, spl, apb, bpb, bpv, nr):
        self._count += 1
        if (self._count - 1) % self.frame_decimation:
            return
        data = np.asarray(buffer)
        full_scale = 2 ** bit_depth - 1
        self.last = SignalLevel(
            minimum=int(data.min()), maximum=int(data.max()),
            mean=float(data.mean()),
            saturation_fraction=float(np.mean(data >= full_scale)),
            zero_fraction=float(np.mean(data == 0)))

    def get_output(self):
        if self.last is None:
            return None
        return {"scalars": dataclasses.asdict(self.last)}
