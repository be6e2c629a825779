"""Peak detection and axial PSF analysis on processed A-scans.

A copy of ``octproz_tpu/extensions/peaks.py`` (numpy only); a quantized
stream normalizes through the port's ``ops.quantize.dequantize``.

Capability-equivalents of the reference's Peak Detector Extension (peak
position display in the 1D plot) and Axial PSF Analyzer Extension (fit of
the axial point-spread function to measure axial resolution)
(docs/docs/plugins.md:20-21,28-29).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ..plugins import Extension


@dataclasses.dataclass
class Peak:
    index: int
    value: float
    subpixel_index: float   # parabolic refinement
    fwhm: float             # full width at half maximum, in samples


def find_peaks(line: np.ndarray, threshold: float = 0.0,
               max_peaks: int = 8, min_distance: int = 3) -> List[Peak]:
    """Local maxima above threshold, strongest first, with parabolic
    sub-pixel refinement and linear-interpolated FWHM."""
    line = np.asarray(line, np.float64)
    n = line.size
    is_max = np.zeros(n, bool)
    is_max[1:-1] = (line[1:-1] > line[:-2]) & (line[1:-1] >= line[2:]) \
        & (line[1:-1] > threshold)
    order = np.argsort(line)[::-1]
    peaks: List[Peak] = []
    taken = np.zeros(n, bool)
    for i in order:
        if len(peaks) >= max_peaks:
            break
        if not is_max[i] or taken[max(0, i - min_distance):i + min_distance + 1].any():
            continue
        taken[i] = True
        y0, y1, y2 = line[i - 1], line[i], line[i + 1]
        denom = y0 - 2 * y1 + y2
        sub = i + (0.5 * (y0 - y2) / denom if abs(denom) > 1e-12 else 0.0)
        half = y1 / 2.0
        lo = i
        while lo > 0 and line[lo] > half:
            lo -= 1
        hi = i
        while hi < n - 1 and line[hi] > half:
            hi += 1

        def cross(a, b):
            # sub-sample position of the half-max crossing between a and b
            # (signed direction: b may be below a)
            if line[b] == line[a]:
                return float(b)
            return a + (b - a) * (half - line[a]) / (line[b] - line[a])
        left = cross(lo, lo + 1) if line[lo] <= half else float(lo)
        right = cross(hi, hi - 1) if line[hi] <= half else float(hi)
        peaks.append(Peak(index=int(i), value=float(y1),
                          subpixel_index=float(sub),
                          fwhm=float(abs(right - left))))
    return peaks


def _selected_line(buffer, bit_depth: int, bscan: int, ascan: int) -> np.ndarray:
    """Normalized float64 A-scan at a clamped (bscan, ascan) selection —
    shared by both line-analysis extensions (quantized streams normalize by
    the code max, ops/quantize.dequantize)."""
    from ..ops.quantize import dequantize

    data = np.asarray(dequantize(buffer, bit_depth), np.float64)
    return data[min(bscan, data.shape[0] - 1), min(ascan, data.shape[1] - 1)]


class PeakDetectorExtension(Extension):
    """Tracks the strongest peaks of a selected A-scan in the processed
    stream."""

    name = "peak-detector"
    wants_processed_data = True

    def __init__(self, bscan: int = 0, ascan: int = 0, threshold: float = 0.0,
                 max_peaks: int = 8):
        super().__init__()
        self.bscan = bscan
        self.ascan = ascan
        self.threshold = threshold
        self.max_peaks = max_peaks
        self.last_peaks: List[Peak] = []

    def processed_data_received(self, buffer, bit_depth, spl, apb, bpb, bpv, nr):
        line = _selected_line(buffer, bit_depth, self.bscan, self.ascan)
        self.last_peaks = find_peaks(line, self.threshold, self.max_peaks)

    def get_output(self):
        if not self.last_peaks:
            return None
        return {"scalars": {"n_peaks": len(self.last_peaks),
                            "bscan": self.bscan, "ascan": self.ascan},
                "table": [dataclasses.asdict(p) for p in self.last_peaks]}


@dataclasses.dataclass
class PsfFit:
    center: float         # samples (sub-pixel)
    fwhm: float           # samples
    amplitude: float
    r_squared: float      # goodness of the Gaussian fit


def fit_axial_psf(line: np.ndarray, peak_index: Optional[int] = None,
                  half_window: int = 8) -> PsfFit:
    """Gaussian fit (log-domain parabola) around the strongest peak of a
    LINEAR-magnitude A-scan -- axial resolution = fwhm x depth spacing."""
    line = np.asarray(line, np.float64)
    if peak_index is None:
        peak_index = int(np.argmax(line))
    lo = max(peak_index - half_window, 0)
    hi = min(peak_index + half_window + 1, line.size)
    x = np.arange(lo, hi, dtype=np.float64)
    y = np.maximum(line[lo:hi], 1e-12)
    w = y ** 2  # weight strong samples; suppress noise floor
    logy = np.log(y)
    # weighted parabola fit: logy ~ a x^2 + b x + c
    coeffs = np.polyfit(x, logy, 2, w=w)
    a, b, c = coeffs
    if a >= 0:  # not a peak -- degenerate fit
        return PsfFit(center=float(peak_index), fwhm=float("inf"),
                      amplitude=float(line[peak_index]), r_squared=0.0)
    center = -b / (2 * a)
    sigma = np.sqrt(-1.0 / (2.0 * a))
    fwhm = 2.0 * np.sqrt(2.0 * np.log(2.0)) * sigma
    amplitude = float(np.exp(c - b * b / (4 * a)))
    pred = np.polyval(coeffs, x)
    ss_res = float(np.sum(w * (logy - pred) ** 2))
    ss_tot = float(np.sum(w * (logy - np.average(logy, weights=w)) ** 2))
    r2 = 1.0 - ss_res / ss_tot if ss_tot > 0 else 0.0
    return PsfFit(center=float(center), fwhm=float(fwhm),
                  amplitude=amplitude, r_squared=r2)


class AxialPsfAnalyzerExtension(Extension):
    """Continuously fits the axial PSF of the strongest reflector in a
    selected A-scan of the processed stream."""

    name = "axial-psf-analyzer"
    wants_processed_data = True

    def __init__(self, bscan: int = 0, ascan: int = 0, half_window: int = 8):
        super().__init__()
        self.bscan = bscan
        self.ascan = ascan
        self.half_window = half_window
        self.last_fit: Optional[PsfFit] = None

    def processed_data_received(self, buffer, bit_depth, spl, apb, bpb, bpv, nr):
        line = _selected_line(buffer, bit_depth, self.bscan, self.ascan)
        self.last_fit = fit_axial_psf(line, half_window=self.half_window)

    def get_output(self):
        if self.last_fit is None:
            return None
        return {"scalars": dataclasses.asdict(self.last_fit)}
