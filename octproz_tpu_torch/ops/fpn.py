"""Fixed-pattern-noise removal in planar (re, im) and complex form
(minimum-variance mean A-line method, Moon et al. 2010).

Numerics of ``getMinimumVarianceMean`` (cuda_code.cu:523-565): the first
``bscans_for_noise * ascans_per_bscan`` A-scans are cut into FPN_SEGMENTS
segments of ``n_lines // 9`` consecutive lines; per depth index each
segment's mean and variance (E|z|^2 - |Ez|^2) are taken and the mean of the
minimum-variance segment is kept.

The selection is the tie-banded minimum of ``octproz_tpu/ops/fpn.py``, not
the reference's exact argmin: every segment within
``FPN_TIE_EPS * mean power`` of the minimum variance is a tie and the lowest
segment index wins, so the choice does not flip under rounding differences.
"""

from __future__ import annotations

import torch

from ..params import FPN_SEGMENTS, FPN_TIE_EPS


def _banded_argmin(variance: torch.Tensor, power_scale: torch.Tensor) -> torch.Tensor:
    """Lowest segment index whose variance is within the tie band.

    variance: float32 (segments, width); power_scale: float32 (width,).
    Returns int64 (width,).
    """
    v_min = torch.amin(variance, dim=0)
    thresh = v_min + torch.tensor(FPN_TIE_EPS, dtype=torch.float32) * power_scale
    tied = (variance <= thresh[None, :]).to(torch.uint8)
    return torch.argmax(tied, dim=0)  # first maximum == lowest tied index


def segment_sums_planar(re: torch.Tensor, im: torch.Tensor,
                        segments: int = FPN_SEGMENTS):
    """re/im: float32 (n_lines, width) -> (sum_re, sum_im, sum_sq, seg_width)
    with the sums shaped (segments, width).  Trailing lines beyond
    ``segments * seg_width`` are ignored (cuda_code.cu:531)."""
    n_lines, width = re.shape
    if n_lines < segments:
        raise ValueError(
            f"fixed-pattern-noise determination needs at least {segments} "
            f"A-scans (FPN_SEGMENTS, octalgorithmparameters.h:35) but got "
            f"{n_lines}; raise bscans_for_noise or ascans_per_bscan, or "
            f"disable FPN for this geometry")
    seg_width = max(n_lines // segments, 1)
    used_re = re[: segments * seg_width].reshape(segments, seg_width, width)
    used_im = im[: segments * seg_width].reshape(segments, seg_width, width)
    sum_re = used_re.sum(dim=1)
    sum_im = used_im.sum(dim=1)
    sum_sq = (used_re * used_re + used_im * used_im).sum(dim=1)
    return sum_re, sum_im, sum_sq, seg_width


def select_min_variance_mean_planar(sum_re, sum_im, sum_sq, seg_count):
    """Segment statistics -> the minimum-variance mean line (mean_re, mean_im)."""
    factor = torch.tensor(1.0 / seg_count, dtype=torch.float32)
    mean_re = sum_re * factor
    mean_im = sum_im * factor
    variance = sum_sq * factor - (mean_re * mean_re + mean_im * mean_im)
    power_scale = torch.mean(sum_sq * factor, dim=0)
    best = _banded_argmin(variance, power_scale)[None, :]
    return (torch.gather(mean_re, 0, best)[0],
            torch.gather(mean_im, 0, best)[0])


def minimum_variance_mean_planar(re, im, segments: int = FPN_SEGMENTS):
    sum_re, sum_im, sum_sq, seg_width = segment_sums_planar(re, im, segments)
    return select_min_variance_mean_planar(sum_re, sum_im, sum_sq, seg_width)


# Complex forms: the planar functions on the real and imaginary parts.

def segment_sums(lines: torch.Tensor, segments: int = FPN_SEGMENTS):
    """complex64 (n_lines, width) -> (sum_z complex64 (segments, width),
    sum_sq float32 (segments, width), seg_width)."""
    sum_re, sum_im, sum_sq, seg_width = segment_sums_planar(lines.real, lines.imag,
                                                            segments)
    return torch.complex(sum_re, sum_im), sum_sq, seg_width


def select_min_variance_mean(sum_z: torch.Tensor, sum_sq: torch.Tensor,
                             seg_count) -> torch.Tensor:
    """Segment statistics -> the minimum-variance mean line, complex64 (width,)."""
    return torch.complex(*select_min_variance_mean_planar(sum_z.real, sum_z.imag,
                                                          sum_sq, seg_count))


def minimum_variance_mean(lines: torch.Tensor, segments: int = FPN_SEGMENTS) -> torch.Tensor:
    """complex64 (n_lines, width) -> minimum-variance mean line (width,)."""
    return torch.complex(*minimum_variance_mean_planar(lines.real, lines.imag, segments))


def subtract_mean_line(z_half: torch.Tensor, mean_line_half: torch.Tensor) -> torch.Tensor:
    """``meanALineSubtraction`` (cuda_code.cu:567-584) on truncated A-scans."""
    return z_half - mean_line_half
