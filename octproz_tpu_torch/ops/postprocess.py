"""Mirror-artifact truncation and dynamic-range scaling, planar form.

Numerics of ``postProcessTruncateLog`` / ``postProcessTruncateLin``
(octproz_project/octproz/src/cuda_code.cu:699-741):

    log: out = coeff * ((10*log10((re^2+im^2)/half) - min)/(max-min) + addend)
    lin: out = coeff * ((sqrt(re^2+im^2)/half   - min)/(max-min) + addend)

where half = samples_per_line/2 is both the truncation length and the
folded-in FFT normalization.
"""

from __future__ import annotations

import torch


def truncate_half(z: torch.Tensor) -> torch.Tensor:
    """Keep the positive-depth half of each A-scan: (..., n) -> (..., n//2)."""
    return z[..., : z.shape[-1] // 2]


def scale_log_planar(re: torch.Tensor, im: torch.Tensor, half_len: int,
                     gmin: float, gmax: float, addend: float,
                     coeff: float) -> torch.Tensor:
    db = 10.0 * torch.log10((re * re + im * im) / float(half_len))
    return (coeff * ((db - gmin) / (gmax - gmin) + addend)).to(torch.float32)


def scale_lin_planar(re: torch.Tensor, im: torch.Tensor, half_len: int,
                     gmin: float, gmax: float, addend: float,
                     coeff: float) -> torch.Tensor:
    mag = torch.sqrt(re * re + im * im) / float(half_len)
    return (coeff * ((mag - gmin) / (gmax - gmin) + addend)).to(torch.float32)
