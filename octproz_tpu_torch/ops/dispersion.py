"""Spectral windowing and numerical dispersion compensation.

Numerics of the reference kernels (octproz_project/octproz/src/cuda_code.cu):
``windowing`` (:328-339) multiplies by the window; ``dispersionCompensation``
(:593-607) multiplies the real spectrum by the phasor exp(+i phi);
``dispersionCompensationAndWindowing`` (:609-622) does window then phase.
"""

from __future__ import annotations

from typing import Optional

import torch


def apply_window(x: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """x: float32 (..., n) real spectra; window: float32 (n,)."""
    return x * window


def apply_dispersion(x_real: torch.Tensor, phase: torch.Tensor) -> torch.Tensor:
    """Real spectra -> complex64 by the per-column phasor (n,)."""
    return x_real.to(torch.complex64) * phase


def prep_spectra(x_real: torch.Tensor, window: Optional[torch.Tensor],
                 phase: Optional[torch.Tensor]) -> torch.Tensor:
    """Window (optional) then phase (optional).  complex64 when the phasor
    is given, else float32 (real spectra take the half-spectrum FFT)."""
    if window is not None:
        x_real = apply_window(x_real, window)
    if phase is not None:
        return apply_dispersion(x_real, phase)
    return x_real
