"""Batched inverse FFT along the spectral axis.

The reference runs one batched, unnormalised cuFFT C2C inverse over all
A-scans of a buffer (cufftExecC2C(CUFFT_INVERSE),
octproz_project/octproz/src/cuda_code.cu:1140,1513-1515) and folds the 1/N
into the log/lin scaling.  ``torch.fft`` with ``norm="forward"`` is that
unnormalised inverse (cuFFT on a CUDA tensor).  For real spectra (no
dispersion phasor) the RFFT identity

    ifft_unnormalised(x)[k] = conj(fft(x)[k])        (x real)

computes only the first n/2+1 bins; the consumers use magnitudes and
complex differences of the first half, which conjugation leaves unchanged.
"""

from __future__ import annotations

import torch


def ifft_spectra(x: torch.Tensor) -> torch.Tensor:
    """Unnormalised inverse FFT along the last axis -> complex64 (..., n).

    For real ``x`` torch returns a lazily conjugated tensor (see below); it
    is resolved here."""
    return torch.fft.ifft(x, dim=-1, norm="forward").resolve_conj().to(torch.complex64)


def ifft_spectra_real_half(x_real: torch.Tensor, half: int) -> torch.Tensor:
    """First ``half`` bins of the unnormalised inverse FFT of REAL spectra:
    conj(rfft(x))[..., :half], complex64.

    ``conj()`` is a lazy view whose storage still holds the unconjugated
    values (``view_as_real`` refuses it, ``data_ptr`` points past the
    conjugation), so it is resolved here, before anything reads raw
    storage."""
    return torch.fft.rfft(x_real, dim=-1)[..., :half].conj().resolve_conj() \
        .to(torch.complex64)
