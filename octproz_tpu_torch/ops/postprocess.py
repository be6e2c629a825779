"""Post-IFFT image-domain processing: mirror-artifact truncation with
dynamic-range scaling, B-scan flip, sinusoidal scan correction and
post-process background removal.

Numerics of the reference kernels
(octproz_project/octproz/src/cuda_code.cu):

* ``postProcessTruncateLog`` / ``postProcessTruncateLin`` (:699-741):

      log: out = coeff * ((10*log10((re^2+im^2)/half) - min)/(max-min) + addend)
      lin: out = coeff * ((sqrt(re^2+im^2)/half   - min)/(max-min) + addend)

  where half = samples_per_line/2 is both the truncation length and the
  folded-in FFT normalisation;
* ``cuda_bscanFlip`` (:787-807): reverse the A-scan order of the even
  B-scans (bidirectional scanning);
* ``sinusoidalScanCorrection`` (:491-514): linear interpolation along the
  A-scan axis at the acos curve; the reference's flat-index guard
  (``index < samples - width``, :499) leaves the buffer's last A-scan as it
  was, and so does this port;
* ``getPostProcessBackground`` (:743-755): the mean A-scan of the buffer;
* ``postProcessBackgroundRemoval`` (:757-767):
  out = saturate01(data - (weight*bg + offset)).
"""

from __future__ import annotations

import numpy as np
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


def scale_log(z_half: torch.Tensor, half_len: int, gmin: float, gmax: float,
              addend: float, coeff: float) -> torch.Tensor:
    return scale_log_planar(z_half.real, z_half.imag, half_len, gmin, gmax,
                            addend, coeff)


def scale_lin(z_half: torch.Tensor, half_len: int, gmin: float, gmax: float,
              addend: float, coeff: float) -> torch.Tensor:
    return scale_lin_planar(z_half.real, z_half.imag, half_len, gmin, gmax,
                            addend, coeff)


def bscan_flip(volume: torch.Tensor, first_bscan: int = 0) -> torch.Tensor:
    """Reverse the A-scan order of the even B-scans: (bscans, ascans, depth).
    ``first_bscan`` is the buffer index of the volume's first B-scan (a
    shard's offset), so the parity is the buffer's."""
    index = torch.arange(volume.shape[0], device=volume.device) + first_bscan
    even = (index % 2 == 0)[:, None, None]
    return torch.where(even, volume.flip(1), volume)


def sinusoidal_correction(volume: torch.Tensor, curve: torch.Tensor,
                          guard_last: bool = True) -> torch.Tensor:
    """Resample along the A-scan axis at ``curve`` (float32 (ascans,),
    curve[k] = (L/pi) acos(1 - 2k/L)); volume float32 (bscans, ascans, depth).
    ``guard_last``: the volume ends the buffer, so its last A-scan stays as
    it was (False for a shard that does not hold the buffer's last B-scan)."""
    n_asc = volume.shape[1]
    x0 = curve.to(torch.int32)
    frac = (curve - x0.to(torch.float32))[None, :, None]
    f0 = volume.index_select(1, torch.clamp(x0, 0, n_asc - 1))
    f1 = volume.index_select(1, torch.clamp(x0 + 1, 0, n_asc - 1))
    out = f0 + (f1 - f0) * frac
    if guard_last:
        out[-1, -1] = volume[-1, -1]  # the reference's guard: last A-scan untouched
    return out


def get_background(volume: torch.Tensor) -> torch.Tensor:
    """Mean A-scan over the whole buffer: (bscans, ascans, depth) -> (depth,)."""
    return torch.mean(volume, dim=(0, 1))


def remove_post_background(volume: torch.Tensor, background: torch.Tensor,
                           weight: float, offset: float) -> torch.Tensor:
    out = volume - (float(np.float32(weight)) * background + float(np.float32(offset)))
    return torch.clamp(out, 0.0, 1.0)
