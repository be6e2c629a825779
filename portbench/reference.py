"""The plain reference: OCTproZ's processing chain in float64 PyTorch.

A direct transcription of the reference kernels' mathematics
(OCTproZ ``cuda_code.cu``; the same equations as the float64 NumPy oracle
of the repository's tests, of which this is a frozen, vectorized copy), in
the chain's own order: decode with bitshift, rolling-average background
removal, k-linearization by cubic interpolation at the polynomial curve,
spectral window, dispersion phasor, unnormalised inverse FFT, truncation to
the positive-depth half, fixed-pattern-noise removal by the minimum-variance
mean line, log scaling, B-scan flip, sinusoidal scan correction.

It imports nothing of the port and takes nothing the port made: the curves
(resampling polynomial, window, phasor, sinusoidal curve) and the FPN mean
line are worked out here from the configuration file and the raw buffers.
The LUTs are defined as OCTproZ defines them, in float32 (``polynomial.cpp``
evaluates the curve in float); everything from the decoded samples on is
float64.  It runs on whatever device holds the raw buffer, in blocks of
B-scans so that it fits beside the outputs it judges.
"""

from __future__ import annotations

import math

import numpy as np
import torch

FPN_SEGMENTS = 9        # octalgorithmparameters.h:35
FPN_TIE_EPS = 1e-3      # the tie band of the minimum-variance selection


def polynomial_curve(coeffs, size: int) -> np.ndarray:
    """c0 + c1 x + c2 x^2 + c3 x^3 at x = 0..size-1 with the GUI
    coefficients normalised by (size-1)^p, Horner in float32
    (polynomial.cpp:108-116, octalgorithmparameters.cpp:148-157)."""
    n1 = float(size - 1)
    c = (coeffs[0], coeffs[1] / n1, coeffs[2] / n1 ** 2, coeffs[3] / n1 ** 3)
    x = np.arange(size, dtype=np.float32)
    y = np.zeros(size, dtype=np.float32)
    for ci in reversed(c):
        y = y * x + np.float32(ci)
    return y


def resample_curve(coeffs, n: int) -> np.ndarray:
    """The k-linearization curve, clamped to [0, n-3]
    (octalgorithmparameters.cpp:167)."""
    return np.clip(polynomial_curve(coeffs, n), 0.0, float(n - 3)).astype(np.float32)


def hann_window(n: int, center: float = 0.5, fill: float = 1.0) -> np.ndarray:
    """windowfunction.cpp's Hann window: ``int(fill * n)`` samples centred at
    ``int(center * n)``, zero outside xi in [0.0001, 0.999]."""
    width = max(int(fill * n), 2)
    min_pos = int(min(max(center, 0.0), 1.0) * n) - width // 2
    xi = (np.arange(n, dtype=np.float64) - min_pos) / (width - 1.0)
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * xi))
    return np.where((xi <= 0.999) & (xi >= 0.0001), w, 0.0).astype(np.float32)


def dispersion_phasor(coeffs, n: int) -> np.ndarray:
    """exp(+i phi) of the float32 dispersion polynomial
    (octalgorithmparameters.cpp:206-232, cuda_code.cu:624-634)."""
    phi = polynomial_curve(coeffs, n).astype(np.float64)
    return np.exp(1j * phi)


def sinusoidal_curve(length: int) -> np.ndarray:
    """n(k) = (L/pi) acos(1 - 2k/L), float32 (cuda_code.cu:516-521)."""
    k = np.arange(length, dtype=np.float64)
    return ((length / math.pi) * np.arccos(1.0 - 2.0 * k / length)).astype(np.float32)


class Reference:
    """The chain of one configuration file on ``device``."""

    def __init__(self, config: dict, device):
        self.device = torch.device(device)
        acq, proc, curves = config["acq"], config["proc"], config["curves"]
        if curves["window_type"] != "hanning" or proc["interpolation"] != "cubic":
            raise ValueError("the reference implements the Hann window and cubic "
                             "k-linearization")
        if proc["fpn_mode"] not in ("off", "once") or not proc["log_scaling"]:
            raise ValueError("the reference implements FPN off or once and log scaling")
        if proc["post_background_removal"]:
            raise ValueError("post background removal is not in the reference")
        self.n = n = acq["samples_per_line"]
        self.half = n // 2
        self.ascans = acq["ascans_per_bscan"]
        self.bscans = acq["bscans_per_buffer"]
        self.proc = proc
        f64 = dict(dtype=torch.float64, device=self.device)
        curve = resample_curve(curves["resample_coeffs"], n) if proc["resampling"] else None
        if curve is not None:
            x0 = curve.astype(np.int64)
            # t in the curve's float32, then widened (cuda_code.cu:255-262)
            t = (curve - x0.astype(np.float32)).astype(np.float64)
            self.taps = [torch.as_tensor(i, device=self.device)
                         for i in (np.abs(x0 - 1), x0, x0 + 1, x0 + 2)]
            self.t = torch.as_tensor(t, **f64)
        else:
            self.taps = None
        spec = np.ones(n, np.complex128)
        if proc["windowing"]:
            spec = spec * hann_window(n, curves["window_center"],
                                      curves["window_fill_factor"]).astype(np.float64)
        if proc["dispersion"]:
            spec = spec * dispersion_phasor(curves["dispersion_coeffs"], n)
        self.spec = torch.as_tensor(spec, dtype=torch.complex128, device=self.device)
        sin = sinusoidal_curve(self.ascans)
        s0 = np.minimum(sin.astype(np.int64), self.ascans - 1)
        self.sin_i0 = torch.as_tensor(s0, device=self.device)
        self.sin_i1 = torch.as_tensor(np.minimum(s0 + 1, self.ascans - 1), device=self.device)
        self.sin_t = torch.as_tensor(
            sin.astype(np.float64) - sin.astype(np.int64), **f64)[None, :, None]

    # -- stages ---------------------------------------------------------------
    def _decode(self, raw: torch.Tensor) -> torch.Tensor:
        x = raw.to(self.device).view(torch.int16).to(torch.int32) & 0xFFFF
        if self.proc["bitshift"]:
            x = x >> 4
        return x.to(torch.float64)

    def _background(self, x: torch.Tensor) -> torch.Tensor:
        """Rolling mean over [max(0, i-W+1), min(n-1, i+W)] (cuda_code.cu:165-211)."""
        w = self.proc["rolling_average_window"]
        i = torch.arange(self.n, device=self.device)
        lo = torch.clamp(i - w + 1, min=0)
        hi = torch.clamp(i + w, max=self.n - 1)
        csum = torch.nn.functional.pad(torch.cumsum(x, dim=-1), (1, 0))
        return x - (csum[..., hi + 1] - csum[..., lo]) / (hi - lo + 1).to(torch.float64)

    def _resample(self, x: torch.Tensor) -> torch.Tensor:
        """Catmull-Rom cubic at the curve, n0 = |n1 - 1| (cuda_code.cu:264-289)."""
        y0, y1, y2, y3 = (x[..., i] for i in self.taps)
        t = self.t
        a = -y0 + 3.0 * (y1 - y2) + y3
        b = 2.0 * y0 - 5.0 * y1 + 4.0 * y2 - y3
        c = -y0 + y2
        return 0.5 * t * ((a * t + b) * t + c) + y1

    def depth_half(self, raw: torch.Tensor) -> torch.Tensor:
        """raw (..., n) -> the complex128 positive-depth half (..., n/2)
        before FPN removal."""
        x = self._decode(raw)
        if self.proc["background_removal"]:
            x = self._background(x)
        if self.taps is not None:
            x = self._resample(x)
        z = torch.fft.ifft(x * self.spec, dim=-1) * self.n  # cufft's unnormalised inverse
        return z[..., : self.half]

    def fpn_mean_line(self, raw_buffer: torch.Tensor) -> torch.Tensor:
        """The minimum-variance mean line of the first ``bscans_for_noise``
        B-scans' A-scans (cuda_code.cu:523-565), the selection tie-banded:
        every segment within FPN_TIE_EPS x mean power of the least variance
        ties, the lowest index wins."""
        nb = min(self.proc["bscans_for_noise"], self.bscans)
        lines = self.depth_half(raw_buffer[:nb]).reshape(-1, self.half)
        seg = lines.shape[0] // FPN_SEGMENTS
        used = lines[: FPN_SEGMENTS * seg].reshape(FPN_SEGMENTS, seg, self.half)
        mean = used.mean(dim=1)
        power = (used.real ** 2 + used.imag ** 2).mean(dim=1)
        var = power - (mean.real ** 2 + mean.imag ** 2)
        thresh = var.min(dim=0).values + FPN_TIE_EPS * power.mean(dim=0)
        best = torch.argmax((var <= thresh).to(torch.uint8), dim=0)
        return mean[best, torch.arange(self.half, device=self.device)]

    def _post(self, mag: torch.Tensor, b0: int, last_block: bool) -> torch.Tensor:
        if self.proc["bscan_flip"]:
            even = ((torch.arange(mag.shape[0], device=self.device) + b0) % 2 == 0)
            mag = torch.where(even[:, None, None], mag.flip(1), mag)
        if self.proc["sinusoidal_correction"]:
            f0, f1 = mag[:, self.sin_i0], mag[:, self.sin_i1]
            out = f0 + (f1 - f0) * self.sin_t
            if last_block:  # the index < samples - width guard (cuda_code.cu:499)
                out[-1, -1] = mag[-1, -1]
            mag = out
        return mag

    def buffer(self, raw: torch.Tensor, mean_line, block: int = 16):
        """Yield (first B-scan, float64 processed block) over the buffer
        ``raw`` (bscans, ascans, n), FPN removed with ``mean_line`` (None:
        FPN off)."""
        p = self.proc
        scale = 1.0 / (p["grayscale_max"] - p["grayscale_min"])
        for b0 in range(0, self.bscans, block):
            z = self.depth_half(raw[b0:b0 + block])
            if mean_line is not None:
                z = z - mean_line
            db = 10.0 * torch.log10((z.real ** 2 + z.imag ** 2) / self.half)
            mag = p["multiplicator"] * ((db - p["grayscale_min"]) * scale + p["addend"])
            yield b0, self._post(mag, b0, b0 + block >= self.bscans)
