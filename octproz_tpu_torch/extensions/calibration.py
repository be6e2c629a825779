"""Calibration utilities: automatic dispersion estimation and k-linearization
curve extraction from calibration fringes.

Counterpart of ``octproz_tpu/extensions/calibration.py``, the dispersion
search rewritten in PyTorch: it runs on the device it is given (the JAX
package pins it to the host CPU, since its TPU has no complex64), each chunk
of candidates one batched ``torch.fft.ifft``.  ``extract_klin_curve`` is the
same numpy code.

Capability-equivalents of the reference's Dispersion Estimator Extension
(finds d2/d3 coefficients maximizing image sharpness) and Phase Extraction
Extension (determines the custom resampling curve for k-linearization from
the interference phase of a mirror measurement) (docs/docs/plugins.md:18-19,
30-31; the extracted curve feeds Plugin::setCustomResamplingCurveRequest,
plugin.h:84).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import pipeline
from ..curves import dispersion_phase
from ..params import AcqParams, Curves, ProcConfig

#: Candidates per batched inverse FFT (at 512 lines of 1024 samples, 128 MB
#: of complex64).
CHUNK = 32
#: The Curves fields the prep stages read without dispersion.
_PREP_FIELDS = ("resample_curve", "resample_matrix", "window")


def _sharpness_metric(intensity: torch.Tensor) -> torch.Tensor:
    """Normalized L4 focus metric: sum(I^2)^2 / sum(I)^2-style kurtosis.

    Sharper axial peaks (better dispersion compensation) concentrate energy,
    increasing the metric.  Computed per candidate: intensity (..., L, n),
    in float32 as in the JAX package (the sum of |z|^8).
    """
    i2 = intensity * intensity
    num = torch.sum(i2 * i2, dim=(-2, -1))
    den = torch.sum(i2, dim=(-2, -1)) ** 2
    return num / (den + 1e-30)


def _prep_curves(curves: Curves, device: torch.device) -> Curves:
    """``curves`` with the fields the prep stages read as tensors on
    ``device`` (a configuration that folds them into the depth operator
    keeps them as host arrays)."""
    return dataclasses.replace(curves, **{
        name: torch.as_tensor(getattr(curves, name), device=device)
        for name in _PREP_FIELDS if getattr(curves, name) is not None})


def estimate_dispersion_coeffs(
    raw: np.ndarray,
    acq: AcqParams,
    cfg: ProcConfig,
    curves: Curves,
    d2_range: Tuple[float, float] = (-100.0, 100.0),
    d3_range: Tuple[float, float] = (-100.0, 100.0),
    d3: float = 0.0,
    estimate_d3: bool = True,
    n_grid: int = 41,
    refine_iters: int = 2,
    max_lines: int = 512,
    min_depth_bin: int = 5,
    *,
    device,
) -> Tuple[float, float, float]:
    """Estimate BOTH d2 (quadratic) and d3 (cubic) dispersion coefficients
    maximizing image sharpness -- the full capability of the reference's
    Dispersion Estimator extension (docs/docs/plugins.md:18-19).

    raw: one uint buffer (bscans, ascans, samples).  Uses the pipeline's
    prep (resample x window via ``curves``, torch ops) once on ``device``,
    then evaluates all phase candidates with batched inverse FFTs there.
    Search: coarse-to-fine JOINT 2-D grid zoom -- the sharpness landscape is
    a flat ridge (a cubic phase error is almost compensable by quadratic +
    linear, which only shifts the peak) with secondary lobes along each
    axis, so 1-D coordinate descent stalls off-ridge; a dense joint grid
    (n_grid x n_grid, then ``refine_iters`` zooms of a 15 x 15 grid around
    the argmax) finds the true maximum.  Candidates are evaluated in chunks
    of :data:`CHUNK` to bound device memory; total cost is (n_grid^2 +
    225*refine_iters) IFFTs over ``max_lines`` lines.  Returns (best_d2,
    best_d3, best_metric).  ``d3`` is the starting value; with
    ``estimate_d3=False`` it stays fixed and only d2 is searched (1-D
    refined grid).
    """
    device = torch.device(device)
    # DC removal is mandatory here: a DC offset chirped by the candidate
    # phasor concentrates at shallow depths and games the sharpness metric.
    prep_cfg = dataclasses.replace(cfg, dispersion=False, use_pallas_prep=False,
                                   background_removal=True)
    n = acq.samples_per_line
    half = acq.output_ascan_length
    with torch.no_grad():
        raw_t = torch.from_numpy(np.ascontiguousarray(raw)).to(device)
        spectra = pipeline.prep_spectra(raw_t, _prep_curves(curves, device), acq, prep_cfg)
        lines = spectra.reshape(-1, n)[:max_lines]

    def eval_metrics(pairs: Sequence[Tuple[float, float]]) -> np.ndarray:
        """Sharpness for a list of (d2, d3) candidates, :data:`CHUNK` at a
        time."""
        out = []
        for i in range(0, len(pairs), CHUNK):
            phases = torch.from_numpy(np.stack([
                dispersion_phase(acq, 0.0, 0.0, c2, c3)
                for c2, c3 in pairs[i:i + CHUNK]])).to(device)
            with torch.no_grad():
                z = torch.fft.ifft(lines[None, :, :] * phases[:, None, :], dim=-1)
                # exclude the DC / shallow bins, which dominate the metric
                # but carry no dispersion information
                intensity = z[..., min_depth_bin:half].abs() ** 2
                out.append(_sharpness_metric(intensity).cpu().numpy())
        return np.concatenate(out)

    best_d2, best_d3 = 0.0, float(d3)
    best_metric = -np.inf

    if not estimate_d3:
        # 1-D refined grid over d2 with d3 fixed
        lo, hi = d2_range
        for _ in range(max(refine_iters, 1)):
            cand = np.linspace(lo, hi, n_grid)
            metrics = eval_metrics([(c, best_d3) for c in cand])
            k = int(np.argmax(metrics))
            best_d2, best_metric = float(cand[k]), float(metrics[k])
            span = (hi - lo) / (n_grid - 1)
            lo, hi = best_d2 - 2 * span, best_d2 + 2 * span
        return best_d2, best_d3, best_metric

    # joint coarse-to-fine 2-D zoom
    (lo2, hi2), (lo3, hi3) = d2_range, d3_range
    for it in range(max(refine_iters, 1) + 1):
        nn = n_grid if it == 0 else 15
        c2s = np.linspace(lo2, hi2, nn)
        c3s = np.linspace(lo3, hi3, nn)
        pairs = [(c2, c3) for c2 in c2s for c3 in c3s]
        metrics = eval_metrics(pairs)
        k = int(np.argmax(metrics))
        (best_d2, best_d3), best_metric = pairs[k], float(metrics[k])
        s2 = (hi2 - lo2) / (nn - 1)
        s3 = (hi3 - lo3) / (nn - 1)
        lo2, hi2 = best_d2 - 2 * s2, best_d2 + 2 * s2
        lo3, hi3 = best_d3 - 2 * s3, best_d3 + 2 * s3
    return float(best_d2), float(best_d3), best_metric


class DispersionEstimator:
    """Stateful wrapper: feed raw buffers, call :meth:`estimate` ->
    (d2, d3, metric).

    The reference extension live-tunes d2 AND d3 against the running stream
    (docs/docs/plugins.md:18-19) and pushes results back over
    setDispCompCoeffsRequest; here the estimate is returned (and can be
    applied via FdOctModel.set_dispersion_coeffs).  The search runs on
    ``device``.
    """

    def __init__(self, acq: AcqParams, cfg: ProcConfig, curves: Curves, *, device):
        self.acq = acq
        self.cfg = cfg
        self.curves = curves
        self.device = torch.device(device)
        self.last_raw: Optional[np.ndarray] = None

    def feed(self, raw: np.ndarray) -> None:
        self.last_raw = np.asarray(raw)

    def estimate(self, **kw) -> Tuple[float, float, float]:
        if self.last_raw is None:
            raise RuntimeError("no raw buffer fed yet")
        return estimate_dispersion_coeffs(self.last_raw, self.acq, self.cfg,
                                          self.curves, **kw, device=self.device)


def extract_klin_curve(
    calibration_spectra: np.ndarray,
    smooth_bins: int = 0,
    band: Optional[Tuple[int, int]] = None,
) -> np.ndarray:
    """Determine the k-linearization resampling curve from mirror fringes.

    calibration_spectra: float (n_lines, n) raw spectra of a single strong
    reflector (or (n,) for one line).  Procedure (Phase Extraction analog):

      1. average lines, remove DC
      2. analytic signal via one-sided FFT (optionally band-limited around
         the dominant fringe frequency to isolate the reflector)
      3. unwrap the interference phase phi(x)
      4. invert the monotone phase: curve[j] = x where
         phi(x) = phi_min + j * (phi_max - phi_min) / (n - 1)

    Sampling the raw spectrum at ``curve`` positions makes the phase exactly
    linear in the output index -- i.e. uniform in k.  Returns float32 (n,),
    clamped to [0, n - 3] like the reference's curves
    (octalgorithmparameters.cpp:167).
    """
    spec = np.asarray(calibration_spectra, np.float64)
    if spec.ndim == 1:
        spec = spec[None, :]
    n = spec.shape[-1]
    line = spec.mean(axis=0)
    line = line - line.mean()

    f = np.fft.fft(line)
    half = np.zeros_like(f)
    if band is None:
        # keep the dominant positive-frequency lobe neighborhood
        mag = np.abs(f[1:n // 2])
        peak = 1 + int(np.argmax(mag))
        width = max(peak // 2, 8)
        b0, b1 = max(peak - width, 1), min(peak + width + 1, n // 2)
    else:
        b0, b1 = band
    half[b0:b1] = f[b0:b1]
    analytic = np.fft.ifft(half)

    phase = np.unwrap(np.angle(analytic))
    if phase[-1] < phase[0]:
        phase = -phase  # enforce increasing phase
    # strictly monotone guard for interpolation
    phase = np.maximum.accumulate(phase)

    targets = np.linspace(phase[0], phase[-1], n)
    curve = np.interp(targets, phase, np.arange(n, dtype=np.float64))
    if smooth_bins > 1:
        kernel = np.ones(smooth_bins) / smooth_bins
        pad = smooth_bins // 2
        padded = np.pad(curve, pad, mode="edge")
        curve = np.convolve(padded, kernel, mode="same")[pad:pad + n]
        curve[0], curve[-1] = 0.0, n - 1.0
    return np.clip(curve, 0.0, n - 3.0).astype(np.float32)
