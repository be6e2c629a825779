"""Host-side LUT generation: resampling polynomial, spectral windows,
dispersion phase, sinusoidal-scan curve, and the folded depth operator.

Numpy copies of ``octproz_tpu/curves.py`` (reference: polynomial.cpp,
windowfunction.cpp, octalgorithmparameters.cpp:141-249).  Curves are tiny,
so they are generated on the host; :func:`make_curves` places the fields a
configuration consumes on an explicit torch device.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .ops.resample import build_resample_matrix
from .params import AcqParams, Curves, ProcConfig, WindowType


# ---------------------------------------------------------------------------
# Polynomial resampling / dispersion curves
# ---------------------------------------------------------------------------

def polynomial_curve(coeffs: Sequence[float], size: int) -> np.ndarray:
    """Evaluate ``c0 + c1*x + c2*x^2 + c3*x^3`` at x = 0..size-1 (float32,
    Horner; polynomial.cpp:108-116)."""
    x = np.arange(size, dtype=np.float32)
    result = np.zeros(size, dtype=np.float32)
    for c in reversed(list(coeffs)):
        result = result * x + np.float32(c)
    return result.astype(np.float32)


def normalize_poly_coeffs(c0: float, c1: float, c2: float, c3: float, size: int):
    """GUI-style coefficients -> per-sample coefficients: c1, c2, c3 are
    divided by (N-1), (N-1)^2, (N-1)^3 (octalgorithmparameters.cpp:148-157)."""
    n1 = float(size - 1)
    return (c0, c1 / n1, c2 / n1**2, c3 / n1**3)


def resample_curve(
    acq: AcqParams,
    c0: float = 0.0,
    c1: float = 0.0,
    c2: float = 0.0,
    c3: float = 0.0,
    custom: Optional[np.ndarray] = None,
) -> np.ndarray:
    """k-linearization resampling curve, clamped to [0, N-3]
    (octalgorithmparameters.cpp:167).  Identity is coeffs (0, N-1, 0, 0)."""
    n = acq.samples_per_line
    if custom is not None:
        curve = np.asarray(custom, dtype=np.float32).copy()
        if curve.shape != (n,):
            raise ValueError(f"custom resample curve must have shape ({n},)")
    else:
        coeffs = normalize_poly_coeffs(c0, c1, c2, c3, n)
        curve = polynomial_curve(coeffs, n)
    return np.clip(curve, 0.0, float(n - 3)).astype(np.float32)


def identity_resample_curve(acq: AcqParams) -> np.ndarray:
    """Identity mapping (octalgorithmparameters.cpp:171-177)."""
    return resample_curve(acq, 0.0, float(acq.samples_per_line - 1), 0.0, 0.0)


def dispersion_phase(
    acq: AcqParams,
    d0: float = 0.0,
    d1: float = 0.0,
    d2: float = 0.0,
    d3: float = 0.0,
    factor: float = 1.0,
    direction: int = 1,
) -> np.ndarray:
    """Dispersion-compensation phasor ``exp(+i * direction * factor * phi(x))``
    (octalgorithmparameters.cpp:206-232, cuda_code.cu:624-634)."""
    n = acq.samples_per_line
    coeffs = normalize_poly_coeffs(d0, d1, d2, d3, n)
    phi = polynomial_curve(coeffs, n).astype(np.float32) * np.float32(factor)
    re = np.cos(phi, dtype=np.float32)
    im = np.sin(phi, dtype=np.float32) * np.float32(direction)
    return (re + 1j * im).astype(np.complex64)


# ---------------------------------------------------------------------------
# Window functions  (windowfunction.cpp:96-331)
# ---------------------------------------------------------------------------
#
# The window occupies ``width = int(fill_factor * size)`` samples centred at
# ``int(center * size)``; positions are normalised to
# xi_norm = (i - min_pos) / (width - 1) and the window is zero outside
# xi_norm in (0.0001, 0.999].  Gauss ignores the width gate.

def _window_geometry(center: float, fill_factor: float, size: int):
    center = min(max(center, 0.0), 1.0)  # windowfunction.cpp:65-73
    # width >= 2: a tiny fill factor would otherwise divide by width-1 <= 0
    width = max(int(fill_factor * size), 2)
    center_i = int(center * size)
    min_pos = center_i - width // 2
    max_pos = min_pos + width
    if max_pos < min_pos:
        min_pos, max_pos = max_pos, min_pos
    i = np.arange(size, dtype=np.float64)
    xi_norm = (i - min_pos) / (float(width) - 1.0)
    in_support = (xi_norm <= 0.999) & (xi_norm >= 0.0001)
    return xi_norm, in_support


def _hanning(center, fill, size):
    x, ok = _window_geometry(center, fill, size)
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * x))
    return np.where(ok, w, 0.0)


def _sine(center, fill, size):
    x, ok = _window_geometry(center, fill, size)
    return np.where(ok, np.sin(np.pi * x), 0.0)


def _lanczos_window(center, fill, size):
    x, ok = _window_geometry(center, fill, size)
    arg = 2.0 * x - 1.0
    w = np.where(arg == 0.0, 1.0, np.sinc(arg))
    return np.where(ok, w, 0.0)


def _rectangular(center, fill, size):
    _, ok = _window_geometry(center, fill, size)
    return np.where(ok, 1.0, 0.0)


def _flattop(center, fill, size):
    # 5-term flat-top coefficients, windowfunction.cpp:235-239
    a = (0.215578948, 0.416631580, 0.277263158, 0.083578947, 0.006947368)
    x, ok = _window_geometry(center, fill, size)
    w = (a[0]
         - a[1] * np.cos(2.0 * np.pi * x)
         + a[2] * np.cos(4.0 * np.pi * x)
         - a[3] * np.cos(6.0 * np.pi * x)
         + a[4] * np.cos(8.0 * np.pi * x))
    return np.where(ok, w, 0.0)


def _gauss(center, fill, size):
    # No width gating; normalised by (size-1) then divided by the fill
    # factor (windowfunction.cpp:165-172).
    center = min(max(center, 0.0), 1.0)
    center_i = int(center * size)
    i = np.arange(size, dtype=np.float64)
    fill = max(fill, 2.0 / max(size, 2))  # same width>=2 floor as above
    xi_norm = ((i - center_i) / (float(size) - 1.0)) / fill
    return np.exp(-10.0 * xi_norm**2)


def _taylor(center, fill, size, nbar: int = 7, sidelobe_db: float = -50.0):
    # Taylor taper (windowfunction.cpp:255-331); out-of-support samples map
    # to the post-normalisation minimum, as in the reference.
    x, ok = _window_geometry(center, fill, size)
    eta = 10.0 ** (-sidelobe_db / 20.0)
    a = np.arccosh(eta) / np.pi
    a2 = a * a
    nbarf = float(nbar)
    sigma2 = nbarf**2 / (a2 + (nbarf - 0.5) ** 2)
    w = np.zeros(size, dtype=np.float64)
    for m in range(1, nbar):
        mf = float(m)
        numerator = 1.0
        denominator = 1.0
        for nn in range(1, nbar):
            nf = float(nn)
            numerator *= 1.0 - ((mf * mf) / sigma2) / (a2 + (nf - 0.5) ** 2)
            if nn != m:
                denominator *= 1.0 - (mf * mf) / (nf * nf)
        fm = ((-1.0) ** m) * numerator / denominator
        w += fm * np.cos(mf * 2.0 * np.pi * x)
    valid = w[ok]
    if valid.size == 0:
        return np.zeros(size, dtype=np.float64)
    lo, hi = valid.min(), w.max()
    w = np.where(ok, w, lo)
    return (w - lo) / (hi - lo)


_WINDOW_FNS = {
    WindowType.HANNING: _hanning,
    WindowType.GAUSS: _gauss,
    WindowType.SINE: _sine,
    WindowType.LANCZOS: _lanczos_window,
    WindowType.RECTANGULAR: _rectangular,
    WindowType.FLATTOP: _flattop,
    WindowType.TAYLOR: _taylor,
}


def window_curve(
    window_type: WindowType,
    size: int,
    center: float = 0.5,
    fill_factor: float = 1.0,
) -> np.ndarray:
    """Spectral window LUT (float32); reference defaults center=0.5 fill=1.0."""
    if size < 2:
        raise ValueError("window size must be >= 2")
    w = _WINDOW_FNS[window_type](center, fill_factor, size)
    return np.asarray(w, dtype=np.float32)


# ---------------------------------------------------------------------------
# Sinusoidal-scan correction curve  (cuda_code.cu:516-521)
# ---------------------------------------------------------------------------

def sinusoidal_scan_curve(ascans_per_bscan: int) -> np.ndarray:
    """n(k) = (L/pi) * acos(1 - 2k/L) for k = 0..L-1 (float32)."""
    length = ascans_per_bscan
    k = np.arange(length, dtype=np.float64)
    curve = (length / math.pi) * np.arccos(1.0 - 2.0 * k / length)
    return curve.astype(np.float32)


# ---------------------------------------------------------------------------
# The Curves record
# ---------------------------------------------------------------------------

def consumed_fields(cfg: ProcConfig) -> Tuple[str, ...]:
    """Names of the Curves fields the step for ``cfg`` reads; only these
    are placed on the device."""
    used = []
    if cfg.fft_via_matmul:
        used += ["depth_op_re", "depth_op_im"]
    elif cfg.use_pallas_prep:
        used.append("prep_operator")
        if cfg.dispersion:
            used.append("phase")
    else:
        if cfg.resampling:
            used.append("resample_matrix" if cfg.resample_via_matmul
                        else "resample_curve")
        if cfg.windowing:
            used.append("window")
        if cfg.dispersion:
            used.append("phase")
    if cfg.sinusoidal_correction:
        used.append("sinusoidal_curve")
    if cfg.post_background_removal:
        used.append("post_background")
    return tuple(used)


def make_curves(
    acq: AcqParams,
    cfg: ProcConfig,
    resample_coeffs: Sequence[float] = (0.0, 0.0, 0.0, 0.0),
    dispersion_coeffs: Sequence[float] = (0.0, 0.0, 0.0, 0.0),
    window_type: WindowType = WindowType.HANNING,
    window_center: float = 0.5,
    window_fill_factor: float = 1.0,
    custom_resample_curve: Optional[np.ndarray] = None,
    post_background: Optional[np.ndarray] = None,
    *,
    device,
) -> Curves:
    """Build all LUTs a configuration needs.

    Fields named by :func:`consumed_fields` become tensors on ``device``;
    everything else stays a host numpy array.  With ``fft_via_matmul``,
    ``depth_parts`` holds the depth operator split for
    ``cfg.matmul_precision`` on ``device``; where the prep kernels consume
    the prep operator, ``prep_parts`` holds it split the same way.
    """
    from .kernels.fused_prep import (_operator_parts, build_depth_operator,
                                     build_prep_operator)

    used = consumed_fields(cfg)

    def place(name, np_arr):
        return torch.from_numpy(np.ascontiguousarray(np_arr)).to(device) \
            if name in used else np_arr

    n = acq.samples_per_line
    rc = rm = win = phase = sin_curve = post_bg = prep_op = prep_parts = None
    rm_np = win_np = None
    if cfg.resampling:
        rc_np = resample_curve(acq, *resample_coeffs, custom=custom_resample_curve)
        rc = place("resample_curve", rc_np)
        if cfg.resample_via_matmul or cfg.use_pallas_prep or cfg.fft_via_matmul:
            rm_np = build_resample_matrix(rc_np, cfg.interpolation)
            rm = place("resample_matrix", rm_np)
    if cfg.windowing:
        win_np = window_curve(window_type, n, window_center, window_fill_factor)
        win = place("window", win_np)
    if cfg.use_pallas_prep:
        prep_op = place("prep_operator",
                        build_prep_operator(acq, cfg, rm_np, win_np))
        if "prep_operator" in used:
            prep_parts = _operator_parts(prep_op, cfg.matmul_precision)
    dop_re = dop_im = depth_parts = None
    phase_np = (np.asarray(dispersion_phase(acq, *dispersion_coeffs))
                if cfg.dispersion else None)
    if cfg.fft_via_matmul:
        re_np, im_np = build_depth_operator(acq, cfg, rm_np, win_np, phase_np)
        dop_re, dop_im = place("depth_op_re", re_np), place("depth_op_im", im_np)
        depth_parts = (_operator_parts(dop_re, cfg.matmul_precision),
                       _operator_parts(dop_im, cfg.matmul_precision))
    if cfg.dispersion:
        phase = place("phase", phase_np)
    if cfg.sinusoidal_correction:
        sin_curve = place("sinusoidal_curve",
                          sinusoidal_scan_curve(acq.ascans_per_bscan))
    if cfg.post_background_removal:
        if post_background is None:
            post_bg = place("post_background",
                            np.zeros((acq.output_ascan_length,), np.float32))
        else:
            post_bg = place("post_background",
                            np.asarray(post_background, dtype=np.float32))
    return Curves(
        resample_curve=rc,
        resample_matrix=rm,
        prep_operator=prep_op,
        depth_op_re=dop_re,
        depth_op_im=dop_im,
        window=win,
        phase=phase,
        sinusoidal_curve=sin_curve,
        post_background=post_bg,
        depth_parts=depth_parts,
        prep_parts=prep_parts,
    )
