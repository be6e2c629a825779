"""k-linearization: a static banded operator (host numpy), or per-sample
gathers (torch).

The fractional source position ``curve[j]`` depends only on the output
column j, so every interpolator of the reference
(octproz_project/octproz/src/cuda_code.cu:213-326) is a banded matrix R with
R[j, t] = weight of input sample t in output sample j.  R is built once per
curve update and folded into the depth or prep operator, or applied as a
product (:func:`apply_matmul`); :func:`apply_gather` interpolates directly.

Boundary rules kept from the reference formulation:
* cubic: ``n0 = abs(n1 - 1)``, so for n1 == 0 the first tap aliases to
  input sample 1;
* lanczos: each tap index is clamped to the A-scan ([0, n-1], edge
  replication).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..params import Interpolation


def _lanczos8_kernel(x: np.ndarray) -> np.ndarray:
    """Lanczos a=8 kernel: sinc(x) * sinc(x/8), 1 at x == 0 (cuda_code.cu:297-302)."""
    ax = np.abs(x).astype(np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        sinc_x = np.sin(math.pi * ax) / (math.pi * ax)
        sinc_x8 = np.sin(math.pi / 8.0 * ax) / (math.pi / 8.0 * ax)
    w = sinc_x * sinc_x8
    return np.where(ax < 1e-5, 1.0, w)


def interpolation_taps(curve: np.ndarray, mode: Interpolation):
    """Per-output-sample tap indices and weights.

    Returns (indices int32[n_out, taps], weights float32[n_out, taps]).
    Indices may exceed [0, n-1] only for LANCZOS; callers clamp.
    """
    curve = np.asarray(curve, dtype=np.float32)
    x0 = curve.astype(np.int32)  # truncation; curve is clamped >= 0
    t = (curve - x0.astype(np.float32)).astype(np.float64)

    if mode == Interpolation.LINEAR:
        idx = np.stack([x0, x0 + 1], axis=1)
        w = np.stack([1.0 - t, t], axis=1)
    elif mode == Interpolation.QUADRATIC:
        # f = f0 + (f1-f0)t + (f2-2f1+f0)/2 * t(t-1)
        q = t * (t - 1.0) / 2.0
        idx = np.stack([x0, x0 + 1, x0 + 2], axis=1)
        w = np.stack([1.0 - t + q, t - 2.0 * q, q], axis=1)
    elif mode == Interpolation.CUBIC:
        # Catmull-Rom expanded to per-tap weights; n0 = abs(n1 - 1) edge trick.
        n1 = x0
        n0 = np.abs(n1 - 1)
        idx = np.stack([n0, n1, n1 + 1, n1 + 2], axis=1)
        t2, t3 = t * t, t * t * t
        w = np.stack(
            [
                0.5 * (-t3 + 2.0 * t2 - t),
                0.5 * (3.0 * t3 - 5.0 * t2 + 2.0),
                0.5 * (-3.0 * t3 + 4.0 * t2 + t),
                0.5 * (t3 - t2),
            ],
            axis=1,
        )
    elif mode == Interpolation.LANCZOS:
        offsets = np.arange(-7, 9)  # 16 taps, i = -7..8 (cuda_code.cu:319)
        idx = x0[:, None] + offsets[None, :]
        w = _lanczos8_kernel(curve[:, None].astype(np.float64) - idx.astype(np.float64))
    else:
        raise ValueError(f"unknown interpolation mode {mode}")
    return idx.astype(np.int32), w.astype(np.float32)


def build_resample_matrix(curve: np.ndarray, mode: Interpolation,
                          n_in: int | None = None) -> np.ndarray:
    """Dense (n_out, n_in) interpolation operator for ``out = R @ line``.

    Taps outside [0, n_in-1] (possible for LANCZOS near the edges) are
    clamped to the edge sample (edge replication).
    """
    curve = np.asarray(curve, dtype=np.float32)
    n_out = curve.shape[0]
    if n_in is None:
        n_in = n_out
    idx, w = interpolation_taps(curve, mode)
    idx = np.clip(idx, 0, n_in - 1)
    r = np.zeros((n_out, n_in), dtype=np.float32)
    rows = np.repeat(np.arange(n_out), idx.shape[1])
    np.add.at(r, (rows, idx.reshape(-1)), w.reshape(-1))
    return r


def apply_matmul(x: torch.Tensor, resample_matrix: torch.Tensor,
                 precision: str = "default") -> torch.Tensor:
    """Resample spectra by the dense operator: x (..., n_in) @ R.T.

    ``precision`` is a rung (``fused_prep.operator_rung``): "high"/"highest"
    run the same bf16 operand-split passes as the kernels
    (kernels/fused_prep._dot_split); "default" is one float32 product;
    "bfloat16" (``compute_dtype="bfloat16"``) rounds x and R.T to bf16 and
    takes one float32 product of them, as the JAX package's bf16 matmul
    with ``preferred_element_type=float32`` does."""
    from ..kernels.fused_prep import BF16, _SPLIT_PARTS, _dot_bf16, _dot_split, _split_bf16

    m = resample_matrix.T.to(torch.float32)
    if precision == BF16:
        return _dot_bf16(x.to(torch.float32), m)
    parts = _SPLIT_PARTS.get(precision)
    if parts:
        return _dot_split(x.to(torch.float32), _split_bf16(m, parts))
    return torch.matmul(x.to(torch.float32), m)


def apply_gather(x: torch.Tensor, curve: torch.Tensor,
                 mode: Interpolation) -> torch.Tensor:
    """Per-sample gathers along the last axis at the fractional positions
    ``curve`` (float32 (n_out,)), in float32, with the tap geometry of
    :func:`interpolation_taps`; every tap index is clamped to the line."""
    n = x.shape[-1]
    x0 = curve.to(torch.int32)
    t = curve - x0.to(torch.float32)

    def take(i):
        return x.index_select(-1, torch.clamp(i, 0, n - 1))

    if mode == Interpolation.LINEAR:
        f0, f1 = take(x0), take(x0 + 1)
        return f0 + (f1 - f0) * t
    if mode == Interpolation.QUADRATIC:
        f0, f1, f2 = take(x0), take(x0 + 1), take(x0 + 2)
        b1 = f1 - f0
        b2 = ((f2 - f1) - b1) / 2.0
        return f0 + b1 * t + b2 * t * (t - 1.0)
    if mode == Interpolation.CUBIC:
        n1 = x0
        n0 = torch.abs(n1 - 1)
        y0, y1, y2, y3 = take(n0), take(n1), take(n1 + 1), take(n1 + 2)
        a = -y0 + 3.0 * (y1 - y2) + y3
        b = 2.0 * y0 - 5.0 * y1 + 4.0 * y2 - y3
        c = -y0 + y2
        return 0.5 * t * ((a * t + b) * t + c) + y1
    if mode == Interpolation.LANCZOS:
        pi = float(np.float32(math.pi))  # float32 pi, as the JAX package's
        acc = torch.zeros_like(take(x0))
        for i in range(-7, 9):
            tap = x0 + i
            ax = torch.abs(curve - tap.to(torch.float32))
            sinc_x = torch.sin(pi * ax) / (pi * ax)
            sinc_x8 = torch.sin(pi / 8 * ax) / (pi / 8 * ax)
            w = torch.where(ax < 1e-5, 1.0, sinc_x * sinc_x8)
            acc = acc + take(tap) * w
        return acc
    raise ValueError(f"unknown interpolation mode {mode}")
