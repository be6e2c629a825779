"""B-scan fidelity metrics: PSNR / SSIM against a reference volume.

Numpy copy of ``octproz_tpu/utils/fidelity.py`` (which cannot be imported
without JAX): the harness that compares a processed volume with a reference
output -- the checked-in golden pair (tests/data/golden_pair_*) or a
reference-produced volume -- and reports PSNR / SSIM / RMSE overall and per
B-scan.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


_DTYPES = {
    "float32": np.float32,
    "float64": np.float64,
    "uint8": np.uint8,
    "uint16": np.uint16,
    "uint32": np.uint32,
}


def load_volume(path: str, shape: Tuple[int, int, int],
                dtype: str = "float32", normalize: bool = True) -> np.ndarray:
    """Read a .raw volume as float.  Integer dtypes are scaled to [0, 1]
    (the inverse of floatToOutput quantization, cuda_code.cu:943-967) when
    ``normalize`` is set."""
    if dtype not in _DTYPES:
        raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, got {dtype}")
    np_dtype = _DTYPES[dtype]
    want = int(np.prod(shape))
    data = np.fromfile(path, dtype=np_dtype)
    if data.size < want:
        raise ValueError(f"{path}: has {data.size} {dtype} samples, "
                         f"shape {shape} needs {want}")
    vol = data[:want].reshape(shape).astype(np.float64)
    if normalize and np.issubdtype(np_dtype, np.integer):
        vol /= float(np.iinfo(np_dtype).max)
    return vol


def psnr(got: np.ndarray, ref: np.ndarray,
         data_range: Optional[float] = None) -> float:
    """Peak signal-to-noise ratio in dB.  ``data_range`` defaults to the
    reference's dynamic range."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    if got.shape != ref.shape:
        raise ValueError(f"shape mismatch: {got.shape} vs {ref.shape}")
    if data_range is None:
        data_range = float(ref.max() - ref.min()) or 1.0
    mse = float(np.mean((got - ref) ** 2))
    if mse == 0.0:
        return float("inf")
    return 10.0 * np.log10(data_range ** 2 / mse)


def _box_filter(img: np.ndarray, win: int) -> np.ndarray:
    """Mean filter with a win x win window (valid region) via integral image."""
    ii = np.cumsum(np.cumsum(img, axis=0), axis=1)
    ii = np.pad(ii, ((1, 0), (1, 0)))
    s = (ii[win:, win:] - ii[:-win, win:] - ii[win:, :-win] + ii[:-win, :-win])
    return s / (win * win)


def ssim(got: np.ndarray, ref: np.ndarray, data_range: Optional[float] = None,
         win: int = 7, k1: float = 0.01, k2: float = 0.03) -> float:
    """Mean structural similarity of one image (2-D), uniform win x win
    window (Wang et al. 2004 with a box window instead of the Gaussian)."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    if got.shape != ref.shape or got.ndim != 2:
        raise ValueError(f"need matching 2-D images, got {got.shape} / {ref.shape}")
    if min(got.shape) < win:
        win = max(min(got.shape) // 2 * 2 - 1, 1)
    if data_range is None:
        data_range = float(ref.max() - ref.min()) or 1.0
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu_x = _box_filter(got, win)
    mu_y = _box_filter(ref, win)
    xx = _box_filter(got * got, win) - mu_x ** 2
    yy = _box_filter(ref * ref, win) - mu_y ** 2
    xy = _box_filter(got * ref, win) - mu_x * mu_y
    # unbiased variance correction as in the standard implementation
    n = win * win
    cov_norm = n / (n - 1) if n > 1 else 1.0
    xx, yy, xy = xx * cov_norm, yy * cov_norm, xy * cov_norm
    num = (2 * mu_x * mu_y + c1) * (2 * xy + c2)
    den = (mu_x ** 2 + mu_y ** 2 + c1) * (xx + yy + c2)
    return float(np.mean(num / den))


@dataclasses.dataclass
class CompareResult:
    """Volume comparison summary (all dB values use the reference's range)."""

    psnr_db: float
    min_bscan_psnr_db: float
    worst_bscan: int
    mean_ssim: float
    min_ssim: float
    rmse: float
    data_range: float
    n_bscans: int

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        return {k: (round(v, 4) if isinstance(v, float) else v)
                for k, v in d.items()}


def compare_volumes(got: np.ndarray, ref: np.ndarray,
                    data_range: Optional[float] = None,
                    clip: Optional[Tuple[float, float]] = None) -> CompareResult:
    """Full fidelity report between two (bscans, ascans, depth) volumes.

    ``clip`` (e.g. (0, 1)) clips BOTH volumes first — the reference
    pipeline's displayed/streamed output saturates to [0, 1]
    (floatToOutput, cuda_code.cu:956-961), so out-of-range log-floor values
    (-inf from empty voxels) must not dominate the MSE.
    """
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    if got.shape != ref.shape:
        raise ValueError(f"shape mismatch: {got.shape} vs {ref.shape}")
    if clip is not None:
        got = np.clip(got, *clip)
        ref = np.clip(ref, *clip)
    if data_range is None:
        data_range = float(ref.max() - ref.min()) or 1.0

    per_psnr = [psnr(g, r, data_range) for g, r in zip(got, ref)]
    per_ssim = [ssim(g, r, data_range) for g, r in zip(got, ref)]
    worst = int(np.argmin(per_psnr))
    return CompareResult(
        psnr_db=psnr(got, ref, data_range),
        min_bscan_psnr_db=float(per_psnr[worst]),
        worst_bscan=worst,
        mean_ssim=float(np.mean(per_ssim)),
        min_ssim=float(np.min(per_ssim)),
        rmse=float(np.sqrt(np.mean((got - ref) ** 2))),
        data_range=data_range,
        n_bscans=got.shape[0],
    )
