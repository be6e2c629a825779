"""Rolling-average DC background removal.

Numerics of ``rollingAverageBackgroundRemoval``
(octproz_project/octproz/src/cuda_code.cu:165-211): for sample i of an
A-scan of length n the mean runs over ``[max(0, i-W+1), min(n-1, i+W)]``.
The window bounds depend only on the intra-line index, so the mean is an
exclusive float32 prefix sum along the line and two static gathers.  The
fold path and the prep kernels bake the same window into their operator
(kernels/fused_prep.build_prep_operator).
"""

from __future__ import annotations

import numpy as np
import torch


def rolling_average_indices(n: int, window: int):
    """Static (start, end_inclusive, count) index vectors for line length n."""
    i = np.arange(n)
    start = np.maximum(0, i - window + 1)
    end = np.minimum(n - 1, i + window)
    count = (end - start + 1).astype(np.float32)
    return start, end, count


def remove_background(x: torch.Tensor, window: int) -> torch.Tensor:
    """x: float32 (..., n) real spectra; returns x - rolling_mean(x)."""
    n = x.shape[-1]
    start, end, count = rolling_average_indices(n, window)
    csum = torch.cumsum(x, dim=-1, dtype=torch.float32)
    csum = torch.cat([torch.zeros_like(csum[..., :1]), csum], dim=-1)
    take = lambda idx: csum.index_select(-1, torch.as_tensor(idx, device=x.device))
    window_sum = take(end + 1) - take(start)
    return x - window_sum / torch.as_tensor(count, device=x.device)
