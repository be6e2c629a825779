"""Rolling-average DC background removal: the static window geometry.

Numerics of ``rollingAverageBackgroundRemoval``
(octproz_project/octproz/src/cuda_code.cu:165-211): for sample i of an
A-scan of length n the mean runs over ``[max(0, i-W+1), min(n-1, i+W)]``.
The folded-GEMM path bakes this window into its operator
(kernels/fused_prep.build_prep_operator), so only the index vectors are
needed here.
"""

from __future__ import annotations

import numpy as np


def rolling_average_indices(n: int, window: int):
    """Static (start, end_inclusive, count) index vectors for line length n."""
    i = np.arange(n)
    start = np.maximum(0, i - window + 1)
    end = np.minimum(n - 1, i + window)
    count = (end - start + 1).astype(np.float32)
    return start, end, count
