"""Quantize processed float volumes (0..1) for host streaming and recording.

Numerics of ``floatToOutput`` (octproz_project/octproz/src/cuda_code.cu:
943-967), as in ``octproz_tpu/ops/quantize.py``: saturate to [0, 1], scale
by the bit depth's max code, truncate to unsigned integers of the smallest
container (uint8 / uint16 / uint32).  torch implements casts to uint16 and
uint32 but little arithmetic on them, so the clamp and the scale run in
float32 and only the result is cast.
"""

from __future__ import annotations

import numpy as np
import torch

# The reference's 32-bit scale 4294967295 rounds to 2^32 in float32 and
# relies on CUDA's saturating float->uint cast; float32 cannot represent
# 2^32-1, so the scale is the largest float32 below 2^32 (2^32-256), as in
# the JAX package.  Maximum relative deviation 6e-8 at full scale.
_SCALES = (
    (8, 255.0, torch.uint8),
    (10, 1023.0, torch.uint16),
    (12, 4095.0, torch.uint16),
    (16, 65535.0, torch.uint16),
    (24, 16777215.0, torch.uint32),
    (32, 4294967040.0, torch.uint32),
)


def _scale(bit_depth: int):
    for limit, scale, dtype in _SCALES:
        if bit_depth <= limit:
            return scale, dtype
    return _SCALES[-1][1:]


def output_dtype(bit_depth: int) -> torch.dtype:
    return _scale(bit_depth)[1]


def quantize(x: torch.Tensor, bit_depth: int) -> torch.Tensor:
    """float (0..1, saturated) -> unsigned integer codes (same shape, same
    device)."""
    scale, dtype = _scale(bit_depth)
    return (x.to(torch.float32).clamp(0.0, 1.0) * scale).to(dtype)


def code_max(bit_depth: int) -> float:
    """The full-scale CODE of a quantized stream (what :func:`quantize`
    multiplied by) -- not the container dtype's max: 12-bit codes ride in
    uint16, so normalizing by ``np.iinfo(dtype).max`` would be 16x dark."""
    return _scale(bit_depth)[0]


def dequantize(x, bit_depth: int) -> np.ndarray:
    """Quantized codes (or float passthrough) on the host -> float32 in
    [0, 1]."""
    out = np.asarray(x, np.float32)
    if np.issubdtype(np.asarray(x).dtype, np.integer):
        out = out / np.float32(code_max(bit_depth))
    return out
