"""Raw-sample decode: integer acquisition samples -> float32.

Numerics of the reference's input conversion kernels
(octproz_project/octproz/src/cuda_code.cu:109-147): a plain unsigned-int to
float cast for 8/16/32-bit containers; with ``bitshift`` 8- and 16-bit
containers are shifted right by 4 (12-bit samples in 16-bit words) and the
32-bit path is divided by 2^32 instead.

8- and 16-bit containers go through int32 before the shift: torch
implements few operators for ``uint16``/``uint32`` (no right shift), and
int32 holds every such sample exactly.
"""

from __future__ import annotations

import torch


def decode(raw: torch.Tensor, bit_depth: int, bitshift: bool = False) -> torch.Tensor:
    """Decode an unsigned-integer sample tensor to float32 (same shape).

    ``raw`` has the container dtype implied by ``bit_depth``
    (uint8 / uint16 / uint32, see AcqParams.raw_dtype).
    """
    if bit_depth <= 16:
        x = raw.to(torch.int32)
        if bitshift:
            x = x >> 4
        return x.to(torch.float32)
    x = raw.to(torch.float32)
    if bitshift:
        # cuda_code.cu:144 -- 32-bit bitshift path scales to [0, 1)
        return x / 4294967296.0
    return x
