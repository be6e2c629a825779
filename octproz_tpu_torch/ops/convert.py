"""Raw-sample decode: integer acquisition samples -> float32.

Numerics of the reference's input conversion kernels
(octproz_project/octproz/src/cuda_code.cu:109-147): a plain unsigned-int to
float cast for 8/16/32-bit containers; with ``bitshift`` 8- and 16-bit
containers are shifted right by 4 (12-bit samples in 16-bit words) and the
32-bit path is divided by 2^32 instead.

8- and 16-bit containers go through int32 before the shift: torch
implements few operators for ``uint16``/``uint32`` (no right shift), and
int32 holds every such sample exactly.

The packed-12 wire (two 12-bit samples per 3 bytes), which the reference
enumerates but does not implement (octalgorithmparameters.h:69), unpacks on
the device (:func:`unpack_uint12_device`, :func:`unpack_uint12_rows`) or on
the host (:func:`unpack_uint12_packed`); :func:`pack_uint12` writes it.  The
byte layout per 3-byte group is ``[s0 low 8 | s1 low 4 + s0 high 4 | s1
high 8]`` (native/octnative.cpp:154-165).  The device unpacks shift in
int32, for the reason above.
"""

from __future__ import annotations

import numpy as np
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


def _unpack_groups(b: torch.Tensor) -> torch.Tensor:
    """int32 (..., groups, 3) bytes -> uint16 (..., 2 * groups) samples."""
    s0 = b[..., 0] | ((b[..., 1] & 0x0F) << 8)
    s1 = (b[..., 1] >> 4) | (b[..., 2] << 4)
    out = torch.stack([s0, s1], dim=-1)
    return out.reshape(*out.shape[:-2], -1).to(torch.uint16)


def unpack_uint12_device(packed: torch.Tensor, n_samples: int) -> torch.Tensor:
    """Packed-12 wire bytes uint8[(n_samples // 2) * 3] -> uint16[n_samples]
    on the tensor's device.  n_samples must be even (every real buffer
    geometry is)."""
    if n_samples % 2:
        raise ValueError("device unpack needs an even sample count")
    want = n_samples // 2 * 3
    if packed.numel() != want:
        raise ValueError(f"packed 12-bit buffer of {n_samples} samples has {want} "
                         f"bytes, got {packed.numel()}")
    return _unpack_groups(packed.reshape(-1, 3).to(torch.int32))


def unpack_uint12_rows(packed: torch.Tensor) -> torch.Tensor:
    """Leading-axes-preserving unpack: uint8 (..., nbytes) -> uint16
    (..., nbytes * 2 // 3), nbytes a multiple of 3.  Every operation touches
    only the trailing byte axis, so each line unpacks on its own."""
    *lead, nbytes = packed.shape
    if nbytes % 3:
        raise ValueError(f"row unpack needs the byte count to be a multiple of 3 "
                         f"(two samples per 3 bytes), got {nbytes}")
    return _unpack_groups(packed.reshape(*lead, nbytes // 3, 3).to(torch.int32))


def unpack_uint12_packed(raw_bytes: np.ndarray, n_samples: int) -> np.ndarray:
    """Host unpack (numpy) of packed-12 samples -> uint16.  An odd trailing
    sample occupies only 2 bytes (native/octnative.cpp:161-164)."""
    b = np.asarray(raw_bytes, dtype=np.uint8).reshape(-1)
    needed = 3 * (n_samples // 2) + (2 if n_samples & 1 else 0)
    if b.size < needed:
        raise ValueError(
            f"packed 12-bit buffer too small: {n_samples} samples need "
            f"{needed} bytes, have {b.size}")
    n_groups = (n_samples + 1) // 2
    if b.size < n_groups * 3:  # odd tail: pad the missing third byte
        b = np.concatenate([b, np.zeros(n_groups * 3 - b.size, np.uint8)])
    b = b[: n_groups * 3].reshape(n_groups, 3).astype(np.uint16)
    s0 = b[:, 0] | ((b[:, 1] & 0x0F) << 8)
    s1 = (b[:, 1] >> 4) | (b[:, 2] << 4)
    out = np.empty(n_groups * 2, dtype=np.uint16)
    out[0::2] = s0
    out[1::2] = s1
    return out[:n_samples]


def pack_uint12(samples: np.ndarray) -> np.ndarray:
    """uint16 12-bit samples -> packed-12 bytes (host, numpy); an odd
    trailing sample takes 2 bytes of a zero-padded 3-byte group."""
    s = np.ascontiguousarray(samples, np.uint16).reshape(-1) & 0x0FFF
    n = s.size
    out = np.zeros((n + 1) // 2 * 3, np.uint8)
    pairs = n // 2
    s0, s1 = s[0:2 * pairs:2], s[1:2 * pairs:2]
    grp = out[: pairs * 3].reshape(pairs, 3)
    grp[:, 0] = s0 & 0xFF
    grp[:, 1] = ((s0 >> 8) & 0x0F) | ((s1 & 0x0F) << 4)
    grp[:, 2] = (s1 >> 4) & 0xFF
    if n & 1:
        out[pairs * 3] = s[-1] & 0xFF
        out[pairs * 3 + 1] = (s[-1] >> 8) & 0x0F
    return out
