"""Image export and LUT color mapping for processed OCT data.

A copy of ``octproz_tpu/viz/image.py`` (numpy), with a PNG codec of its
own: the machines the port runs on need not have Pillow, so
:func:`encode_png` writes 8-bit grayscale and RGB PNGs with ``zlib``,
``struct`` and ``binascii.crc32`` (filter 0 on every row), and
:func:`decode_png` reads such files back.  Only :func:`load_lut_png`
imports Pillow, for LUT strips of any PNG flavour.

Offline replacement for the reference's OpenGL display path: B-scan / en-face
frames are written as PNGs instead of textures (GLWindow2D,
octproz_project/octproz/src/glwindow2d.cpp:520-523 + screenshot saving), and
the 1-D color LUTs mirror the PNG LUTs the 3D viewer loads from
``octproz/luts/`` (glwindow3d.cpp LUT selection; files blue_lut.png,
fire_lut.png, ...).  LUT PNGs are Nx1 (or 1xN) RGB strips; ``builtin_lut``
generates equivalents procedurally so no asset files are required.
"""

from __future__ import annotations

import binascii
import os
import struct
import zlib

import numpy as np
import torch

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: PNG colour type by channel count (8-bit samples): gray, RGB.
_COLOR_TYPES = {1: 0, 3: 2}


def to_uint8(img: np.ndarray) -> np.ndarray:
    """float (0..1, clipped) -> uint8."""
    return (np.clip(np.asarray(img, np.float32), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", binascii.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img_u8: np.ndarray) -> bytes:
    """(H, W) grayscale or (H, W, 3) RGB uint8 -> PNG file bytes."""
    arr = np.ascontiguousarray(img_u8)
    if arr.dtype != np.uint8:
        raise ValueError(f"encode_png needs uint8 pixels, got {arr.dtype}")
    channels = 1 if arr.ndim == 2 else arr.shape[2] if arr.ndim == 3 else 0
    if channels not in (1, 3):
        raise ValueError(f"encode_png needs (H, W) or (H, W, 3) pixels, got {arr.shape}")
    h, w = arr.shape[:2]
    rows = np.zeros((h, 1 + w * channels), np.uint8)  # filter byte 0 per row
    rows[:, 1:] = arr.reshape(h, w * channels)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPES[channels], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def png_size(data: bytes):
    """(width, height) from a PNG's IHDR chunk; ValueError if ``data`` does
    not start with a PNG signature and an IHDR chunk."""
    if data[:8] != _SIGNATURE or data[12:16] != b"IHDR":
        raise ValueError("not a PNG file")
    return struct.unpack(">II", data[16:24])


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes as :func:`encode_png` writes them (8-bit gray or RGB, not
    interlaced, filter 0 on every row) -> uint8 (H, W) or (H, W, 3); every
    chunk's CRC is checked."""
    w, h = png_size(data)
    pos, idat, header = 8, [], None
    while pos < len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if binascii.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    depth, color, interlace = header[2], header[3], header[6]
    channels = {v: k for k, v in _COLOR_TYPES.items()}.get(color)
    if depth != 8 or channels is None or interlace:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type {color}, "
                         f"interlace {interlace}")
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, -1)
    if rows.shape[1] != 1 + w * channels or rows[:, 0].any():
        raise ValueError("unsupported PNG: rows filtered other than by filter 0")
    img = rows[:, 1:].reshape(h, w, channels)
    return img[:, :, 0] if channels == 1 else img


def save_png(path: str, img: np.ndarray) -> str:
    """Save (H, W) grayscale or (H, W, 3) RGB float 0..1 (or uint8) image."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = to_uint8(arr)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(arr))
    return path


def load_lut_png(path: str) -> np.ndarray:
    """Load an Nx1 / 1xN RGB LUT strip PNG -> float32 (N, 3) in 0..1."""
    from PIL import Image

    arr = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
    if arr.shape[0] == 1:
        arr = arr[0]
    elif arr.shape[1] == 1:
        arr = arr[:, 0]
    else:  # take the first row of a wider image
        arr = arr[0]
    return np.ascontiguousarray(arr, np.float32)


def builtin_lut(name: str, n: int = 256) -> np.ndarray:
    """Procedural equivalents of the shipped LUTs (octproz/luts/info.txt).

    Supported: gray, fire, hotter, ice, blue, deep_blue, deep_red,
    six_shades, sixteen_colors, depth_colors.
    """
    t = np.linspace(0.0, 1.0, n, dtype=np.float32)

    def ramp(*stops):
        """Piecewise-linear RGB ramp from (pos, (r, g, b)) stops."""
        pos = np.array([s[0] for s in stops], np.float32)
        cols = np.array([s[1] for s in stops], np.float32)
        return np.stack([np.interp(t, pos, cols[:, c]) for c in range(3)], axis=1)

    if name == "gray":
        return np.stack([t, t, t], axis=1)
    if name == "fire":
        return ramp((0, (0, 0, 0)), (0.35, (0.8, 0, 0)), (0.7, (1, 0.8, 0)), (1, (1, 1, 1)))
    if name == "hotter":
        return ramp((0, (0, 0, 0)), (0.25, (1, 0, 0)), (0.6, (1, 1, 0)), (1, (1, 1, 1)))
    if name == "ice":
        return ramp((0, (0, 0, 0)), (0.4, (0, 0.3, 0.8)), (0.75, (0.3, 0.8, 1)), (1, (1, 1, 1)))
    if name == "blue":
        return ramp((0, (0, 0, 0)), (0.5, (0, 0.2, 1)), (1, (0.8, 0.95, 1)))
    if name == "deep_blue":
        return ramp((0, (0, 0, 0.1)), (0.6, (0, 0.1, 0.7)), (1, (0.6, 0.8, 1)))
    if name == "deep_red":
        return ramp((0, (0.1, 0, 0)), (0.6, (0.7, 0.05, 0)), (1, (1, 0.8, 0.6)))
    if name == "six_shades":
        levels = np.floor(t * 5.999) / 5.0
        return np.stack([levels] * 3, axis=1).astype(np.float32)
    if name == "sixteen_colors":
        import colorsys
        idx = np.floor(t * 15.999).astype(int)
        cols = np.array([colorsys.hsv_to_rgb(h / 16.0, 1.0, 1.0) for h in range(16)],
                        np.float32)
        return cols[idx]
    if name == "depth_colors":
        import colorsys
        cols = np.array([colorsys.hsv_to_rgb(0.8 * (1 - x), 0.9, 1.0) for x in t],
                        np.float32)
        return cols
    raise ValueError(f"unknown builtin LUT '{name}'")


def apply_lut(img: np.ndarray, lut: np.ndarray) -> np.ndarray:
    """Map grayscale (H, W) float 0..1 through an (N, 3) LUT -> (H, W, 3)."""
    lut = np.asarray(lut, np.float32)
    idx = np.clip(np.asarray(img, np.float32), 0.0, 1.0) * (lut.shape[0] - 1)
    return lut[(idx + 0.5).astype(np.int32)]


def save_bscan_png(path: str, volume, frame_nr: int = 0, lut=None, **kw) -> str:
    """Slice + save a B-scan frame (display orientation: depth vertical).
    ``volume``: a tensor (sliced where it lies) or a host array."""
    from ..ops.projections import bscan_frame

    frame = bscan_frame(torch.as_tensor(volume), frame_nr, **kw).cpu().numpy().T  # (depth, ascans)
    frame = np.clip(frame, 0.0, 1.0)
    return save_png(path, apply_lut(frame, lut) if lut is not None else frame)


def save_enface_png(path: str, volume, depth_nr: int = 0, lut=None, **kw) -> str:
    from ..ops.projections import enface_frame

    frame = np.clip(enface_frame(torch.as_tensor(volume), depth_nr, **kw).cpu().numpy(),
                    0.0, 1.0)
    return save_png(path, apply_lut(frame, lut) if lut is not None else frame)
