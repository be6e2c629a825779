"""Synthetic raw interferograms, made on the device from a seed.

A buffer is what a swept-source OCT scanner's digitiser leaves: per A-scan
a Gaussian source spectrum times (a DC level plus one fringe per tissue
layer), a fixed-pattern reflection that is the same in every A-scan, and
detector noise, quantized to ``bit_depth`` codes and left-aligned in the
container by ``shift`` bits (the figshare volume's 12 bits in 16).  Each
layer is a smooth surface across the volume (its depth varies along both
scan axes) with speckle: a Rayleigh-distributed amplitude and a uniform
phase per A-scan.  So the processed image has a scan's structure and
dynamic range -- bright layers 40-60 dB above a noise floor near the
display's bottom -- and not uniform noise.

Every number comes from one ``torch.Generator`` on the device, seeded with
``seed``, in a fixed order: the same seed and sizes give the same buffers.
"""

from __future__ import annotations

import math

import torch


#: B-scans made at a time: a block's float32 lines stay near 64 MB.
BLOCK_BSCANS = 32

#: The interferogram model, unless a configuration file gives its own
#: ``signal``: a Gaussian source spectrum (sigma as a share of the line)
#: times ``dc`` plus one speckled fringe per layer (depth range as shares of
#: the depth half, reflectivity in codes), a fixed-pattern fringe at
#: ``fixed_depth``, surfaces that undulate by ``undulation``, detector
#: noise in codes.
SIGNAL = {
    "dc": 1500,
    "spectrum_sigma": 0.22,
    "fixed_amplitude": 40,
    "fixed_depth": 0.04,
    "undulation": 0.08,
    "noise": 2.5,
    "layers": [[0.1, 0.3, 260], [0.25, 0.45, 160], [0.4, 0.65, 100], [0.55, 0.85, 60]],
}


def make_volumes(acq, count: int, seed: int, device, shift: int = 0,
                 signal: dict = None) -> torch.Tensor:
    """``count`` raw buffers (count, bscans, ascans, samples) of uint16, on
    ``device``: ``acq.bit_depth``-bit codes shifted left by ``shift``, of
    the model ``signal`` (default :data:`SIGNAL`)."""
    signal = SIGNAL if signal is None else signal
    if acq.raw_dtype != torch.uint16 or acq.bit_depth + shift > 16:
        raise ValueError("the interferogram model fills 16-bit containers")
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    b_n, a_n, n = acq.buffer_shape
    half = n // 2
    k = torch.arange(n, dtype=torch.float32, device=device)
    spectrum = torch.exp(-0.5 * ((k - n / 2) / (signal["spectrum_sigma"] * n)) ** 2)
    fixed = signal["fixed_amplitude"] * torch.cos(
        2 * math.pi * signal["fixed_depth"] * half * k / n)
    top = (1 << acq.bit_depth) - 1
    # int16 holds uint16's bit pattern: no uint16 arithmetic on every backend
    out = torch.empty((count, *acq.buffer_shape), dtype=torch.int16, device=device)
    layers = signal["layers"]
    for v in range(count):
        # per layer: base depth, two surface undulations (amplitude,
        # frequency, phase along each axis) as fractions of the depth range
        p = torch.rand((len(layers), 6), generator=g, device=device).tolist()
        for b0 in range(0, b_n, BLOCK_BSCANS):
            b1 = min(b0 + BLOCK_BSCANS, b_n)
            bb = torch.arange(b0, b1, dtype=torch.float32, device=device)[:, None] / b_n
            aa = torch.arange(a_n, dtype=torch.float32, device=device)[None, :] / a_n
            x = torch.full(((b1 - b0) * a_n, n), float(signal["dc"]), device=device)
            for (depth_lo, depth_hi, refl), q in zip(layers, p):
                base = depth_lo + (depth_hi - depth_lo) * q[0]
                surface = (base
                           + signal["undulation"] * q[1] * torch.sin(2 * math.pi * (3 * q[2] * aa + q[3]))
                           + signal["undulation"] * q[4] * torch.sin(2 * math.pi * (2 * q[5] * bb)))
                depth = (surface.clamp(0.02, 0.98) * half).reshape(-1, 1)
                speckle = torch.randn((depth.shape[0], 2), generator=g, device=device)
                amp = refl * speckle.norm(dim=1, keepdim=True) / math.sqrt(2.0)
                phase = 2 * math.pi * torch.rand((depth.shape[0], 1), generator=g, device=device)
                x += amp * torch.cos(2 * math.pi * depth * k / n + phase)
            x = spectrum * x + fixed
            x += signal["noise"] * torch.randn(x.shape, generator=g, device=device)
            codes = torch.round(x).clamp_(0, top).to(torch.int32) << shift
            codes = torch.where(codes >= 32768, codes - 65536, codes)
            out[v, b0:b1] = codes.to(torch.int16).reshape(b1 - b0, a_n, n)
    return out.view(torch.uint16)
