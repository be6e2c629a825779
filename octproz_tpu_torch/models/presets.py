"""Named acquisition/processing presets.

Counterpart of ``octproz_tpu/models/presets.py``: the reference's common
setups (the published benchmark chain, performance/v180/performance_v180.md
:20-52, and the figshare test-volume geometry, README.md:70-72) by name.

The ``tpu`` parameter keeps the JAX package's name so that settings carry
over; in this package it selects the folded-GEMM path
(``fft_via_matmul=True``, the fold kernels) over the FFT path (torch ops or
the prep kernels, then cuFFT).
"""

from __future__ import annotations

from typing import Dict, Tuple

from ..params import AcqParams, FpnMode, Interpolation, ProcConfig


def figshare_test_volume() -> AcqParams:
    """The published benchmark volume: 12-bit, 1024 x 512 x 256
    (README.md:70-72)."""
    return AcqParams(samples_per_line=1024, ascans_per_bscan=512,
                     bscans_per_buffer=256, buffers_per_volume=1,
                     bit_depth=12)


def benchmark_config(tpu: bool = True) -> ProcConfig:
    """The reference's headline benchmark chain: cubic k-linearization +
    windowing + dispersion + FPN once + log scaling, with the 12-in-16-bit
    bitshift the figshare volume needs.  ``tpu`` selects the folded GEMM."""
    return ProcConfig(
        bitshift=True,
        resampling=True, interpolation=Interpolation.CUBIC,
        windowing=True, dispersion=True,
        fpn_mode=FpnMode.ONCE, log_scaling=True,
        fft_via_matmul=tpu,
    )


def minimal_config(tpu: bool = True) -> ProcConfig:
    """Bare reconstruction: inverse FFT + log only (every optional stage
    off).  ``tpu`` selects the folded GEMM."""
    return ProcConfig(log_scaling=True, fft_via_matmul=tpu)


def handheld_sinusoidal_config(tpu: bool = True) -> ProcConfig:
    """Resonant-scanner setup: full chain + bidirectional B-scan flip +
    sinusoidal scan correction (docs/docs/processing.md:150-189).  ``tpu``
    selects the folded GEMM."""
    return ProcConfig(
        bitshift=True,
        background_removal=True,
        resampling=True, interpolation=Interpolation.CUBIC,
        windowing=True, dispersion=True,
        fpn_mode=FpnMode.ONCE, log_scaling=True,
        bscan_flip=True, sinusoidal_correction=True,
        fft_via_matmul=tpu,
    )


PRESETS: Dict[str, Tuple[AcqParams, ProcConfig]] = {
    "benchmark": (figshare_test_volume(), benchmark_config()),
    "minimal": (figshare_test_volume(), minimal_config()),
    "handheld": (figshare_test_volume(), handheld_sinusoidal_config()),
}
