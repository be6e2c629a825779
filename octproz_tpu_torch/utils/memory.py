"""Device-memory preflight: estimate a configuration's footprint and refuse
clearly before the first buffer.

The reference checks ``cudaMemGetInfo`` before every allocation
(cuda_code.cu:975-1015); here the estimate (the arithmetic of
``octproz_tpu/utils/memory.py``, for the fold and the FFT path alike) is
held against
``torch.cuda.mem_get_info`` of the model's device.  A CPU device reports no
limit and the check is skipped.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..params import AcqParams, FpnMode, ProcConfig


def estimate_footprint(acq: AcqParams, cfg: ProcConfig,
                       max_in_flight: int = 2) -> Dict[str, int]:
    """Per-component steady-state device footprint in bytes (conservative:
    transient operands are counted once per in-flight step)."""
    n = acq.samples_per_line
    half = acq.output_ascan_length
    lines = acq.ascans_per_buffer
    f = 4  # float32
    in_flight = max(1, max_in_flight)

    comp: Dict[str, int] = {}
    comp["raw"] = acq.samples_per_buffer * acq.raw_dtype.itemsize * in_flight
    comp["processed"] = lines * half * f * in_flight
    if cfg.fft_via_matmul:
        comp["operators"] = 2 * n * half * f
        fused = (cfg.fused_scale and cfg.fold_backend == "pallas"
                 and cfg.fpn_mode in (FpnMode.OFF, FpnMode.ONCE))
        if not fused or cfg.fpn_mode != FpnMode.OFF:
            # the unfused tail (or the FPN-determination buffer) holds the
            # planar (re, im) depth volumes
            comp["planar_depth"] = 2 * lines * half * f
    else:
        ops = 0
        if cfg.resampling:
            ops += n * n * f if cfg.resample_via_matmul else n * f
        if cfg.windowing:
            ops += n * f
        if cfg.dispersion:
            ops += n * 2 * f  # complex phasor
        comp["operators"] = ops
        # decoded float spectra and the complex FFT buffer per step
        comp["spectra"] = lines * n * f
        comp["fft"] = lines * n * 2 * f
    if cfg.fpn_mode != FpnMode.OFF:
        comp["fpn_state"] = 2 * half * f + 3 * 9 * half * f  # mean + segment sums
    if cfg.sinusoidal_correction or cfg.post_background_removal:
        comp["postprocess_tmp"] = lines * half * f
    comp["total"] = sum(comp.values())
    return comp


def device_memory_limit(device) -> Optional[int]:
    """Free device memory in bytes, or None for a device that reports none."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    free, _total = torch.cuda.mem_get_info(device)
    return free


def preflight_check(acq: AcqParams, cfg: ProcConfig, device,
                    max_in_flight: int = 2, limit_bytes: Optional[int] = None,
                    safety: float = 0.9) -> Dict[str, int]:
    """Raise MemoryError (with the component breakdown) when the estimate
    exceeds ``safety`` x the device's free memory.  Returns the estimate."""
    comp = estimate_footprint(acq, cfg, max_in_flight)
    limit = limit_bytes if limit_bytes is not None else device_memory_limit(device)
    if limit is None:
        return comp
    budget = int(limit * safety)
    if comp["total"] > budget:
        detail = ", ".join(f"{k}={v / 1e6:.1f} MB" for k, v in comp.items()
                           if k != "total")
        raise MemoryError(
            f"configuration needs ~{comp['total'] / 1e6:.0f} MB of device "
            f"memory but only {budget / 1e6:.0f} MB is usable "
            f"({limit / 1e6:.0f} MB x {safety:.0%} safety): {detail}. "
            f"Reduce bscans_per_buffer/max_in_flight or disable stages.")
    return comp
