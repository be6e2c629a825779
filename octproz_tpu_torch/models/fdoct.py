"""FdOctModel -- the stateful wrapper around the functional pipeline.

Counterpart of ``octproz_tpu/models/fdoct.py``: holds the acquisition
geometry, the processing configuration, the current LUTs on the model's
device and the carried FPN state, and exposes buffer- and chunk-level
processing.  The device is explicit: a CUDA device runs the hand-written
kernels, the CPU runs their plain versions, and nothing moves from one to
the other on its own.  The batched chunk is the fold path's; the FFT path
chunks buffer by buffer ("scan"), as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from .. import curves as curves_mod
from .. import pipeline
from ..params import AcqParams, Curves, FpnMode, FpnState, ProcConfig, WindowType


class FdOctModel:
    def __init__(
        self,
        acq: AcqParams,
        cfg: ProcConfig,
        resample_coeffs: Sequence[float] = (0.0, 0.0, 0.0, 0.0),
        dispersion_coeffs: Sequence[float] = (0.0, 0.0, 0.0, 0.0),
        window_type: WindowType = WindowType.HANNING,
        window_center: float = 0.5,
        window_fill_factor: float = 1.0,
        custom_resample_curve: Optional[np.ndarray] = None,
        post_background: Optional[np.ndarray] = None,
        mesh=None,
        preflight: bool = True,
        *,
        device,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "multi-device meshes are not ported yet (ROADMAP.md Queue 1, A13)")
        self.acq = acq
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if preflight:
            # refuse clearly before the first buffer when the configuration
            # cannot fit (cuda_code.cu:975-1015 analog); skipped on the CPU
            from ..utils.memory import preflight_check

            preflight_check(acq, cfg, self.device)
        self._curve_kwargs = dict(
            resample_coeffs=tuple(resample_coeffs),
            dispersion_coeffs=tuple(dispersion_coeffs),
            window_type=window_type,
            window_center=window_center,
            window_fill_factor=window_fill_factor,
            custom_resample_curve=custom_resample_curve,
            post_background=post_background,
        )
        self.curves: Curves = curves_mod.make_curves(acq, cfg, **self._curve_kwargs,
                                                     device=self.device)
        self.fpn_state: FpnState = pipeline.initial_fpn_state(acq, device=self.device)
        self._step = pipeline.make_step(self.acq, self.cfg)
        # One published snapshot (cfg, curves, step): the hot path reads this
        # single attribute, so a set_config / curve rebuild from another
        # thread never pairs an old step with new curves.
        self._exec = (self.cfg, self.curves, self._step)

    @property
    def is_multihost(self) -> bool:
        """False: multi-device meshes are ROADMAP.md Queue 1, A13."""
        return False

    def put_buffer(self, raw) -> torch.Tensor:
        """Commit a host raw buffer to the model's device: a non-blocking
        copy on the current stream from pinned host memory (the host tensor
        itself when it is pinned already, as the streaming engine's upload
        ring is, else a pinned copy of it)."""
        if isinstance(raw, torch.Tensor):
            if raw.device == self.device:
                return raw
            if raw.device.type != "cpu":
                return raw.to(self.device)
            host = raw
        else:
            host = torch.from_numpy(np.ascontiguousarray(raw))
        if self.device.type != "cuda":
            return host.to(self.device)
        if not host.is_pinned():
            host = host.pin_memory()
        return host.to(self.device, non_blocking=True)

    def put_packed_buffer(self, packed) -> torch.Tensor:
        """Upload a packed-12-bit wire buffer (1.5 bytes per sample, 25 %
        fewer than the 12-in-16 container) and unpack it on the model's
        device -> uint16 (bscans, ascans, samples).  The unpack runs on the
        current stream after the copy (ops.convert.unpack_uint12_device)."""
        from ..ops.convert import unpack_uint12_device

        if self.acq.bit_depth != 12:
            raise ValueError("packed-12 wire format needs bit_depth=12")
        if not isinstance(packed, torch.Tensor):
            packed = np.asarray(packed, np.uint8)
        wire = self.put_buffer(packed)
        return unpack_uint12_device(wire, self.acq.samples_per_buffer).reshape(
            self.acq.buffer_shape)

    def fetch(self, arr: torch.Tensor) -> np.ndarray:
        """Device-to-host fetch of a processed buffer as numpy (bfloat16
        volumes arrive as float32: numpy has no bfloat16)."""
        t = arr.detach()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.cpu().numpy()

    # -- live re-tuning (reference: sidebar edits -> updateResampleCurve etc.,
    #    octalgorithmparameters.cpp:141-249) ---------------------------------
    def set_klin_coeffs(self, c0: float, c1: float, c2: float, c3: float) -> None:
        self._curve_kwargs["resample_coeffs"] = (c0, c1, c2, c3)
        self._curve_kwargs["custom_resample_curve"] = None
        self._rebuild_curves()

    def set_dispersion_coeffs(self, d0: float, d1: float, d2: float, d3: float) -> None:
        self._curve_kwargs["dispersion_coeffs"] = (d0, d1, d2, d3)
        self._rebuild_curves()

    def set_window(self, window_type: WindowType, center: float = 0.5,
                   fill_factor: float = 1.0) -> None:
        self._curve_kwargs.update(window_type=window_type, window_center=center,
                                  window_fill_factor=fill_factor)
        self._rebuild_curves()

    def set_custom_resample_curve(self, curve: np.ndarray) -> None:
        self._curve_kwargs["custom_resample_curve"] = np.asarray(curve, np.float32)
        self._rebuild_curves()

    def set_post_background(self, background: np.ndarray) -> None:
        self.curves = dataclasses.replace(
            self.curves, post_background=torch.as_tensor(
                np.asarray(background, np.float32), device=self.device))
        self._exec = (self.cfg, self.curves, self._step)

    def redetermine_fpn(self) -> None:
        """Reference: redetermineFixedPatternNoise request (cuda_code.cu:1521)."""
        self.fpn_state = pipeline.initial_fpn_state(self.acq, device=self.device)

    def set_config(self, **changes) -> None:
        """Replace ProcConfig fields mid-stream (grayscale range, FPN mode,
        scaling, precision rung, compute dtype, ...); the curves are built
        anew, so the held operator parts follow the new rung."""
        cfg = dataclasses.replace(self.cfg, **changes)  # validates before any change
        step = pipeline.make_step(self.acq, cfg)
        self.cfg = cfg
        self._rebuild_curves(publish=False)
        self._step = step
        self._exec = (self.cfg, self.curves, self._step)

    def _rebuild_curves(self, publish: bool = True) -> None:
        post_bg = self.curves.post_background
        self.curves = curves_mod.make_curves(self.acq, self.cfg, **self._curve_kwargs,
                                             device=self.device)
        if post_bg is not None:
            self.curves = dataclasses.replace(self.curves, post_background=post_bg)
        if publish:
            self._exec = (self.cfg, self.curves, self._step)

    # -- processing ----------------------------------------------------------
    def process_buffer(self, raw) -> torch.Tensor:
        """raw uint (bscans, ascans, samples) -> processed half-volume on the
        model's device.  Updates the carried FPN state without a host sync."""
        raw = self.put_buffer(raw)
        _, curves, step = self._exec  # consistent (curves, step) pair
        processed, self.fpn_state = step(raw, curves, self.fpn_state)
        return processed

    def process_chunk(self, raw_stack, strategy: str = "auto") -> torch.Tensor:
        """Throughput mode: a stack of raw buffers (k, bscans, ascans,
        samples).

        strategy:
          * "scan"  -- pipeline.make_scan_step: the FPN state threads buffer
            to buffer exactly like repeated process_buffer calls.
          * "batch" -- the whole stack as ONE fused kernel call on the
            flattened line axis.  Needs the fused fold path and a constant
            FPN mean line (mode OFF, or ONCE already determined).
          * "auto"  -- "batch" whenever its conditions hold, else "scan".
        """
        if strategy not in ("auto", "scan", "batch"):
            raise ValueError("strategy must be 'auto', 'scan' or 'batch'")
        raw_stack = self.put_buffer(raw_stack)
        if strategy != "scan" and self._batch_ready():
            return self._batch_chunk(raw_stack)
        if strategy == "batch":
            raise ValueError(
                "strategy='batch' needs fft_via_matmul + fused_scale + "
                "fold_backend='pallas' + FPN OFF (or ONCE already "
                "determined); use 'auto' to fall back to scan")
        cfg, curves, _ = self._exec  # consistent (cfg, curves) pair
        step = pipeline.make_scan_step(self.acq, cfg)
        out, self.fpn_state = step(raw_stack, curves, self.fpn_state)
        return out

    def _batch_ready(self) -> bool:
        cfg = self.cfg
        if not (cfg.fft_via_matmul and cfg.fused_scale
                and cfg.fold_backend == "pallas"):
            return False
        if cfg.fpn_mode == FpnMode.ONCE:
            return self.fpn_state.determined  # host flag: no device sync
        return cfg.fpn_mode == FpnMode.OFF

    def _batch_chunk(self, raw_stack) -> torch.Tensor:
        """One fused kernel over the whole stack; the FPN state is unchanged
        (the mean line is a constant input in this regime).  The post stages
        run per buffer, in float32, and the store narrows after them."""
        from ..kernels.fused_prep import fused_depth_scale

        cfg, curves, _ = self._exec  # consistent (cfg, curves) pair
        mean = (torch.zeros_like(self.fpn_state.mean_line)
                if cfg.fpn_mode == FpnMode.OFF else self.fpn_state.mean_line)
        mag = fused_depth_scale(raw_stack, *pipeline.depth_operators(curves),
                                mean, self.acq, pipeline.kernel_config(cfg),
                                wide=curves.depth_concat_parts)
        if pipeline.has_post(cfg):
            mag = torch.stack([pipeline.postprocess_volume(m, curves, cfg) for m in mag])
        return pipeline.narrow(mag, cfg)

    def process_volume(self, raw_volume) -> torch.Tensor:
        """raw uint (buffers, bscans, ascans, samples), or one buffer ->
        (buffers * bscans, ascans, samples//2), buffer by buffer with the
        FPN state carried along."""
        raw_volume = self.put_buffer(raw_volume)
        if raw_volume.dim() == 3:
            return self.process_buffer(raw_volume)
        return torch.cat([self.process_buffer(raw) for raw in raw_volume], dim=0)
