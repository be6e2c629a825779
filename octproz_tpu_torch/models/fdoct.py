"""FdOctModel -- the stateful wrapper around the functional pipeline.

Counterpart of ``octproz_tpu/models/fdoct.py``: holds the acquisition
geometry, the processing configuration, the current LUTs on the model's
device and the carried FPN state, and exposes buffer- and chunk-level
processing.  The device is explicit: a CUDA device runs the hand-written
kernels, the CPU runs their plain versions, and nothing moves from one to
the other on its own.  The batched chunk is the fold path's; the FFT path
chunks buffer by buffer ("scan"), as in the JAX package.  With a ``mesh``
(``parallel.make_mesh``) the step is the sharded one: buffers are split
into shard blocks on the mesh's devices, and the model's device is the
mesh's first.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from .. import curves as curves_mod
from .. import pipeline
from ..params import AcqParams, Curves, FpnMode, FpnState, ProcConfig, WindowType


def _mutator(method):
    """Run a re-tuning method under the model's lock: two threads changing
    parameters at once (a viewer's request, the engine's background
    capture) each build on the other's result."""
    @functools.wraps(method)
    def locked(self, *args, **kwargs):
        with self._mutating:
            return method(self, *args, **kwargs)
    return locked


def _normalized(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


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
        device=None,
    ):
        self.acq = acq
        self.cfg = cfg
        self.mesh = mesh
        if mesh is not None:
            from ..parallel import Mesh

            if not isinstance(mesh, Mesh):
                raise TypeError(f"mesh must be a parallel.Mesh, got {type(mesh).__name__}")
            first = mesh.local_devices[0]
            if device is not None and _normalized(device) != first:
                raise ValueError(f"device {device} is not the mesh's first device {first}")
            device = first
        elif device is None:
            raise TypeError("FdOctModel needs device= (or a mesh=)")
        self.device = _normalized(device)
        if preflight:
            # refuse clearly before the first buffer when the configuration
            # cannot fit (cuda_code.cu:975-1015 analog); skipped on the CPU
            from ..utils.memory import preflight_check

            preflight_check(acq, cfg, self.device)
        self._mutating = threading.RLock()
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
        self._step = self._build_step(cfg)
        # One published snapshot (cfg, curves, step): the hot path reads this
        # single attribute, so a set_config / curve rebuild from another
        # thread never pairs an old step with new curves.
        self._exec = (self.cfg, self.curves, self._step)

    def _build_step(self, cfg: ProcConfig):
        if self.mesh is not None:
            from ..parallel import make_sharded_step

            return make_sharded_step(self.acq, cfg, self.mesh)
        return pipeline.make_step(self.acq, cfg)

    @property
    def devices(self):
        """The distinct devices the model's buffers live on: the mesh's
        local ones, or the model's device."""
        return self.mesh.local_devices if self.mesh is not None else [self.device]

    @property
    def is_multihost(self) -> bool:
        """True on a mesh whose host axis spans processes: each process
        feeds and fetches only its own B-scan block."""
        from ..parallel import AXIS_HOST

        return (self.mesh is not None and AXIS_HOST in self.mesh.axis_names
                and self.mesh.process_index is not None
                and self.mesh.shape[AXIS_HOST] > 1)

    def put_buffer(self, raw):
        """Commit a host raw buffer to the model's device: a non-blocking
        copy on the current stream from pinned host memory (the host tensor
        itself when it is pinned already, as the streaming engine's upload
        ring is, else a pinned copy of it).  On a mesh: the buffer's shard
        blocks, each on its device; on a mesh that spans processes ``raw``
        is this process's B-scan block (``parallel.local_bscan_range``)."""
        from ..parallel import multihost, sharding

        if self.mesh is None:
            return sharding.place(raw, self.device)
        if self.is_multihost and not isinstance(raw, sharding.ShardedBuffer):
            return multihost.feed_from_local(raw, self.acq, self.mesh)
        return sharding.shard_buffer(raw, self.mesh)

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
        if self.mesh is not None:
            return self._put_packed_mesh(packed)
        wire = self.put_buffer(packed)
        return unpack_uint12_device(wire, self.acq.samples_per_buffer).reshape(
            self.acq.buffer_shape)

    def _put_packed_mesh(self, packed):
        """The packed wire split on B-scan boundaries and unpacked block by
        block on each shard's device (packing is line-local).  Per line
        when samples_per_line is a multiple of 256 (the wire split like the
        buffer); else per B-scan when a whole B-scan's samples are (each
        row's bytes on each of its positions, unpacked whole, then cut to
        the position's A-scans); else refused, as the JAX package refuses
        a geometry its lane-aligned unpack cannot take."""
        from ..ops.convert import unpack_uint12_rows
        from ..parallel import ShardedBuffer, multihost

        acq = self.acq
        per_line = acq.samples_per_line % 256 == 0
        bscan_bytes = acq.ascans_per_bscan * acq.samples_per_line * 3 // 2
        if not per_line and bscan_bytes % 384:
            raise ValueError(
                f"packed-12 on a mesh needs samples_per_line "
                f"({acq.samples_per_line}) or a whole B-scan's samples "
                f"({acq.ascans_per_bscan * acq.samples_per_line}) to be a "
                f"multiple of 256 (lane-aligned 384-byte unpack rows)")
        wire = multihost.feed_wire_from_local(packed, acq, self.mesh, per_line=per_line)
        if per_line:
            return wire.map(unpack_uint12_rows)
        shards = []
        a_len = acq.ascans_per_bscan // self.mesh.shape.get("ascan", 1)
        for ((b,), w), (_, ia, _) in zip(wire.shards, self.mesh.local_positions()):
            a = slice(ia * a_len, (ia + 1) * a_len)
            raw = unpack_uint12_rows(w).reshape(
                w.shape[0], acq.ascans_per_bscan, acq.samples_per_line)[:, a].contiguous()
            shards.append(((b, a), raw))
        return ShardedBuffer(tuple(acq.buffer_shape), shards[0][1].dtype, self.mesh,
                             tuple(shards))

    def fetch(self, arr) -> np.ndarray:
        """Device-to-host fetch of a processed buffer as numpy (bfloat16
        volumes arrive as float32: numpy has no bfloat16): on a mesh the
        whole buffer in one process, this process's B-scan block on a mesh
        that spans processes."""
        from ..parallel import multihost

        return multihost.fetch(arr)

    # -- live re-tuning (reference: sidebar edits -> updateResampleCurve etc.,
    #    octalgorithmparameters.cpp:141-249) ---------------------------------
    @_mutator
    def set_klin_coeffs(self, c0: float, c1: float, c2: float, c3: float) -> None:
        self._curve_kwargs["resample_coeffs"] = (c0, c1, c2, c3)
        self._curve_kwargs["custom_resample_curve"] = None
        self._rebuild_curves()

    @_mutator
    def set_dispersion_coeffs(self, d0: float, d1: float, d2: float, d3: float) -> None:
        self._curve_kwargs["dispersion_coeffs"] = (d0, d1, d2, d3)
        self._rebuild_curves()

    @_mutator
    def set_window(self, window_type: WindowType, center: float = 0.5,
                   fill_factor: float = 1.0) -> None:
        self._curve_kwargs.update(window_type=window_type, window_center=center,
                                  window_fill_factor=fill_factor)
        self._rebuild_curves()

    @_mutator
    def set_custom_resample_curve(self, curve: np.ndarray) -> None:
        self._curve_kwargs["custom_resample_curve"] = np.asarray(curve, np.float32)
        self._rebuild_curves()

    @_mutator
    def set_post_background(self, background: np.ndarray) -> None:
        self.curves = dataclasses.replace(
            self.curves, post_background=torch.as_tensor(
                np.asarray(background, np.float32), device=self.device))
        self._exec = (self.cfg, self.curves, self._step)

    @_mutator
    def redetermine_fpn(self) -> None:
        """Reference: redetermineFixedPatternNoise request (cuda_code.cu:1521)."""
        self.fpn_state = pipeline.initial_fpn_state(self.acq, device=self.device)

    @_mutator
    def set_config(self, **changes) -> None:
        """Replace ProcConfig fields mid-stream (grayscale range, FPN mode,
        scaling, precision rung, compute dtype, ...); the curves are built
        anew, so the held operator parts follow the new rung (on a mesh the
        sharded step and its per-device curve copies are made anew too)."""
        cfg = dataclasses.replace(self.cfg, **changes)  # validates before any change
        step = self._build_step(cfg)
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
        if self.mesh is not None:
            raise ValueError("process_chunk is single-device throughput "
                             "mode; on a mesh use process_buffer per buffer")
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
        return pipeline.fused_ready(self.cfg, self.fpn_state)  # host flag: no device sync

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
        if self.mesh is not None:
            if len(raw_volume.shape) == 3:
                return self.process_buffer(raw_volume)
            raise ValueError("process_volume on a mesh takes one buffer at a time; "
                             "call process_buffer per buffer")
        raw_volume = self.put_buffer(raw_volume)
        if raw_volume.dim() == 3:
            return self.process_buffer(raw_volume)
        return torch.cat([self.process_buffer(raw) for raw in raw_volume], dim=0)
