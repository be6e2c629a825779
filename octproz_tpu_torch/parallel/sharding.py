"""Sharded per-buffer processing over a mesh of devices.

Counterpart of ``octproz_tpu/parallel/sharding.py``.  The reference
application runs on one GPU; the scale-out splits one buffer over a mesh
with up to three named axes:

* ``AXIS_HOST``: present on meshes built by :mod:`.multihost`; row ``p``
  holds the devices of process ``p``, which feeds its own contiguous block
  of B-scans.  Host-major with ``AXIS_BSCAN`` in the leading B-scan split.
* ``AXIS_BSCAN``: B-scan blocks of a buffer over devices.  Every per-A-scan
  stage (decode, resample, window, dispersion, inverse DFT, scaling) is
  local along this axis.
* ``AXIS_ASCAN``: the A-scans of each B-scan split over devices.  The
  sinusoidal correction (a global remap of the A-scan axis: its offset
  ``|n(k) - k|`` reaches about a tenth of the row) and the B-scan flip (a
  reversal of that axis) need the whole row.

PyTorch has no SPMD partitioner, so the step is written out per shard: a
:class:`Mesh` is an array of ``torch.device`` (a device may appear more
than once, which puts several shards on one card), a buffer on it is a
:class:`ShardedBuffer` holding this process's blocks, and the step runs
the single-device kernels on each block, on the block's device.  The
cross-shard work, where JAX's partitioner inserts collectives:

* the fixed-pattern-noise statistics (cuda_code.cu:523-565): each shard
  sums its noise lines per segment by their GLOBAL line index (plain sums
  over contiguous spans, so the result is the same from run to run); the
  sums are added on the mesh's first device in mesh order and, across
  processes, ``torch.distributed.all_reduce``-d over the host axis (JAX's
  ``lax.psum``); the minimum-variance selection then runs once;
* on an A-scan-split mesh, the flip and the sinusoidal correction gather
  each B-scan row on its first shard's device and scatter the result back.

Every such transfer is tallied (:class:`Tally`): ``parallel.traffic``
reads it where JAX reads the collectives of the compiled HLO.

The FPN-once branch is taken on the host from ``FpnState.determined`` (a
Python bool), where JAX uses ``lax.cond``: no device sync per buffer.  In
the steady state each shard runs the same single-pass kernel
(``fused_depth_scale``) as the single-device pipeline.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import pipeline as _pipeline
from ..ops import fpn as _fpn
from ..ops import postprocess as _postprocess
from ..params import AcqParams, Curves, FPN_SEGMENTS, FpnMode, FpnState, ProcConfig

AXIS_HOST = "host"
AXIS_BSCAN = "bscan"
AXIS_ASCAN = "ascan"


class Mesh:
    """Named axes over an array of ``torch.device``.

    ``devices``: nested sequence or array of devices in the axes' order; a
    device may appear in several positions.  ``process_index``: on a mesh
    whose host axis spans processes, the host row this process owns (its
    positions are the local ones); None when every position belongs to this
    process.  ``group``: the ``torch.distributed`` group the host axis
    reduces over, or None.
    """

    def __init__(self, devices, axis_names: Sequence[str], *,
                 process_index: Optional[int] = None, group=None):
        given = np.asarray(devices, dtype=object)
        self.devices = np.array([torch.device(d) for d in given.flat],
                                dtype=object).reshape(given.shape)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d device array for axes {self.axis_names}")
        self.shape: Dict[str, int] = dict(zip(self.axis_names, self.devices.shape))
        self.process_index = process_index
        self.group = group

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def _axis(self, name: str) -> int:
        return self.shape.get(name, 1)

    def local_positions(self) -> List[Tuple[int, int, torch.device]]:
        """(global B-scan block, A-scan block, device) of every position this
        process owns, host-major."""
        arr = self.devices.reshape(self._axis(AXIS_HOST), self._axis(AXIS_BSCAN),
                                   self._axis(AXIS_ASCAN))
        hosts = (range(arr.shape[0]) if self.process_index is None
                 else [self.process_index])
        return [(h * arr.shape[1] + b, a, arr[h, b, a])
                for h in hosts for b in range(arr.shape[1]) for a in range(arr.shape[2])]

    @property
    def local_devices(self) -> List[torch.device]:
        """This process's distinct devices, in mesh order."""
        return list(dict.fromkeys(d for _, _, d in self.local_positions()))

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices={[str(d) for d in self.devices.reshape(-1)]}"
                + (f", process {self.process_index}" if self.process_index is not None else "")
                + ")")


def _cuda_devices() -> List[torch.device]:
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(
    n_bscan_shards: Optional[int] = None,
    n_ascan_shards: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A (bscan, ascan) mesh over ``devices`` (default: the local CUDA
    devices, never the CPU; pass e.g. ``[torch.device("cpu")] * 8`` for a
    CPU mesh).  Too few devices is an error."""
    devices = list(_cuda_devices() if devices is None else devices)
    if n_bscan_shards is None:
        n_bscan_shards = len(devices) // n_ascan_shards
    n = n_bscan_shards * n_ascan_shards
    if n < 1 or n > len(devices):
        raise ValueError(f"mesh {n_bscan_shards}x{n_ascan_shards} needs {n} devices, "
                         f"have {len(devices)}")
    return Mesh(np.array(devices[:n], dtype=object).reshape(n_bscan_shards, n_ascan_shards),
                (AXIS_BSCAN, AXIS_ASCAN))


def buffer_pspec(mesh: Mesh) -> Tuple:
    """How a raw or processed buffer splits on ``mesh``: B-scans over the
    (host-major) leading axes, A-scans over the fast axis -- JAX's
    PartitionSpec as a tuple of axis names per dimension."""
    if AXIS_HOST in mesh.axis_names:
        return ((AXIS_HOST, AXIS_BSCAN), AXIS_ASCAN, None)
    return (AXIS_BSCAN, AXIS_ASCAN, None)


def wire_bscan_pspec(mesh: Mesh) -> Tuple:
    """How a B-scan-granular packed wire buffer ((bscans, bytes_per_bscan))
    splits: B-scan axes only, each row's bytes whole on every position of
    the row (the fallback wire layout for line lengths that are not
    256-sample aligned, ``FdOctModel.put_packed_buffer``)."""
    if AXIS_HOST in mesh.axis_names:
        return ((AXIS_HOST, AXIS_BSCAN), None)
    return (AXIS_BSCAN, None)


def _block_sizes(shape: Sequence[int], mesh: Mesh) -> Tuple[int, int]:
    n_b = mesh._axis(AXIS_HOST) * mesh._axis(AXIS_BSCAN)
    n_a = mesh._axis(AXIS_ASCAN)
    if shape[0] % n_b or shape[1] % n_a:
        raise ValueError(f"buffer {tuple(shape[:2])} (bscans, ascans) does not split "
                         f"into {n_b} x {n_a} equal blocks on {mesh.shape}")
    return shape[0] // n_b, shape[1] // n_a


# ---------------------------------------------------------------------------
# Sharded buffers
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardedBuffer:
    """A buffer split over a mesh: its global ``shape`` and ``dtype``, and
    this process's blocks as ``(index, tensor)``, ``index`` a tuple of
    slices over the leading (split) dimensions of the global buffer."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    mesh: Mesh
    shards: Tuple[Tuple[Tuple[slice, ...], torch.Tensor], ...]

    @property
    def is_fully_addressable(self) -> bool:
        """True when this process holds every block."""
        return self.mesh.process_index is None

    def map(self, fn) -> "ShardedBuffer":
        """``fn`` on every block (same leading dimensions), as a new buffer."""
        shards = tuple((idx, fn(t)) for idx, t in self.shards)
        k = len(shards[0][0])
        t0 = shards[0][1]
        return ShardedBuffer(tuple(self.shape[:k]) + tuple(t0.shape[k:]), t0.dtype,
                             self.mesh, shards)


def row_blocks(buf: ShardedBuffer) -> List[Tuple[slice, torch.Tensor]]:
    """This process's blocks joined into whole B-scan rows, in B-scan order:
    a row's A-scan blocks concatenated on its first block's device (one
    copy of a block where the row is split), each row contiguous."""
    rows: Dict[Tuple[int, int], Dict] = {}
    for idx, t in buf.shards:
        a0 = idx[1].start if len(idx) > 1 else 0  # a wire row is whole on each position
        rows.setdefault((idx[0].start, idx[0].stop), {}).setdefault(a0, t)
    out = []
    for (b0, b1), parts in sorted(rows.items()):
        ts = [parts[a] for a in sorted(parts)]
        home = ts[0].device
        out.append((slice(b0, b1), ts[0] if len(ts) == 1
                    else torch.cat([t.to(home) for t in ts], dim=1)))
    return out


def blocks(x) -> List[torch.Tensor]:
    """The tensors of a device buffer: a sharded buffer's blocks, or the
    tensor itself."""
    return [t for _, t in x.shards] if isinstance(x, ShardedBuffer) else [x]


def per_shard(fn, x):
    """``fn`` on each block of a sharded buffer, or on a whole tensor."""
    return x.map(fn) if isinstance(x, ShardedBuffer) else fn(x)


def device_context(device: torch.device):
    """Make ``device`` current for the launches in the block (CUDA only)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def place(block, device: torch.device) -> torch.Tensor:
    """A host or device block on ``device``: to a CUDA device a non-blocking
    copy on the device's current stream from pinned memory (the block
    itself when pinned already, else a pinned copy)."""
    if isinstance(block, torch.Tensor):
        if block.device == device:
            return block.contiguous()
        if block.device.type != "cpu":
            return block.to(device).contiguous()
        host = block.contiguous()
    else:
        host = torch.from_numpy(np.ascontiguousarray(block))
    if device.type != "cuda":
        return host.to(device)
    if not host.is_pinned():
        host = host.pin_memory()
    return host.to(device, non_blocking=True)


def split_buffer(x, mesh: Mesh, global_shape: Sequence[int],
                 first_bscan: int = 0) -> ShardedBuffer:
    """This process's blocks of a (bscans, ascans, ...) buffer, each placed
    on its position's device.  ``x`` holds the global B-scans from
    ``first_bscan`` on (the whole buffer, or this process's block of it)."""
    global_shape = tuple(global_shape)
    bs, as_ = _block_sizes(global_shape, mesh)
    shards = []
    for ib, ia, dev in mesh.local_positions():
        b0, a0 = ib * bs, ia * as_
        if not 0 <= b0 - first_bscan < x.shape[0]:
            raise ValueError(f"B-scan block {b0}:{b0 + bs} is not in the fed block "
                             f"{first_bscan}:{first_bscan + x.shape[0]}")
        with device_context(dev):
            t = place(x[b0 - first_bscan:b0 - first_bscan + bs, a0:a0 + as_], dev)
        shards.append(((slice(b0, b0 + bs), slice(a0, a0 + as_)), t))
    return ShardedBuffer(global_shape, shards[0][1].dtype, mesh, tuple(shards))


def shard_buffer(x, mesh: Mesh) -> ShardedBuffer:
    """A whole buffer (numpy or tensor) split onto ``mesh``; on a mesh that
    spans processes, this process's blocks of it."""
    if isinstance(x, ShardedBuffer):
        return x
    return split_buffer(x, mesh, tuple(x.shape))


def global_background(buf: ShardedBuffer) -> torch.Tensor:
    """Mean A-scan of the whole buffer (``ops.postprocess.get_background``
    over every shard, and over processes on a mesh that spans them), on the
    mesh's first local device."""
    dev = buf.mesh.local_devices[0]
    total = None
    for _, t in buf.shards:
        part = t.to(torch.float32).sum(dim=(0, 1)).to(dev)
        total = part if total is None else total + part
    if buf.mesh.group is not None:
        import torch.distributed as dist

        dist.all_reduce(total, group=buf.mesh.group)
    return total / float(buf.shape[0] * buf.shape[1])


# ---------------------------------------------------------------------------
# Transfer tally
# ---------------------------------------------------------------------------

class Tally:
    """Running totals of the cross-shard or cross-process transfers the
    sharded step makes, per ``op`` ("all_reduce": the FPN statistics,
    counted once per reduction with the float32 payload each participant
    contributes, as JAX's HLO tally counts a psum; "row_gather" /
    "row_scatter": the bytes moved between mesh positions for an
    A-scan-split row) and ``via`` (the ``torch.distributed`` backend, or
    "local" inside the process): a count and a byte total each, so the
    tally stays the same size over a stream of any length."""

    def __init__(self):
        self._totals: Dict[Tuple[str, str], List[int]] = {}

    def record(self, op: str, nbytes: int, via: str = "local") -> None:
        total = self._totals.setdefault((op, via), [0, 0])
        total[0] += 1
        total[1] += int(nbytes)

    def summary(self) -> Dict:
        """``collectives``: one entry per (op, via) with its ``count`` and
        ``bytes``; ``by_op``: bytes per op; ``total_bytes``."""
        by_op: Dict[str, int] = {}
        for (op, _), (_, nbytes) in self._totals.items():
            by_op[op] = by_op.get(op, 0) + nbytes
        return {"collectives": [{"op": op, "via": via, "count": n, "bytes": b}
                                for (op, via), (n, b) in self._totals.items()],
                "by_op": by_op, "total_bytes": sum(by_op.values())}


# ---------------------------------------------------------------------------
# Sharded fixed-pattern-noise statistics
# ---------------------------------------------------------------------------

def _noise_rows(acq: AcqParams, cfg: ProcConfig, mesh: Mesh):
    """Per local position, its noise lines as (local line indices on its
    device, [(segment, start, stop), ...] spans of those lines), or None
    where it holds none.  Lines are B-scan major, A-scan minor, so an
    A-scan shard's lines are not contiguous: the global line index decides
    the segment.  Global indices grow with the local order, so each
    segment's lines are one span of the selected lines."""
    n_noise = min(cfg.bscans_for_noise, acq.bscans_per_buffer) * acq.ascans_per_bscan
    seg_width = max(n_noise // FPN_SEGMENTS, 1)
    bs, as_ = _block_sizes(acq.buffer_shape, mesh)
    rows = []
    for ib, ia, dev in mesh.local_positions():
        g = ((ib * bs + np.arange(bs))[:, None] * acq.ascans_per_bscan
             + ia * as_ + np.arange(as_)[None, :]).reshape(-1)
        local = np.nonzero(g < FPN_SEGMENTS * seg_width)[0]
        if local.size == 0:
            rows.append(None)
            continue
        seg = g[local] // seg_width
        cuts = np.flatnonzero(np.diff(seg)) + 1
        starts = np.concatenate([[0], cuts])
        stops = np.concatenate([cuts, [seg.size]])
        rows.append((torch.as_tensor(local, dtype=torch.int64, device=dev),
                     [(int(seg[a]), int(a), int(b)) for a, b in zip(starts, stops)]))
    return rows, seg_width


def _sharded_fpn_mean_line(zs, noise_rows, seg_width: int, acq: AcqParams,
                           cfg: ProcConfig, mesh: Mesh, tally: Tally
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The minimum-variance mean line from the shards' combined segment
    sums.  ``zs``: per local position (z_re, z_im) float32 (b, a, half).
    Numerics of getMinimumVarianceMean (cuda_code.cu:523-565) over the
    first ``bscans_for_noise * ascans_per_bscan`` GLOBAL lines.  Returns
    (mean_re, mean_im) on the mesh's first local device."""
    n_noise = min(cfg.bscans_for_noise, acq.bscans_per_buffer) * acq.ascans_per_bscan
    if n_noise < FPN_SEGMENTS:
        # same contract as ops/fpn.py: with empty segments the zero
        # variance would win the argmin and silently disable FPN
        raise ValueError(
            f"fixed-pattern-noise determination needs at least {FPN_SEGMENTS} "
            f"A-scans (have {n_noise}: bscans_for_noise="
            f"{cfg.bscans_for_noise} x {acq.ascans_per_bscan} A-scans/B-scan)")
    half = acq.output_ascan_length
    home = mesh.local_devices[0]
    total = torch.zeros((3, FPN_SEGMENTS, half), dtype=torch.float32, device=home)
    for (z_re, z_im), rows in zip(zs, noise_rows):
        if rows is None:
            continue
        lines, spans = rows
        re = z_re.reshape(-1, half).index_select(0, lines)
        im = z_im.reshape(-1, half).index_select(0, lines)
        terms = torch.stack([re, im, re * re + im * im])      # (3, lines, half)
        # one plain sum per segment span: deterministic, unlike atomics
        part = torch.zeros((3, FPN_SEGMENTS, half), dtype=torch.float32, device=re.device)
        for seg, a, b in spans:
            part[:, seg] = terms[:, a:b].sum(dim=1)
        total += part.to(home)
    if mesh.group is not None:
        import torch.distributed as dist

        dist.all_reduce(total, group=mesh.group)
        tally.record("all_reduce", total.numel() * total.element_size(),
                     via=dist.get_backend(mesh.group))
    elif mesh.size > 1:
        tally.record("all_reduce", total.numel() * total.element_size())
    return _fpn.select_min_variance_mean_planar(total[0], total[1], total[2], seg_width)


# ---------------------------------------------------------------------------
# Sharded step
# ---------------------------------------------------------------------------

def _moved(value, device: torch.device):
    """A curve field (tensor, operator parts, OnePass) on ``device``."""
    from ..kernels.fused_prep import OnePass

    if isinstance(value, torch.Tensor):
        return value.to(device)
    if isinstance(value, OnePass):
        split = value.__dict__.get("split")  # the bf16 parts, once made
        return OnePass(value[0].to(device),
                       None if split is None else [s.to(device) for s in split])
    if isinstance(value, tuple):
        return tuple(_moved(v, device) for v in value)
    return value


def curves_on(curves: Curves, devices: Sequence[torch.device]) -> Dict[torch.device, Curves]:
    """One copy of the curves' device fields on each distinct device (the
    fields already there are shared, not copied)."""
    return {dev: Curves(**{f.name: _moved(getattr(curves, f.name), dev)
                           for f in dataclasses.fields(Curves)})
            for dev in dict.fromkeys(devices)}


def _core_local(raw: torch.Tensor, curves: Curves, acq: AcqParams, cfg: ProcConfig):
    """One shard's decode .. depth profiles before FPN, on its device:
    planar (z_re, z_im) float32 (b, a, half)."""
    if cfg.fft_via_matmul:
        from ..kernels.fused_prep import fused_depth_transform

        return fused_depth_transform(raw, *_pipeline.depth_operators(curves), acq, cfg)
    z = _pipeline.transform_to_depth(_pipeline.prep_spectra(raw, curves, acq, cfg),
                                     acq.output_ascan_length)
    return z.real, z.imag


def _postprocess_rows(mags: List[torch.Tensor], index, curves: Dict, acq: AcqParams,
                      cfg: ProcConfig, mesh: Mesh, tally: Tally) -> List[torch.Tensor]:
    """The post stages on every shard.  The flip keys on the global B-scan
    parity; the sinusoidal correction's last-A-scan guard applies only on
    the shard holding the buffer's last B-scan and last A-scan.  On an
    A-scan-split mesh both need the whole row, which is gathered on the
    row's first shard's device and scattered back (tallied)."""
    out = list(mags)
    if cfg.bscan_flip or cfg.sinusoidal_correction:
        rows: Dict[int, List[int]] = {}
        for k, (bsl, _) in enumerate(index):
            rows.setdefault(bsl.start, []).append(k)
        for b0, ks in rows.items():
            ks.sort(key=lambda k: index[k][1].start)
            home = out[ks[0]].device
            row = (out[ks[0]] if len(ks) == 1
                   else torch.cat([out[k].to(home) for k in ks], dim=1))
            moved = sum(out[k].numel() * out[k].element_size() for k in ks[1:])
            if moved:
                tally.record("row_gather", moved)
            with device_context(home):
                if cfg.bscan_flip:
                    row = _postprocess.bscan_flip(row, first_bscan=b0)
                if cfg.sinusoidal_correction:
                    last = index[ks[0]][0].stop == acq.bscans_per_buffer
                    row = _postprocess.sinusoidal_correction(
                        row, curves[home].sinusoidal_curve, guard_last=last)
            for k in ks:
                a = index[k][1]
                out[k] = (row if len(ks) == 1
                          else row[:, a.start:a.stop].to(out[k].device).contiguous())
            if moved:
                tally.record("row_scatter", moved)
    if cfg.post_background_removal:
        for k, m in enumerate(out):
            with device_context(m.device):
                out[k] = _postprocess.remove_post_background(
                    m, curves[m.device].post_background, cfg.post_background_weight,
                    cfg.post_background_offset)
    return out


class _ShardedStep:
    """The sharded step for a fixed (acq, cfg, mesh): the static shard
    geometry, the per-device curve copies (made again only when the caller
    passes other curves), the per-device FPN mean line and the tally."""

    def __init__(self, acq: AcqParams, cfg: ProcConfig, mesh: Mesh):
        self.acq, self.cfg, self.mesh = acq, cfg, mesh
        _block_sizes(acq.buffer_shape, mesh)
        self.tally = Tally()
        self._noise = None
        self._curves: Tuple = (None, None)
        self._mean: Tuple = (None, None)

    def _curves_on(self, curves: Curves) -> Dict[torch.device, Curves]:
        if self._curves[0] is not curves:
            self._curves = (curves, curves_on(curves, self.mesh.local_devices))
        return self._curves[1]

    def _mean_on(self, mean: torch.Tensor) -> Dict[torch.device, torch.Tensor]:
        if self._mean[0] is not mean:
            self._mean = (mean, {d: mean.to(d) for d in self.mesh.local_devices})
        return self._mean[1]

    def __call__(self, raw, curves: Curves, fpn_state: FpnState):
        acq, cfg, mesh = self.acq, self.cfg, self.mesh
        raw = shard_buffer(raw, mesh)
        if tuple(raw.shape) != tuple(acq.buffer_shape):
            raise ValueError(f"raw buffer {tuple(raw.shape)} != {acq.buffer_shape}")
        cv = self._curves_on(curves)
        index = [idx for idx, _ in raw.shards]
        if _pipeline.fused_ready(cfg, fpn_state):
            # the steady-state kernel on every shard; OFF ignores any
            # carried state: subtract zeros (pipeline.py)
            from ..kernels.fused_prep import fused_depth_scale

            mean = (torch.zeros_like(fpn_state.mean_line) if cfg.fpn_mode == FpnMode.OFF
                    else fpn_state.mean_line)
            means = self._mean_on(mean)
            mags = []
            for _, t in raw.shards:
                c = cv[t.device]
                with device_context(t.device):
                    mags.append(fused_depth_scale(
                        t, *_pipeline.depth_operators(c), means[t.device], acq,
                        _pipeline.kernel_config(cfg), wide=c.depth_concat_parts))
        else:
            zs = []
            for _, t in raw.shards:
                with device_context(t.device):
                    zs.append(_core_local(t, cv[t.device], acq, cfg))
            if cfg.fpn_mode != FpnMode.OFF:
                if cfg.fpn_mode == FpnMode.CONTINUOUS or not fpn_state.determined:
                    if self._noise is None:
                        self._noise = _noise_rows(acq, cfg, mesh)
                    mean_line = FpnState.pack(*_sharded_fpn_mean_line(
                        zs, *self._noise, acq, cfg, mesh, self.tally))
                else:  # ONCE, determined (cuda_code.cu:1521-1524)
                    mean_line = fpn_state.mean_line
                fpn_state = FpnState(mean_line=mean_line, determined=True)
                means = self._mean_on(mean_line)
                zs = [(re - means[re.device][0], im - means[re.device][1]) for re, im in zs]
            scale = (_postprocess.scale_log_planar if cfg.log_scaling
                     else _postprocess.scale_lin_planar)
            mags = [scale(re, im, acq.output_ascan_length, cfg.grayscale_min,
                          cfg.grayscale_max, cfg.addend, cfg.multiplicator)
                    for re, im in zs]
            del zs
        if _pipeline.has_post(cfg):
            mags = _postprocess_rows(mags, index, cv, acq, cfg, mesh, self.tally)
        mags = [_pipeline.narrow(m, cfg) for m in mags]
        out = ShardedBuffer(tuple(acq.processed_buffer_shape), mags[0].dtype, mesh,
                            tuple(zip(index, mags)))
        return out, fpn_state


def sharded_process_buffer(
    raw,
    curves: Curves,
    fpn_state: FpnState,
    acq: AcqParams,
    cfg: ProcConfig,
    mesh: Mesh,
) -> Tuple[ShardedBuffer, FpnState]:
    """Sharded counterpart of ``pipeline.process_buffer``.

    raw: a :class:`ShardedBuffer` of uint (bscans, ascans, samples) on
    ``mesh``, or the whole buffer (split here).  Returns the processed
    (bscans, ascans, samples//2) buffer with the same split, and the FPN
    state (its mean line on the mesh's first local device).  The curves
    are copied to the shard devices per call; :func:`make_sharded_step`
    keeps the copies."""
    return _ShardedStep(acq, cfg, mesh)(raw, curves, fpn_state)


def make_sharded_step(acq: AcqParams, cfg: ProcConfig, mesh: Mesh):
    """``step(raw, curves, fpn_state) -> (processed, fpn_state)`` on
    ``mesh`` for a fixed (acq, cfg): single-process (bscan, ascan) meshes
    and (host, bscan, ascan) meshes alike.  The step keeps one copy of the
    consumed curve fields on each distinct shard device, made again when
    it is passed other curves, never per buffer, and a :class:`Tally` of
    its transfers as ``step.tally``."""
    return _ShardedStep(acq, cfg, mesh)
