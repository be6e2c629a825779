"""The host axis on ``torch.distributed``: process groups, per-process feeds.

Counterpart of ``octproz_tpu/parallel/multihost.py`` (there on
``jax.distributed``):

* :func:`initialize` -- ``torch.distributed.init_process_group`` with this
  process's devices, taken from its place among its node's ranks: NCCL
  when every rank has cards of its own, gloo on the CPU and for ranks that
  share a card (NCCL refuses two ranks on one
  GPU; gloo reduces CUDA tensors for all_reduce and broadcast only, so
  everything else crosses processes in host tensors).
* :func:`make_multihost_mesh` -- a (host, bscan, ascan) mesh whose row
  ``p`` holds exactly the devices of process ``p``; only the host-axis
  reduction (the FPN statistics) crosses processes.
* :func:`local_bscan_range` / :func:`feed_from_local` /
  :func:`feed_wire_from_local` -- each process feeds its own contiguous
  block of B-scans: raw samples never cross processes.
* :func:`local_block` / :func:`fetch` -- the device-to-host side: each
  process assembles only its own output blocks.

The sharded step itself (``parallel.sharding``) detects the host axis and
extends the FPN reduction over it, so one code path serves one process and
many.  Run ``python -m octproz_tpu_torch.parallel.multihost --selftest``
under two processes (``--rank``, ``--world``, ``--init``; on one node with
``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` set as ``torchrun`` sets them) for
a small parity check of two ranks against the single-device pipeline.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..params import AcqParams
from .sharding import (AXIS_ASCAN, AXIS_BSCAN, AXIS_HOST, Mesh, ShardedBuffer,
                       _block_sizes, device_context, place, row_blocks, split_buffer)

_LOCAL_DEVICES: List[torch.device] = []


def initialize(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    platform: Optional[str] = None,
    local_device_count: Optional[int] = None,
    cpu_collectives: str = "gloo",
) -> None:
    """Join the process group; call once per process before
    :func:`make_multihost_mesh`.

    ``coordinator_address``: ``host:port`` (``tcp://`` is added) or a full
    init method such as ``file:///path``.  ``platform="cpu"``: this rank's
    devices are ``local_device_count`` copies of the CPU device and the
    collectives are ``cpu_collectives``.  Otherwise the rank takes CUDA
    devices of its own node, chosen by :func:`local_cuda_choice` from its
    place among the node's ranks: ``LOCAL_RANK`` of ``LOCAL_WORLD_SIZE``
    as ``torchrun`` sets them (unset: one rank per node, which takes all
    the node's cards).
    Without a CUDA device that is an error, never a move to the CPU.
    """
    import torch.distributed as dist

    if platform == "cpu":
        devices = [torch.device("cpu")] * int(local_device_count or 1)
        chosen = cpu_collectives
    else:
        devices, chosen = local_cuda_choice(
            torch.cuda.device_count(), int(os.environ.get("LOCAL_RANK", 0)),
            int(os.environ.get("LOCAL_WORLD_SIZE", 1)), local_device_count)
        torch.cuda.set_device(devices[0])
    init = coordinator_address if "://" in coordinator_address \
        else f"tcp://{coordinator_address}"
    dist.init_process_group(chosen, init_method=init,
                            world_size=num_processes, rank=process_id)
    _LOCAL_DEVICES[:] = devices


def local_cuda_choice(n_cards: int, local_rank: int, local_world_size: int,
                      local_device_count: Optional[int] = None
                      ) -> Tuple[List[torch.device], str]:
    """This rank's CUDA devices and backend from its node alone: rank
    ``local_rank`` of the node's ``local_world_size`` ranks on its
    ``n_cards`` cards takes ``local_device_count`` of them (default: an
    equal share, at least one), the ``local_rank``-th such block.  NCCL when
    the node's ranks own distinct cards, else gloo (NCCL refuses two ranks
    on one GPU) with the ranks sharing cards round-robin.  Every node is
    taken to have the same layout, so every rank picks the same backend."""
    if n_cards == 0:
        raise RuntimeError("multihost.initialize: no CUDA device is available; "
                           "pass platform='cpu' for a CPU process group")
    if not 0 <= local_rank < local_world_size:
        raise ValueError(f"local rank {local_rank} is not in [0, {local_world_size})")
    per = int(local_device_count or max(1, n_cards // local_world_size))
    first = local_rank * per
    devices = [torch.device("cuda", (first + i) % n_cards) for i in range(per)]
    return devices, "nccl" if n_cards >= local_world_size * per else "gloo"


def local_devices() -> List[torch.device]:
    """This process's devices as :func:`initialize` chose them."""
    if not _LOCAL_DEVICES:
        raise RuntimeError("multihost.initialize has not been called")
    return list(_LOCAL_DEVICES)


def make_multihost_mesh(
    n_ascan_shards: int = 1,
    devices: Optional[Sequence[torch.device]] = None,
) -> Mesh:
    """(host, bscan, ascan) mesh over every process's devices, host-major:
    row ``p`` holds exactly process ``p``'s devices (gathered with
    ``all_gather_object``), split between the B-scan and A-scan axes."""
    import torch.distributed as dist

    devices = [torch.device(d) for d in (devices if devices is not None
                                         else local_devices())]
    world, rank = dist.get_world_size(), dist.get_rank()
    rows: List = [None] * world
    dist.all_gather_object(rows, [str(d) for d in devices])
    counts = {len(r) for r in rows}
    if len(counts) != 1:
        raise ValueError(f"unequal devices per process: "
                         f"{ {p: len(r) for p, r in enumerate(rows)} }")
    per_host = counts.pop()
    if per_host % n_ascan_shards:
        raise ValueError(f"{per_host} devices/host not divisible by "
                         f"n_ascan_shards={n_ascan_shards}")
    arr = np.empty((world, per_host), dtype=object)
    for p, row in enumerate(rows):
        arr[p, :] = [torch.device(d) for d in row]
    return Mesh(arr.reshape(world, per_host // n_ascan_shards, n_ascan_shards),
                (AXIS_HOST, AXIS_BSCAN, AXIS_ASCAN), process_index=rank,
                group=dist.group.WORLD)


def make_simulated_multihost_mesh(
    n_hosts: int,
    n_bscan_shards: Optional[int] = None,
    n_ascan_shards: int = 1,
    devices: Optional[Sequence[torch.device]] = None,
) -> Mesh:
    """A (host, bscan, ascan) mesh in this one process (default devices:
    the local CUDA devices, never the CPU): the host axis exists, so the
    host-major layout and the host-spanning reduction run, but every "host"
    is local."""
    from .sharding import _cuda_devices

    devices = list(_cuda_devices() if devices is None else devices)
    if n_bscan_shards is None:
        n_bscan_shards = len(devices) // (n_hosts * n_ascan_shards)
    n = n_hosts * n_bscan_shards * n_ascan_shards
    if n < 1 or n > len(devices):
        raise ValueError(f"mesh {n_hosts}x{n_bscan_shards}x{n_ascan_shards} "
                         f"needs {n} devices, have {len(devices)}")
    return Mesh(np.array(devices[:n], dtype=object).reshape(n_hosts, n_bscan_shards,
                                                            n_ascan_shards),
                (AXIS_HOST, AXIS_BSCAN, AXIS_ASCAN))


def local_bscan_range(acq: AcqParams, mesh: Mesh,
                      process_index: Optional[int] = None) -> Tuple[int, int]:
    """[start, stop) of the buffer's B-scans this process feeds: its
    host row's contiguous block, or everything on a mesh in one process."""
    if AXIS_HOST not in mesh.axis_names or mesh.process_index is None:
        return 0, acq.bscans_per_buffer
    n_hosts = mesh.shape[AXIS_HOST]
    shards0 = n_hosts * mesh.shape[AXIS_BSCAN]
    if acq.bscans_per_buffer % shards0:
        raise ValueError(f"bscans_per_buffer={acq.bscans_per_buffer} not "
                         f"divisible by {shards0} B-scan shards")
    per_host = acq.bscans_per_buffer // n_hosts
    p = mesh.process_index if process_index is None else process_index
    return p * per_host, (p + 1) * per_host


def feed_from_local(raw_local, acq: AcqParams, mesh: Mesh) -> ShardedBuffer:
    """This process's raw B-scan block (uint (bscans / n_hosts, ascans,
    samples), as :func:`local_bscan_range` assigns it) as its blocks of the
    global buffer, each on its device.  No raw data crosses processes."""
    start, stop = local_bscan_range(acq, mesh)
    want = (stop - start,) + tuple(acq.buffer_shape[1:])
    if tuple(raw_local.shape) != want:
        raise ValueError(f"local block shape {tuple(raw_local.shape)} != "
                         f"this host's shard {want}")
    return split_buffer(raw_local, mesh, acq.buffer_shape, first_bscan=start)


def feed_wire_from_local(wire_local, acq: AcqParams, mesh: Mesh,
                         per_line: bool = True) -> ShardedBuffer:
    """This process's packed-12 wire bytes as its blocks of the global wire
    buffer (packing is line-local, so a B-scan block's bytes stand alone).

    ``per_line=True``: global shape (bscans, ascans, 1.5 * samples), split
    like the buffer.  ``per_line=False`` (line length not 256-sample
    aligned): global shape (bscans, bytes_per_bscan), split over the
    B-scan axes only, each row's bytes on every position of its row."""
    bpl = acq.samples_per_line * 3 // 2
    start, stop = local_bscan_range(acq, mesh)
    if isinstance(wire_local, torch.Tensor):
        wire_local = wire_local.reshape(-1)
    else:
        wire_local = np.asarray(wire_local, np.uint8).reshape(-1)
    if per_line:
        local = wire_local.reshape(stop - start, acq.ascans_per_bscan, bpl)
        return split_buffer(local, mesh, (acq.bscans_per_buffer,) + tuple(local.shape[1:]),
                            first_bscan=start)
    local = wire_local.reshape(stop - start, acq.ascans_per_bscan * bpl)
    bs, _ = _block_sizes(acq.buffer_shape, mesh)
    shards = []
    for ib, _, dev in mesh.local_positions():
        b0 = ib * bs
        with device_context(dev):
            shards.append(((slice(b0, b0 + bs),), place(local[b0 - start:b0 - start + bs], dev)))
    return ShardedBuffer((acq.bscans_per_buffer, local.shape[1]), shards[0][1].dtype,
                         mesh, tuple(shards))


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)  # numpy has no bfloat16
    return t.cpu().numpy()


def local_block(arr: ShardedBuffer) -> Tuple[np.ndarray, int]:
    """This process's blocks of a dim-0-split buffer assembled into one
    contiguous host block: (block, its first index along dim 0).  Each
    process fetches only its own output; nothing crosses processes.  The
    blocks are joined into rows on the device and copied once each into
    the host block."""
    rows = row_blocks(arr)
    lo = rows[0][0].start
    block = torch.empty((rows[-1][0].stop - lo,) + tuple(arr.shape[1:]), dtype=arr.dtype)
    for b, t in rows:
        block[b.start - lo:b.stop - lo].copy_(t)
    return _host(block), lo


def fetch(arr) -> np.ndarray:
    """Device-to-host fetch: the whole buffer when this process holds every
    block (or for a plain tensor), else this process's block."""
    if isinstance(arr, ShardedBuffer):
        return local_block(arr)[0]
    return _host(arr)


# ---------------------------------------------------------------------------
# Self-test: python -m octproz_tpu_torch.parallel.multihost --selftest ...
# ---------------------------------------------------------------------------

def _selftest(rank: int, world: int, init: str, platform: Optional[str],
              full: bool = False) -> dict:
    """One rank of a multi-process check: ``FdOctModel`` on a
    (host, bscan, ascan) mesh takes this rank's B-scan block of three
    seeded buffers (the FPN buffer and two steady ones) and its fetched
    block is held to a single-device model on the same buffers (2e-4; the
    mean line 1e-4/1e-5); the FPN statistics cross the processes in one
    all_reduce.  Small: 128 x 32 x 10 samples, the full chain with every
    post stage on the fold path, two devices per rank on the A-scan axis
    (of two ranks, rank 1's block starts at the odd B-scan 5; the noise
    lines span both ranks), the reference on the CPU.  ``full``: the
    benchmark chain on 1024 x 512 x 256 buffers, one device per rank, the
    reference on the rank's device.  Returns (and prints as JSON) the
    rank's readings."""
    import json

    import torch.distributed as dist

    from .. import bench
    from ..kernels import fused_prep as fp
    from ..models.fdoct import FdOctModel
    from ..params import FpnMode, Interpolation, ProcConfig

    initialize(init, world, rank, platform=platform, local_device_count=1 if full else 2)
    if full:
        acq, cfg, kw, n_ascan = bench.FULL_ACQ, bench.bench_config(), bench.CURVE_KW, 1
    else:
        acq = AcqParams(samples_per_line=128, ascans_per_bscan=32, bscans_per_buffer=10,
                        bit_depth=12)
        cfg = ProcConfig(bitshift=True, resampling=True, interpolation=Interpolation.CUBIC,
                         windowing=True, dispersion=True, fpn_mode=FpnMode.ONCE,
                         bscans_for_noise=6, log_scaling=True, bscan_flip=True,
                         sinusoidal_correction=True, fft_via_matmul=True)
        kw = dict(resample_coeffs=(0.0, 127.0, 14.0, -9.0),
                  dispersion_coeffs=(0.0, 2.0, -13.0, 7.0))
        n_ascan = 2
    model = FdOctModel(acq, cfg, **kw, mesh=make_multihost_mesh(n_ascan_shards=n_ascan))
    assert model.is_multihost == (world > 1)
    ref = FdOctModel(acq, cfg, **kw, device=model.device if full else "cpu")
    lo, hi = local_bscan_range(acq, model.mesh)
    assert (hi - lo) * world == acq.bscans_per_buffer, (lo, hi)
    rng = np.random.default_rng(7)  # the same seed on every rank: one volume
    raws = [rng.integers(0, 4095, size=acq.buffer_shape, dtype=np.uint16) for _ in range(3)]
    fp.reset_launch_counts()
    got = [local_block(model.process_buffer(raw[lo:hi])) for raw in raws]
    launches = {k: v for k, v in fp.LAUNCHES.items() if v}  # the sharded model's alone
    worst = 0.0
    for (block, start), raw in zip(got, raws):
        want = ref.fetch(ref.process_buffer(raw))[lo:hi]
        assert start == lo, (start, lo)
        np.testing.assert_allclose(block, want, rtol=2e-4, atol=2e-4)
        fin = np.isfinite(want)
        worst = max(worst, float(np.abs(block[fin] - want[fin]).max()))
    np.testing.assert_allclose(model.fpn_state.mean_line.cpu().numpy(),
                               ref.fpn_state.mean_line.cpu().numpy(), rtol=1e-4, atol=1e-5)
    tally = model._exec[2].tally.summary()
    reduced = tally["by_op"].get("all_reduce", 0)
    assert reduced == 9 * acq.output_ascan_length * 3 * 4, tally
    result = {"rank": rank, "world": world, "bscans": [lo, hi], "max_abs_diff": worst,
              "all_reduce_bytes": reduced, "via": dist.get_backend(),
              "launches": launches,
              "routes": {k: {r: n for r, n in v.items() if n}
                         for k, v in fp.ONE_PASS_ROUTES.items() if any(v.values())}}
    print(f"multihost rank {rank}/{world}: parity OK, all_reduce {reduced} B "
          f"via {dist.get_backend()}", flush=True)
    print(json.dumps(result), flush=True)
    dist.destroy_process_group()
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="multi-process self-test of the sharded step")
    p.add_argument("--selftest", action="store_true", required=True)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, default=2)
    p.add_argument("--init", required=True, help="host:port or file:///path")
    p.add_argument("--platform", default=None, choices=["cpu"])
    p.add_argument("--full", action="store_true",
                   help="the benchmark chain on 1024 x 512 x 256 buffers")
    a = p.parse_args(argv)
    _selftest(a.rank, a.world, a.init, a.platform, a.full)
    return 0


if __name__ == "__main__":
    sys.exit(main())
