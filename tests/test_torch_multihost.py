"""The port's host axis against JAX's, on the CPU.

Mirrors tests/test_multihost.py in two tiers:

1. a simulated host axis in this process: a (host, bscan, ascan) mesh of
   ``[torch.device("cpu")] * 8`` against JAX's simulated mesh on its 8
   virtual devices and the port's single-device step;
2. a real two-process world: ``python -m
   octproz_tpu_torch.parallel.multihost --selftest`` in two subprocesses on
   gloo with a ``file://`` rendezvous in the test's own directory (no port
   to race for under xdist), each rank feeding its B-scan block and holding
   its output block to the single-device pipeline.
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octproz_tpu import curves as jcurves
from octproz_tpu import params as jparams
from octproz_tpu import pipeline as jpipeline
from octproz_tpu.parallel import make_sharded_step as jmake_sharded_step
from octproz_tpu.parallel import make_simulated_multihost_mesh as jmake_simulated
from octproz_tpu_torch import interop
from octproz_tpu_torch import pipeline as tpipeline
from octproz_tpu_torch.curves import consumed_fields
from octproz_tpu_torch.params import AcqParams, FpnMode, Interpolation, ProcConfig
from octproz_tpu_torch.parallel import (AXIS_HOST, Mesh, ShardedBuffer, buffer_pspec,
                                        feed_from_local, feed_wire_from_local, fetch,
                                        local_block, local_bscan_range, make_sharded_step,
                                        make_simulated_multihost_mesh, sharding,
                                        wire_bscan_pspec)
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
CPUS = [CPU] * 8
ACQ = AcqParams(samples_per_line=128, ascans_per_bscan=32, bscans_per_buffer=16, bit_depth=12)
FULL_CFG = ProcConfig(
    bitshift=True,
    background_removal=True, rolling_average_window=16,
    resampling=True, interpolation=Interpolation.CUBIC,
    windowing=True, dispersion=True,
    fpn_mode=FpnMode.ONCE, bscans_for_noise=2,
    log_scaling=True,
    bscan_flip=True, sinusoidal_correction=True,
    post_background_removal=True,
)


def _jax(obj):
    if isinstance(obj, AcqParams):
        return jparams.AcqParams(**dataclasses.asdict(obj))
    enums = {"fpn_mode": jparams.FpnMode, "interpolation": jparams.Interpolation}
    return jparams.ProcConfig(**{
        f.name: (enums[f.name](getattr(obj, f.name).value) if f.name in enums
                 else getattr(obj, f.name)) for f in dataclasses.fields(obj)})


def _raw(rng, acq=ACQ):
    return rng.integers(0, 4095, size=acq.buffer_shape, dtype=np.uint16)


def _curves(cfg, acq=ACQ):
    jc = jcurves.make_curves(_jax(acq), _jax(cfg),
                             resample_coeffs=(0.0, 127.0, 14.0, -9.0),
                             dispersion_coeffs=(0.0, 2.0, -13.0, 7.0),
                             post_background=np.linspace(0.0, 0.2, acq.output_ascan_length,
                                                         dtype=np.float32))
    fields = {f: np.asarray(getattr(jc, f)) for f in consumed_fields(cfg)}
    return jc, interop.curves_from_numpy(fields, CPU)


@pytest.mark.parametrize("path", ["fft", "fold"])
@pytest.mark.parametrize("mesh_shape", [(2, 2, 2), (4, 2, 1), (2, 1, 4)])
def test_simulated_host_axis_parity(rng, mesh_shape, path):
    """(host, bscan, ascan) mesh: JAX's sharded step == the port's ==
    the port's single-device step, over the FPN buffer and two steady ones
    (on the fold path the fused kernel in the steady state)."""
    cfg = FULL_CFG if path == "fft" else dataclasses.replace(
        FULL_CFG, background_removal=False, fft_via_matmul=True)
    jc, tc = _curves(cfg)
    jstep = jmake_sharded_step(_jax(ACQ), _jax(cfg), jmake_simulated(*mesh_shape))
    mesh = make_simulated_multihost_mesh(*mesh_shape, devices=CPUS)
    tstep = make_sharded_step(ACQ, cfg, mesh)
    single = tpipeline.make_step(ACQ, cfg)
    js = jpipeline.initial_fpn_state(_jax(ACQ))
    ts = ss = tpipeline.initial_fpn_state(ACQ, device=CPU)
    for _ in range(3):
        raw = _raw(rng)
        j, js = jstep(jnp.asarray(raw), jc, js)
        t, ts = tstep(raw, tc, ts)
        s, ss = single(torch.from_numpy(raw), tc, ss)
        got = fetch(t)
        np.testing.assert_allclose(got, np.asarray(j), rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(got, s.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(ts.mean_line.numpy(), np.asarray(js.mean_line),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ts.mean_line.numpy(), ss.mean_line.numpy(),
                               rtol=1e-4, atol=1e-5)


def test_buffer_pspec_and_feed_simulated():
    mesh = make_simulated_multihost_mesh(2, 2, 2, devices=CPUS)
    assert buffer_pspec(mesh) == (("host", "bscan"), "ascan", None)
    assert wire_bscan_pspec(mesh) == (("host", "bscan"), None)
    assert local_bscan_range(ACQ, mesh) == (0, ACQ.bscans_per_buffer)  # one process feeds all
    raw = np.arange(np.prod(ACQ.buffer_shape), dtype=np.uint16).reshape(ACQ.buffer_shape)
    arr = feed_from_local(raw, ACQ, mesh)
    assert arr.shape == ACQ.buffer_shape and len(arr.shards) == 8
    block, start = local_block(arr)
    assert start == 0
    np.testing.assert_array_equal(block, raw)
    with pytest.raises(ValueError, match="local block shape"):
        feed_from_local(raw[:8], ACQ, mesh)


def test_local_block_reassembles_sharded_output(rng):
    mesh = make_simulated_multihost_mesh(2, 2, 2, devices=CPUS)
    vals = rng.normal(size=ACQ.processed_buffer_shape).astype(np.float32)
    arr = sharding.shard_buffer(vals, mesh)
    block, start = local_block(arr)
    np.testing.assert_array_equal(block, vals[start:start + block.shape[0]])
    bf16 = arr.map(lambda t: t.to(torch.bfloat16))
    assert fetch(bf16).dtype == np.float32


def _rank_mesh(rank: int) -> Mesh:
    """What make_multihost_mesh gives process ``rank`` of two with two CPU
    devices each (split over the A-scan axis), without a process group."""
    arr = np.empty((2, 1, 2), dtype=object)
    arr[...] = CPU
    return Mesh(arr, (AXIS_HOST, "bscan", "ascan"), process_index=rank)


@pytest.mark.parametrize("rank", [0, 1])
def test_per_process_feed_and_fetch(rng, rank):
    """On a mesh that spans processes each rank owns one host row: its
    B-scan range, its blocks of the raw and of the wire buffer (per line and
    per B-scan), and its output block alone."""
    mesh = _rank_mesh(rank)
    lo, hi = local_bscan_range(ACQ, mesh)
    assert (lo, hi) == (8 * rank, 8 * rank + 8)
    raw = _raw(rng)
    arr = feed_from_local(raw[lo:hi], ACQ, mesh)
    assert not arr.is_fully_addressable and len(arr.shards) == 2
    assert {idx[0].start for idx, _ in arr.shards} == {lo}
    block, start = local_block(arr)
    assert start == lo
    np.testing.assert_array_equal(block, raw[lo:hi])
    np.testing.assert_array_equal(fetch(arr), raw[lo:hi])
    from octproz_tpu_torch import native

    acq = dataclasses.replace(ACQ, samples_per_line=256)
    raw = _raw(rng, acq)
    wire = native.pack_uint12(raw[lo:hi].reshape(-1))
    per_line = feed_wire_from_local(wire, acq, mesh)
    assert per_line.shape == (16, 32, 384) and len(per_line.shards) == 2
    per_bscan = feed_wire_from_local(wire, acq, mesh, per_line=False)
    assert per_bscan.shape == (16, 32 * 384)
    assert [idx for idx, _ in per_bscan.shards] == [(slice(lo, hi),)] * 2  # whole rows


def test_sharded_buffer_is_a_plain_record():
    mesh = make_simulated_multihost_mesh(2, 1, 1, devices=CPUS)
    buf = feed_from_local(np.zeros(ACQ.buffer_shape, np.uint16), ACQ, mesh)
    assert isinstance(buf, ShardedBuffer) and buf.dtype == torch.uint16
    assert buf.map(lambda t: t[..., :4]).shape == (16, 32, 4)


@pytest.mark.parametrize("cards, rank, env, want, backend", [
    # two nodes of 8 cards, one rank per node: each rank takes all its node's cards
    (8, 1, {}, list(range(8)), "nccl"),
    # two nodes of 8 cards, 8 ranks per node: global rank 9 is node 1's second rank
    (8, 9, {"LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "8"}, [1], "nccl"),
    # two nodes of 8 cards, 2 ranks per node: global rank 3 is node 1's second rank
    (8, 3, {"LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2"}, [4, 5, 6, 7], "nccl"),
    # two ranks on one card: NCCL refuses them, gloo shares the card
    (1, 1, {"LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2"}, [0], "gloo"),
])
def test_initialize_takes_devices_from_the_node(monkeypatch, cards, rank, env, want, backend):
    """The rank's cards and backend follow its place among its node's ranks
    (LOCAL_RANK / LOCAL_WORLD_SIZE), not its global rank: a multi-node
    world leaves no card idle and keeps NCCL."""
    import torch.distributed as dist

    from octproz_tpu_torch.parallel import multihost

    calls = {}
    for k in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: calls.setdefault("current", d))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.update(backend=backend, **kw))
    monkeypatch.setattr(multihost, "_LOCAL_DEVICES", [])
    multihost.initialize("host0:9377", 16, rank)
    assert multihost.local_devices() == [torch.device("cuda", i) for i in want]
    assert calls == {"current": torch.device("cuda", want[0]), "backend": backend,
                     "init_method": "tcp://host0:9377", "world_size": 16, "rank": rank}


def test_initialize_without_cuda_is_an_error(monkeypatch):
    from octproz_tpu_torch.parallel import multihost

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.initialize("host0:9377", 2, 0)
    with pytest.raises(ValueError, match="local rank 2"):
        multihost.local_cuda_choice(8, 2, 2)


def test_two_process_cluster_parity(tmp_path):
    """A real two-process world on gloo (CPU): each rank feeds its 5-B-scan
    block (rank 1's at the odd offset 5; the noise lines span both ranks),
    runs the FPN buffer and two steady ones over a (host, bscan, ascan)
    mesh with two CPU devices per rank on the A-scan axis, fetches its own
    block and holds it to the single-device pipeline; the FPN statistics
    cross the processes in one all_reduce of 9 x 64 x 3 x 4 bytes."""
    init = f"file://{tmp_path / 'rendezvous'}"
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-m", "octproz_tpu_torch.parallel.multihost",
                               "--selftest", "--rank", str(r), "--world", "2",
                               "--init", init, "--platform", "cpu"],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out = p.communicate()[0] + "\n<< TIMEOUT >>"
        outs.append(out)
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
        assert f"multihost rank {rank}/2: parity OK, all_reduce 6912 B via gloo" in out, out
