"""The port's sharded step against JAX's and against its own single-device
step, on the CPU.

Mirrors tests/test_sharding.py: the same seeded numpy buffers and the same
curves (JAX's, carried across with ``interop``) go through JAX's
``make_sharded_step`` on the 8 virtual CPU devices of the conftest, the
port's on ``[torch.device("cpu")] * 8`` and the port's single-device step.
Tolerances are the JAX tests' own: 2e-4 on the volume, 1e-4/1e-5 on the
FPN mean line (the sharded sums are added in another order).  Global
indices decide the flip parity, the FPN segments and the last-A-scan
guard, so the odd-offset cases cut 12 B-scans into blocks of three.
"""

import dataclasses
import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octproz_tpu import curves as jcurves
from octproz_tpu import params as jparams
from octproz_tpu import pipeline as jpipeline
from octproz_tpu.models.fdoct import FdOctModel as JFdOctModel
from octproz_tpu.parallel import make_mesh as jmake_mesh
from octproz_tpu.parallel import make_sharded_step as jmake_sharded_step
from octproz_tpu_torch import interop, native
from octproz_tpu_torch import pipeline as tpipeline
from octproz_tpu_torch.curves import consumed_fields
from octproz_tpu_torch.io.recorder import RecordingParams
from octproz_tpu_torch.io.source import SyntheticSource
from octproz_tpu_torch.models.fdoct import FdOctModel
from octproz_tpu_torch.params import AcqParams, FpnMode, Interpolation, ProcConfig, WindowType
from octproz_tpu_torch.parallel import (ShardedBuffer, make_mesh, make_sharded_step,
                                        sharded_process_buffer)
from octproz_tpu_torch.parallel.sharding import row_blocks
from octproz_tpu_torch.runtime import StreamingEngine
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

CPU = torch.device("cpu")
CPUS = [CPU] * 8
ACQ = AcqParams(samples_per_line=128, ascans_per_bscan=32, bscans_per_buffer=16, bit_depth=12)
#: 12 B-scans: on a (4, 1) mesh the blocks start at the odd B-scans 3 and 9
ODD_ACQ = dataclasses.replace(ACQ, bscans_per_buffer=12)
COEFFS = dict(resample_coeffs=(0.0, 127.0, 14.0, -9.0),
              dispersion_coeffs=(0.0, 2.0, -13.0, 7.0))

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
#: the fold path with the fused steady-state kernel
FOLD_CFG = dataclasses.replace(FULL_CFG, background_removal=False, fft_via_matmul=True)


def _jax(obj):
    """The JAX package's AcqParams / ProcConfig with the same field values."""
    if isinstance(obj, AcqParams):
        return jparams.AcqParams(**dataclasses.asdict(obj))
    enums = {"fpn_mode": jparams.FpnMode, "interpolation": jparams.Interpolation}
    return jparams.ProcConfig(**{
        f.name: (enums[f.name](getattr(obj, f.name).value) if f.name in enums
                 else getattr(obj, f.name)) for f in dataclasses.fields(obj)})


def _raw(rng, acq=ACQ):
    return rng.integers(0, 4095, size=acq.buffer_shape, dtype=np.uint16)


def _curves(acq, cfg):
    """JAX's curves and the port's copy of the consumed fields (numpy)."""
    jc = jcurves.make_curves(_jax(acq), _jax(cfg), **COEFFS,
                             window_type=jparams.WindowType.HANNING,
                             post_background=np.linspace(0.0, 0.2, acq.output_ascan_length,
                                                         dtype=np.float32))
    fields = {f: np.asarray(getattr(jc, f)) for f in consumed_fields(cfg)}
    return jc, interop.curves_from_numpy(fields, CPU)


def _run_three(raws, acq, cfg, mesh_shape):
    """The buffers through JAX's sharded step, the port's sharded step and
    the port's single-device step; yields each buffer's three outputs
    (numpy float32) and the three FPN states at the end."""
    jc, tc = _curves(acq, cfg)
    jstep = jmake_sharded_step(_jax(acq), _jax(cfg), jmake_mesh(*mesh_shape))
    tstep = make_sharded_step(acq, cfg, make_mesh(*mesh_shape, devices=CPUS))
    single = tpipeline.make_step(acq, cfg)
    js = jpipeline.initial_fpn_state(_jax(acq))
    ts = ss = tpipeline.initial_fpn_state(acq, device=CPU)
    outs = []
    for raw in raws:
        j, js = jstep(jnp.asarray(raw), jc, js)
        t, ts = tstep(raw, tc, ts)
        s, ss = single(torch.from_numpy(raw), tc, ss)
        assert isinstance(t, ShardedBuffer) and tuple(t.shape) == acq.processed_buffer_shape
        assert t.dtype == s.dtype
        outs.append((np.asarray(j, np.float32), interop.to_numpy(_whole(t)),
                     interop.to_numpy(s)))
    return outs, (np.asarray(js.mean_line), ts.mean_line.numpy(), ss.mean_line.numpy()), tstep


def _whole(buf: ShardedBuffer) -> torch.Tensor:
    """The blocks of a sharded buffer in one tensor (this process holds all)."""
    return torch.cat([t for _, t in row_blocks(buf)])


def _close(got, want, atol=2e-4):
    np.testing.assert_allclose(got, want, rtol=atol, atol=atol)


def _held(outs, means, atol=2e-4):
    for jax_out, port, single in outs:
        _close(port, jax_out, atol)
        _close(port, single, atol)
    jm, tm, sm = means
    np.testing.assert_allclose(tm, jm, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tm, sm, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("fpn_mode", [FpnMode.ONCE, FpnMode.CONTINUOUS])
@pytest.mark.parametrize("mesh_shape", [(8, 1), (1, 8), (4, 2), (2, 2)])
@pytest.mark.parametrize("path", ["fft", "fold"])
def test_full_chain_parity(rng, mesh_shape, fpn_mode, path):
    """Every post stage, FPN over two B-scans, two buffers (determination,
    then steady state, or a second determination under CONTINUOUS)."""
    cfg = dataclasses.replace(FULL_CFG if path == "fft" else FOLD_CFG, fpn_mode=fpn_mode)
    outs, means, _ = _run_three([_raw(rng), _raw(rng)], ACQ, cfg, mesh_shape)
    _held(outs, means)


@pytest.mark.parametrize("bscans_for_noise", [1, 5, 12])
@pytest.mark.parametrize("path", ["fft", "fold"])
def test_odd_shard_offsets(rng, bscans_for_noise, path):
    """12 B-scans on (4, 1): blocks at B-scans 0, 3, 6, 9 -- odd offsets
    for the flip parity, the FPN segments (noise lines on one shard, across
    two at an odd offset, across all) and the last-A-scan guard."""
    cfg = dataclasses.replace(FULL_CFG if path == "fft" else FOLD_CFG,
                              bscans_for_noise=bscans_for_noise)
    outs, means, _ = _run_three([_raw(rng, ODD_ACQ), _raw(rng, ODD_ACQ)], ODD_ACQ, cfg, (4, 1))
    _held(outs, means)


def test_uneven_noise_bscans_span_shards(rng):
    """bscans_for_noise=3 on (8, 1): the noise lines fill shard 0 and half
    of shard 1; the reduction is still over global lines."""
    cfg = ProcConfig(resampling=True, fpn_mode=FpnMode.ONCE, bscans_for_noise=3)
    outs, means, _ = _run_three([_raw(rng)], ACQ, cfg, (8, 1))
    _held(outs, means)


@pytest.mark.parametrize("has_post", [False, True])
def test_output_dtype_bf16_parity(rng, has_post):
    """output_dtype='bfloat16': the store narrows after the post stages,
    which run in float32; the FPN buffer and a steady (fused kernel)
    buffer match JAX's and the single-device step in dtype and value (one
    bf16 step, as tests/test_sharding.py holds it)."""
    cfg = dataclasses.replace(FOLD_CFG, output_dtype="bfloat16",
                              bscan_flip=has_post, sinusoidal_correction=has_post,
                              post_background_removal=False)
    outs, means, _ = _run_three([_raw(rng), _raw(rng)], ACQ, cfg, (4, 2))
    _held(outs, means, atol=2e-2)


def test_fpn_once_reuses_mean_line(rng):
    """Under ONCE the second buffer reuses the first buffer's mean line,
    and the step keeps its per-device curves while the curves are the
    same object."""
    cfg = dataclasses.replace(FOLD_CFG, fpn_mode=FpnMode.ONCE)
    _, tc = _curves(ACQ, cfg)
    step = make_sharded_step(ACQ, cfg, make_mesh(4, 2, devices=CPUS))
    _, s1 = step(_raw(rng), tc, tpipeline.initial_fpn_state(ACQ, device=CPU))
    held = step._curves[1]
    _, s2 = step(_raw(rng), tc, s1)
    assert s2.mean_line is s1.mean_line and s2.determined
    assert step._curves[1] is held
    assert step.tally.summary()["by_op"]["all_reduce"] == 9 * 64 * 3 * 4  # one reduction


def test_sharded_process_buffer_and_layout(rng):
    """The functional form equals the step; the output's blocks carry the
    buffer's split and lie on the mesh's devices."""
    cfg = ProcConfig(resampling=True, windowing=True, log_scaling=True)
    _, tc = _curves(ACQ, cfg)
    raw = _raw(rng)
    mesh = make_mesh(8, 1, devices=CPUS)
    state = tpipeline.initial_fpn_state(ACQ, device=CPU)
    a, _ = sharded_process_buffer(raw, tc, state, ACQ, cfg, mesh)
    b, _ = make_sharded_step(ACQ, cfg, mesh)(raw, tc, state)
    assert len(a.shards) == 8 and a.is_fully_addressable
    assert [idx[0].start for idx, _ in a.shards] == list(range(0, 16, 2))
    assert torch.equal(_whole(a), _whole(b))


def test_sharded_fpn_rejects_too_few_lines(rng):
    """Fewer noise lines than segments raise (ops/fpn.py contract)."""
    acq = AcqParams(samples_per_line=64, ascans_per_bscan=4, bscans_per_buffer=8, bit_depth=12)
    cfg = dataclasses.replace(FOLD_CFG, bscans_for_noise=1, bscan_flip=False,
                              sinusoidal_correction=False, post_background_removal=False)
    _, tc = _curves(acq, cfg)
    step = make_sharded_step(acq, cfg, make_mesh(4, 1, devices=CPUS))
    with pytest.raises(ValueError, match="at least"):
        step(_raw(rng, acq), tc, tpipeline.initial_fpn_state(acq, device=CPU))


def test_mesh_construction():
    """Too few devices is an error; a CPU mesh needs its devices passed (the
    default is the local CUDA devices, none here); a buffer that does not
    split into equal blocks is refused."""
    with pytest.raises(ValueError, match="needs 8 devices, have 4"):
        make_mesh(4, 2, devices=[CPU] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="have 0"):
            make_mesh(2)
    mesh = make_mesh(devices=CPUS)
    assert mesh.shape == {"bscan": 8, "ascan": 1} and mesh.local_devices == [CPU]
    with pytest.raises(ValueError, match="equal blocks"):
        make_sharded_step(ODD_ACQ, FULL_CFG, mesh)


@pytest.mark.parametrize("path", ["fft", "fold"])
def test_fdoct_model_with_mesh_matches_single_device(path):
    acq = AcqParams(samples_per_line=64, ascans_per_bscan=8, bscans_per_buffer=8,
                    buffers_per_volume=1, bit_depth=12)
    cfg = ProcConfig(resampling=True, interpolation=Interpolation.CUBIC, windowing=True,
                     dispersion=True, fpn_mode=FpnMode.ONCE, bscans_for_noise=4,
                     log_scaling=True, fft_via_matmul=path == "fold")
    kw = dict(resample_coeffs=(0.0, 63.0, 4.0, 0.0), dispersion_coeffs=(0.0, 0.0, 4.0, 0.0))
    rng = np.random.default_rng(5)
    single = FdOctModel(acq, cfg, **kw, device=CPU)
    sharded = FdOctModel(acq, cfg, **kw, mesh=make_mesh(4, 2, devices=CPUS))
    jm = JFdOctModel(_jax(acq), _jax(cfg), mesh=jmake_mesh(4, 2, devices=jax.devices()), **kw)
    for _ in range(2):
        raw = rng.integers(0, 4095, size=acq.buffer_shape).astype(np.uint16)
        got = sharded.fetch(sharded.process_buffer(raw))
        _close(got, single.fetch(single.process_buffer(raw)))
        _close(got, np.asarray(jm.process_buffer(raw)))
    with pytest.raises(ValueError, match="single-device"):
        sharded.process_chunk(np.stack([raw, raw]))
    # a re-tune publishes new curves; the step copies them once, per device
    sharded.set_dispersion_coeffs(0.0, 0.0, 6.0, 0.0)
    single.set_dispersion_coeffs(0.0, 0.0, 6.0, 0.0)
    sharded.set_config(grayscale_max=50.0)
    single.set_config(grayscale_max=50.0)
    _close(sharded.fetch(sharded.process_buffer(raw)), single.fetch(single.process_buffer(raw)))


def test_fpn_off_bscan_mesh_equals_single_device(rng):
    """FPN off on a B-scan mesh: every line's work is the single-device
    work on fewer lines; no transfer at all."""
    cfg = dataclasses.replace(FOLD_CFG, fpn_mode=FpnMode.OFF, post_background_removal=False)
    outs, _, step = _run_three([_raw(rng)], ACQ, cfg, (8, 1))
    for jax_out, port, single in outs:
        _close(port, single)
        _close(port, jax_out)
    assert step.tally.summary()["total_bytes"] == 0


def _packed(raw):
    return native.pack_uint12(raw.reshape(-1))


@pytest.mark.parametrize("geometry, mesh_shape", [
    ((256, 8, 8), (4, 2)),   # per-line wire: 256-sample lines
    ((192, 4, 8), (4, 2)),   # per-B-scan wire: 4 x 192 samples = 3 x 256
])
def test_packed12_wire_on_mesh_matches_uint16(rng, geometry, mesh_shape):
    """The packed-12 wire on a mesh unpacks block by block to the uint16
    buffer and processes to the same output, exactly."""
    n, asc, bsc = geometry
    acq = AcqParams(samples_per_line=n, ascans_per_bscan=asc, bscans_per_buffer=bsc,
                    buffers_per_volume=1, bit_depth=12)
    cfg = ProcConfig(resampling=True, interpolation=Interpolation.CUBIC, windowing=True,
                     dispersion=True, fpn_mode=FpnMode.ONCE, bscans_for_noise=4,
                     log_scaling=True, fft_via_matmul=True)
    model = FdOctModel(acq, cfg, resample_coeffs=(0.0, n - 1.0, 6.0, 0.0),
                       dispersion_coeffs=(0.0, 0.0, 4.0, 0.0),
                       mesh=make_mesh(*mesh_shape, devices=CPUS))
    raw = rng.integers(0, 4095, size=acq.buffer_shape).astype(np.uint16)
    dev = model.put_packed_buffer(_packed(raw))
    assert isinstance(dev, ShardedBuffer) and len(dev.shards) == 8
    np.testing.assert_array_equal(model.fetch(dev), raw)
    a = model.fetch(model.process_buffer(model.put_buffer(raw)))
    model.redetermine_fpn()
    b = model.fetch(model.process_buffer(model.put_packed_buffer(_packed(raw))))
    np.testing.assert_array_equal(a, b)


def test_packed12_wire_on_mesh_refuses_unaligned():
    """A geometry aligned at neither granularity is refused, as JAX does."""
    bad = AcqParams(samples_per_line=40, ascans_per_bscan=3, bscans_per_buffer=8, bit_depth=12)
    model = FdOctModel(bad, ProcConfig(resampling=True), resample_coeffs=(0.0, 39.0, 0.0, 0.0),
                       mesh=make_mesh(4, 1, devices=CPUS))
    with pytest.raises(ValueError, match="multiple of 256"):
        model.put_packed_buffer(_packed(np.zeros(bad.samples_per_buffer, np.uint16)))


@pytest.mark.parametrize("wire", ["uint16", "packed12"])
def test_streaming_engine_with_sharded_model(tmp_path, wire):
    """The engine on a (4, 2) mesh: the recorded float32 stream equals
    process_buffer on the mesh, the quantized stream has the buffer's shape,
    and a post-background capture takes the whole buffer's mean A-scan."""
    acq = AcqParams(samples_per_line=256, ascans_per_bscan=8, bscans_per_buffer=8,
                    buffers_per_volume=1, bit_depth=12)
    cfg = ProcConfig(resampling=True, interpolation=Interpolation.LINEAR, windowing=True,
                     fpn_mode=FpnMode.ONCE, bscans_for_noise=2, log_scaling=True,
                     fft_via_matmul=True)
    kw = dict(resample_coeffs=(0.0, 255.0, 0.0, 0.0), window_type=WindowType.HANNING)
    bufs = [np.random.default_rng(30 + i).integers(0, 4095, acq.buffer_shape).astype(np.uint16)
            for i in range(3)]

    class Source:
        def buffers(self):
            for b in bufs:
                yield _packed(b) if wire == "packed12" else b

    model = FdOctModel(acq, cfg, **kw, mesh=make_mesh(4, 2, devices=CPUS))
    ref = FdOctModel(acq, cfg, **kw, mesh=make_mesh(4, 2, devices=CPUS))
    want = [ref.fetch(ref.process_buffer(b)) for b in bufs]
    shapes = []
    eng = StreamingEngine(model, Source(), stream_to_host=True, wire_format=wire,
                          on_processed=lambda b, nr: shapes.append(b.shape))
    eng.start_recording(RecordingParams(save_dir=str(tmp_path), name="m", buffers_to_record=3,
                                        save_raw=False, save_processed=True,
                                        save_as_32bit_float=True, save_meta=False))
    eng.record_post_background(1)
    assert eng.run() == 3
    assert shapes == [acq.processed_buffer_shape] * 3
    (f,) = glob.glob(str(tmp_path / "*_processed_float32_*.raw"))
    recorded = np.fromfile(f, np.float32).reshape(3, *acq.processed_buffer_shape)
    np.testing.assert_array_equal(recorded, np.stack(want))
    np.testing.assert_allclose(model.curves.post_background.numpy(),
                               want[0].mean(axis=(0, 1)), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="buffer by buffer"):
        StreamingEngine(model, Source(), dispatch_chunk=2)


def test_streaming_engine_source_on_mesh():
    """A synthetic source through the engine on a B-scan mesh."""
    acq = AcqParams(samples_per_line=64, ascans_per_bscan=8, bscans_per_buffer=8,
                    buffers_per_volume=1, bit_depth=12)
    cfg = ProcConfig(resampling=True, interpolation=Interpolation.LINEAR, windowing=True,
                     fpn_mode=FpnMode.OFF, log_scaling=True)
    model = FdOctModel(acq, cfg, mesh=make_mesh(8, 1, devices=CPUS),
                       resample_coeffs=(0.0, 63.0, 0.0, 0.0))
    got = []
    eng = StreamingEngine(model, SyntheticSource(acq, n_buffers=4), stream_to_host=True,
                          on_processed=lambda b, nr: got.append(b.shape))
    assert eng.run() == 4
    assert got == [acq.processed_buffer_shape] * 4
