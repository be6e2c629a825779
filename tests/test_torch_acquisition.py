"""The port's acquisition back ends on the CPU against the JAX package's:
the native library (its own build, the aligned ring, file reads, the
packed-12 unpack and pack), the hardware-ring source, the PhytoOCT system
with its device model, the system registry and the curve files.

Every comparison is exact (numpy on both sides, or the same integer code),
except the PhytoOCT buffer through the two pipelines, which is held to the
scaled-image bounds of ``fused_prep.scale_error`` (RMS 1e-6, max 1e-4
display units above the display floor).  The JAX package's native loader is
never called here (it builds into ``native/`` in place): its numpy unpack
is the reference, and its ring-backed classes are reached only through
methods that do not create a ring.  Every wait has a timeout.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

import octproz_tpu.io.curvefiles as jcurvefiles
import octproz_tpu.io.phytooct as jphytooct
import octproz_tpu.models.fdoct as jfdoct
import octproz_tpu.params as jparams
from octproz_tpu.ops import convert as jconvert
from octproz_tpu_torch import native
from octproz_tpu_torch.io import curvefiles as tcurvefiles
from octproz_tpu_torch.io.hwbridge import HardwareRingSource
from octproz_tpu_torch.io.phytooct import (PhytoDeviceConfig, PhytoDeviceModel,
                                           PortableOctSystem, make_system, register)
from octproz_tpu_torch.io.source import SyntheticSource
from octproz_tpu_torch.io.systems import SystemRegistry
from octproz_tpu_torch.kernels import fused_prep as tfp
from octproz_tpu_torch.models.fdoct import FdOctModel
from octproz_tpu_torch.ops import convert as tconvert
from octproz_tpu_torch.params import AcqParams, FpnMode, ProcConfig, default_full_config
from octproz_tpu_torch.runtime import StreamingEngine
from octproz_tpu_torch.utils.settings import SettingsManager
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

ACQ = AcqParams(samples_per_line=64, ascans_per_bscan=8, bscans_per_buffer=2,
                buffers_per_volume=1, bit_depth=12)
#: tests/test_phytooct.py's small device
SMALL = dict(samples_per_line=256, ascans_per_bscan=64, bscans_per_buffer=2,
             buffers_per_volume=1, exposure_us=0.0, shot_noise=0.0005)
WAIT_S = 30.0


def _join(thread):
    thread.join(timeout=WAIT_S)
    assert not thread.is_alive(), "producer thread did not finish"


def _jax_cfg(cfg: ProcConfig):
    enums = {"fpn_mode": jparams.FpnMode, "interpolation": jparams.Interpolation}
    return jparams.ProcConfig(**{
        f.name: (enums[f.name](getattr(cfg, f.name).value) if f.name in enums
                 else getattr(cfg, f.name)) for f in dataclasses.fields(cfg)})


def _jax_system(dev: jphytooct.PhytoDeviceConfig):
    """The JAX package's PortableOctSystem for its calibration surface only:
    built without ``__init__``, which would create a native ring through the
    JAX package's loader."""
    system = object.__new__(jphytooct.PortableOctSystem)
    system.device_cfg = dev
    system.model = jphytooct.PhytoDeviceModel(dev)
    return system


# ---------------------------------------------------------------------------
# native library
# ---------------------------------------------------------------------------

def test_native_library_builds_in_its_own_directory():
    """The library is the port's own build, under the package's gitignored
    _build/native/<hash>/, never the JAX package's native/ directory."""
    assert native.native_available()
    lib = native.library_path()
    assert lib.exists() and lib.parent.parent == native.BUILD_ROOT
    assert native.BUILD_ROOT.parts[-3:] == ("octproz_tpu_torch", "_build", "native")
    assert native.SOURCE.parent.parent == native.BUILD_ROOT.parent.parent


def test_native_build_is_atomic_under_concurrent_builders(tmp_path, monkeypatch):
    """Four builders of one library path at once: each compiles to its own
    temporary name and moves it into place, so the path only ever holds a
    whole library and no temporary file is left behind."""
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "native")
    lib = native.library_path()
    results = []
    threads = [threading.Thread(target=lambda: results.append(native._build(lib)))
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        _join(t)
    assert results == [True] * 4
    assert sorted(p.name for p in lib.parent.iterdir()) == [lib.name]
    import ctypes

    loaded = native._bind(ctypes.CDLL(str(lib)))
    s = np.arange(9, dtype=np.uint16)
    out = np.zeros(15, np.uint8)
    loaded.pack_uint12(s.ctypes.data, out.ctypes.data, 9)
    np.testing.assert_array_equal(jconvert.unpack_uint12_packed(out, 9), s)


@pytest.mark.parametrize("n", [1, 2, 3, 7, 256, 1000, 1001])
def test_pack_unpack_match_jax(n):
    """The native pack and unpack against the JAX package's numpy unpack and
    the port's numpy pack: byte for byte, odd tails in their minimal two
    bytes, bits above 12 dropped, undersized buffers refused."""
    s = np.random.default_rng(n).integers(0, 4096, n).astype(np.uint16)
    packed = native.pack_uint12(s)
    np.testing.assert_array_equal(packed, tconvert.pack_uint12(s))
    np.testing.assert_array_equal(native.pack_uint12(s | 0xF000), packed)
    np.testing.assert_array_equal(jconvert.unpack_uint12_packed(packed, n), s)
    minimal = packed[:3 * (n // 2) + (2 if n & 1 else 0)]
    np.testing.assert_array_equal(native.unpack_uint12(minimal, n), s)
    np.testing.assert_array_equal(jconvert.unpack_uint12_packed(minimal, n), s)
    for unpack in (native.unpack_uint12, jconvert.unpack_uint12_packed):
        with pytest.raises(ValueError, match="too small"):
            unpack(minimal[:-1], n)


def test_unpack_random_bytes_match_jax():
    """Arbitrary wire bytes (not made by a pack) unpack the same."""
    wire = np.random.default_rng(3).integers(0, 256, 3 * 500).astype(np.uint8)
    for n in (999, 1000):
        np.testing.assert_array_equal(native.unpack_uint12(wire, n),
                                      jconvert.unpack_uint12_packed(wire, n))


def test_ring_buffer_alignment_and_views():
    rb = native.NativeRingBuffer(3, (4, 8), np.uint16)
    try:
        assert rb.n_slots == 3 and rb.slot_bytes == 64
        for i in range(3):
            v = rb.view(i)
            assert v.shape == (4, 8) and v.dtype == np.uint16
            assert v.ctypes.data % 128 == 0  # acquisitionbuffer.cpp:66 alignment
    finally:
        rb.close()


def test_ring_buffer_handshake_backpressure():
    rb = native.NativeRingBuffer(2, (4,), np.uint32)
    try:
        s0 = rb.acquire_write()
        assert s0 == 0
        rb.view(s0)[:] = 10
        rb.commit_write(s0)
        s1 = rb.acquire_write()
        rb.view(s1)[:] = 11
        rb.commit_write(s1)
        assert rb.acquire_write() == -1  # ring full: the producer waits
        assert rb.produced() == 2 and rb.consumed() == 0
        r0 = rb.acquire_read()
        assert r0 == 0 and rb.view(r0)[0] == 10
        rb.release_read(r0)
        assert rb.acquire_write() == 0  # slot freed: the producer continues
        assert rb.consumed() == 1
    finally:
        rb.close()


def test_ring_buffer_threaded_producer_consumer():
    rb = native.NativeRingBuffer(4, (16,), np.int64)
    got = []

    def producer():
        for i in range(100):
            while (s := rb.acquire_write()) < 0:
                time.sleep(0)
            rb.view(s)[:] = i
            rb.commit_write(s)

    t = threading.Thread(target=producer)
    t.start()
    try:
        deadline = time.monotonic() + WAIT_S
        while len(got) < 100 and time.monotonic() < deadline:
            s = rb.acquire_read()
            if s < 0:
                time.sleep(0)
                continue
            view = rb.view(s)
            assert (view == view[0]).all()  # no tearing
            got.append(int(view[0]))
            rb.release_read(s)
        _join(t)
        assert got == list(range(100))  # FIFO order, no loss
    finally:
        rb.close()


def test_file_read_at(tmp_path):
    data = np.arange(1000, dtype=np.uint16)
    p = tmp_path / "f.bin"
    data.tofile(p)
    out = native.read_file_at(str(p), 20, 100)
    np.testing.assert_array_equal(out.view(np.uint16), data[10:60])
    scratch = np.empty(100, np.uint8)
    assert native.read_file_at(str(p), 0, 100, scratch) is scratch
    with pytest.raises(EOFError):
        native.read_file_at(str(p), 1900, 1000)


# ---------------------------------------------------------------------------
# hardware ring source
# ---------------------------------------------------------------------------

def test_producer_consumer_fifo():
    src = HardwareRingSource(ACQ, n_slots=3)
    try:
        frames = [np.full(ACQ.buffer_shape, i, np.uint16) for i in range(7)]

        def producer():
            for f in frames:
                src.write_blocking(f)
            src.finish()

        t = threading.Thread(target=producer)
        t.start()
        got = [int(b[0, 0, 0]) for b in src.buffers()]
        _join(t)
        assert got == list(range(7))
    finally:
        src.close()


@pytest.mark.parametrize("bits,dtype", [(8, np.uint8), (12, np.uint16), (24, np.uint32)])
def test_slot_dtype_follows_the_bit_depth(bits, dtype):
    src = HardwareRingSource(dataclasses.replace(ACQ, bit_depth=bits), n_slots=2)
    try:
        assert src.view(0).dtype == dtype and src.view(1).shape == ACQ.buffer_shape
    finally:
        src.close()


def test_end_of_stream_count_contract_under_random_pacing():
    """finish() publishes the produced count and the consumer drains to it:
    over randomized producer/consumer pacings every buffer arrives, in
    order (a bare "finished" flag loses the last commit in some of them)."""
    rng = np.random.default_rng(42)
    shape = (2, 4, 8)
    acq = AcqParams(samples_per_line=8, ascans_per_bscan=4,
                    bscans_per_buffer=2, buffers_per_volume=1, bit_depth=16)
    for trial in range(300):
        n_frames = int(rng.integers(1, 6))
        src = HardwareRingSource(acq, n_slots=int(rng.integers(1, 5)),
                                 poll_interval_s=0.0, timeout_s=5.0)
        try:
            delays = rng.random(n_frames) * 2e-4

            def producer():
                for i in range(n_frames):
                    if delays[i] > 1e-4:
                        time.sleep(delays[i])
                    src.write_blocking(np.full(shape, i, np.uint16))
                src.finish()

            t = threading.Thread(target=producer)
            t.start()
            if trial % 3 == 0:
                time.sleep(rng.random() * 2e-4)  # let the producer race ahead
            got = [int(b[0, 0, 0]) for b in src.buffers()]
            _join(t)
            assert got == list(range(n_frames)), f"trial {trial}: {got}"
        finally:
            src.close()


def test_finish_before_any_consumer_poll():
    src = HardwareRingSource(ACQ, n_slots=4)
    try:
        for i in range(3):
            src.write_blocking(np.full(ACQ.buffer_shape, i, np.uint16))
        src.finish()
        assert [int(b[0, 0, 0]) for b in src.buffers()] == [0, 1, 2]
    finally:
        src.close()


def test_timeout_when_producer_dies():
    src = HardwareRingSource(ACQ, n_slots=2, timeout_s=0.2)
    try:
        with pytest.raises(TimeoutError, match="no acquisition data"):
            list(src.buffers())
        with pytest.raises(TimeoutError, match="ring full"):
            for _ in range(3):
                src.write_blocking(np.zeros(ACQ.buffer_shape, np.uint16), timeout_s=0.1)
    finally:
        src.close()


def test_close_while_a_consumer_polls_ends_its_stream():
    """The owner closes the source while the engine's acquisition thread
    still polls it (a run stopped at --max-buffers before the ring ran
    dry): the consumer ends its stream instead of calling into the freed
    ring."""
    src = HardwareRingSource(ACQ, n_slots=2, timeout_s=5.0)
    src.write_blocking(np.ones(ACQ.buffer_shape, np.uint16))
    got, polling = [], threading.Event()

    def consume():
        for b in src.buffers():
            got.append(int(b[0, 0, 0]))
            polling.set()

    t = threading.Thread(target=consume)
    t.start()
    assert polling.wait(5.0)
    time.sleep(0.01)  # the consumer polls the empty ring
    src.close()
    t.join(5.0)
    assert not t.is_alive() and got == [1]
    assert list(src.buffers()) == []


def test_slot_address_stable_and_aligned():
    src = HardwareRingSource(ACQ, n_slots=2)
    try:
        a0 = src.slot_address(0)
        assert a0 % 128 == 0 and src.slot_address(1) % 128 == 0
        assert src.slot_address(0) == a0  # stable across calls (DMA-safe)
        buf = np.full(ACQ.buffer_shape, 7, np.uint16)
        src.write_blocking(buf)
        assert src.slot_address(0) == a0
        got = next(src.buffers())
        assert got.ctypes.data != a0  # handed out as a copy
        np.testing.assert_array_equal(got, buf)
    finally:
        src.close()


class _ListSource:
    def __init__(self, acq, bufs):
        self.acq, self._bufs = acq, bufs

    def buffers(self):
        yield from self._bufs


def _engine_outputs(source, acq):
    cfg = dataclasses.replace(default_full_config(), bitshift=True, bscans_for_noise=2)
    model = FdOctModel(acq, cfg, resample_coeffs=(0.0, acq.samples_per_line - 1.0, 8.0, -3.0),
                       dispersion_coeffs=(0.0, 0.0, 6.0, 0.0), device="cpu")
    got = []
    eng = StreamingEngine(model, source, stream_to_host=True,
                          on_processed=lambda host, nr: got.append((host.copy(), nr)))
    return eng.run(max_buffers=50), got


def test_engine_over_the_ring_equals_the_engine_over_a_list():
    """The port's engine fed by a producer thread through the ring gives the
    same quantized stream, buffer for buffer, as the same buffers from a
    list (the ring hands out copies in FIFO order)."""
    acq = dataclasses.replace(ACQ, buffers_per_volume=3)
    bufs = [np.random.default_rng(i).integers(0, 4096, acq.buffer_shape).astype(np.uint16)
            for i in range(6)]
    src = HardwareRingSource(acq, n_slots=2)
    try:
        def producer():
            try:
                for b in bufs:
                    src.write_blocking(b)
            finally:
                src.finish()

        t = threading.Thread(target=producer)
        t.start()
        n, got = _engine_outputs(src, acq)
        _join(t)
    finally:
        src.close()
    n_list, want = _engine_outputs(_ListSource(acq, bufs), acq)
    assert n == n_list == 6 and len(got) == len(want) == 6
    for (g, gnr), (w, wnr) in zip(got, want):
        assert gnr == wnr
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# PhytoOCT device model and system
# ---------------------------------------------------------------------------

DEVICES = {
    "small": dict(SMALL),
    "small-odd-bscans": dict(SMALL, bscans_per_buffer=3, surface_tilt=0.16, n_layers=0),
    "small-forward": dict(SMALL, bidirectional=False, k_warp=0.25, dispersion_d2=-4.0),
    "defaults": {},
}


@pytest.mark.parametrize("name", list(DEVICES))
def test_device_model_matches_jax(name):
    """Frames, buffers, the k-lin curve and its cubic fit, the scan
    positions and the calibration kwargs: bit-identical to the JAX
    package's device model."""
    kw = DEVICES[name]
    dev, jdev = PhytoDeviceConfig(**kw), jphytooct.PhytoDeviceConfig(**kw)
    model, jmodel = PhytoDeviceModel(dev), jphytooct.PhytoDeviceModel(jdev)
    assert dataclasses.asdict(dev.acq) == dataclasses.asdict(jdev.acq)
    for i in (0, 1, dev.bscans_per_buffer + 1):
        np.testing.assert_array_equal(model.frame(i), jmodel.frame(i))
    buffers = (0, 1) if name != "defaults" else (1,)
    for i in buffers:
        b, jb = model.buffer(i), jmodel.buffer(i)
        assert b.dtype == jb.dtype == np.uint16
        np.testing.assert_array_equal(b, jb)
    np.testing.assert_array_equal(model.klin_curve(), jmodel.klin_curve())
    assert model.klin_coeffs() == jmodel.klin_coeffs()
    for reverse in (False, True):
        np.testing.assert_array_equal(model.scan_positions(reverse),
                                      jmodel.scan_positions(reverse))
    system = object.__new__(PortableOctSystem)
    system.device_cfg, system.model = dev, model
    ck, jck = system.curve_kwargs(), _jax_system(jdev).curve_kwargs()
    assert ck.keys() == jck.keys() and ck["dispersion_coeffs"] == jck["dispersion_coeffs"]
    np.testing.assert_array_equal(ck["custom_resample_curve"], jck["custom_resample_curve"])


@pytest.mark.parametrize("tpu", [True, False])
@pytest.mark.parametrize("bidirectional", [True, False])
def test_recommended_config_matches_jax(tpu, bidirectional):
    dev = PhytoDeviceConfig(**SMALL, bidirectional=bidirectional)
    jdev = jphytooct.PhytoDeviceConfig(**SMALL, bidirectional=bidirectional)
    system = object.__new__(PortableOctSystem)
    system.device_cfg = dev
    cfg = system.recommended_config(tpu=tpu)
    assert _jax_cfg(cfg) == _jax_system(jdev).recommended_config(tpu=tpu)
    assert cfg.fft_via_matmul is tpu and cfg.bscan_flip is bidirectional
    assert system.recommended_config().fft_via_matmul  # the fold path by default


def test_phytooct_buffers_through_the_pipeline_match_jax():
    """A small PhytoOCT buffer (FPN determination) and the next one (steady
    state) through the recommended chain: the port's FdOctModel on the CPU
    against the JAX package's within the scaled-image bounds."""
    dev, jdev = PhytoDeviceConfig(**SMALL), jphytooct.PhytoDeviceConfig(**SMALL)
    system = object.__new__(PortableOctSystem)
    system.device_cfg, system.model = dev, PhytoDeviceModel(dev)
    jsystem = _jax_system(jdev)
    cfg = system.recommended_config()
    tm = FdOctModel(dev.acq, cfg, **system.curve_kwargs(), device="cpu")
    jm = jfdoct.FdOctModel(jdev.acq, jsystem.recommended_config(), **jsystem.curve_kwargs())
    for i in range(2):
        raw = system.model.buffer(i)
        got = tm.process_buffer(raw)
        want = torch.from_numpy(np.array(jm.process_buffer(raw)))
        rms, worst, ok = tfp.scale_error(got, want)
        assert ok, (i, rms, worst)


def _process(system, cfg, raw):
    model = FdOctModel(system.acq, cfg, **system.curve_kwargs(), device="cpu")
    return model.process_buffer(raw).numpy()


def test_frame_format_is_12_in_16_bit():
    frame = PhytoDeviceModel(PhytoDeviceConfig(**SMALL)).frame(0)
    assert frame.shape == (64, 256) and frame.dtype == np.uint16
    assert np.all(frame & 0xF == 0)          # left-aligned 12-bit codes
    assert frame.max() > 2048 << 4           # uses the upper code range


def test_calibration_sharpens_the_point_spread():
    """k-lin + dispersion compensation concentrate the reflector energy on
    the port's pipeline: the calibrated chain beats the uncalibrated one
    clearly (tests/test_phytooct.py's bounds)."""
    sys_ = PortableOctSystem(PhytoDeviceConfig(
        **SMALL, bidirectional=False, surface_tilt=0.0, fpn_strength=0.0,
        k_warp=0.25, surface_depth=0.35, n_layers=0))
    try:
        base = dataclasses.replace(sys_.recommended_config(), log_scaling=False,
                                   fpn_mode=FpnMode.OFF, sinusoidal_correction=False,
                                   bscan_flip=False)
        raw = sys_.model.buffer(0)

        def concentration(cfg):
            ascan = _process(sys_, cfg, raw)[0].mean(axis=0)
            peak = int(np.argmax(ascan[4:]) + 4)  # skip DC residue
            return ascan[max(peak - 3, 0):peak + 4].sum() / ascan[4:].sum()

        sharp = concentration(base)
        blurred = concentration(dataclasses.replace(base, resampling=False, dispersion=False))
        assert sharp > 1.3 * blurred
        assert sharp > 0.8
    finally:
        sys_.close()


def test_sinusoidal_correction_linearizes_the_tilted_surface():
    sys_ = PortableOctSystem(PhytoDeviceConfig(
        **SMALL, bidirectional=False, surface_tilt=0.16, n_layers=0, fpn_strength=0.0))
    try:
        cfg = dataclasses.replace(sys_.recommended_config(), fpn_mode=FpnMode.OFF,
                                  bscan_flip=False)
        raw = sys_.model.buffer(0)

        def surface_residual(cfg):
            depths = np.argmax(_process(sys_, cfg, raw)[0][:, 4:], axis=1).astype(np.float64)
            a = np.arange(depths.size)
            slope, icept = np.polyfit(a, depths, 1)
            return np.abs(depths - (slope * a + icept)).mean()

        corrected = surface_residual(cfg)
        distorted = surface_residual(dataclasses.replace(cfg, sinusoidal_correction=False))
        assert corrected < 0.6 * distorted
    finally:
        sys_.close()


def test_bidirectional_flip_aligns_alternate_bscans():
    sys_ = PortableOctSystem(PhytoDeviceConfig(
        **SMALL, surface_tilt=0.16, n_layers=0, fpn_strength=0.0))
    try:
        cfg = dataclasses.replace(sys_.recommended_config(), fpn_mode=FpnMode.OFF,
                                  sinusoidal_correction=False)
        raw = sys_.model.buffer(0)
        vol = _process(sys_, cfg, raw)
        d0 = np.argmax(vol[0][:, 4:], axis=1).astype(np.float64)
        d1 = np.argmax(vol[1][:, 4:], axis=1).astype(np.float64)
        assert np.abs(d0 - d1).mean() < 2.0
        noflip = _process(sys_, dataclasses.replace(cfg, bscan_flip=False), raw)
        d0r = np.argmax(noflip[0][:, 4:], axis=1).astype(np.float64)
        assert np.abs(d0r - d1).mean() > 4.0
    finally:
        sys_.close()


def test_bidirectional_parity_is_within_buffer():
    """With odd bscans_per_buffer, frame reversal follows WITHIN-buffer
    parity (what ops.postprocess.bscan_flip un-reverses)."""
    model = PhytoDeviceModel(PhytoDeviceConfig(**{**SMALL, "bscans_per_buffer": 3,
                                                  "surface_tilt": 0.16, "n_layers": 0,
                                                  "fpn_strength": 0.0}))
    buf = model.buffer(1)  # global frames 3, 4, 5 -> within-buffer 0, 1, 2
    fwd = model._ascan_spectrum(model.scan_positions(False), noise_key=4)
    rev = model._ascan_spectrum(model.scan_positions(True), noise_key=3)
    codes = lambda s: (s * 4096.0).astype(np.uint16) << 4  # noqa: E731
    np.testing.assert_array_equal(buf[0], codes(rev))
    np.testing.assert_array_equal(buf[1], codes(fwd))


def test_producer_ring_and_registry_integration(tmp_path):
    reg = SystemRegistry(SettingsManager(str(tmp_path / "s.ini")))
    register(reg)
    assert "phytooct" in reg.names
    reg.store_settings("phytooct", {
        "samples_per_line": "128", "ascans_per_bscan": "16",
        "bscans_per_buffer": "2", "buffers_per_volume": "3",
        "exposure_us": "0.0", "bidirectional": "false"})
    src = reg.activate("phytooct")
    try:
        assert isinstance(src, PortableOctSystem)
        assert src.acq.samples_per_line == 128
        assert src.device_cfg.bidirectional is False
        got = list(src.buffers())
        assert len(got) == 3
        assert got[0].shape == (2, 16, 128) and got[0].dtype == np.uint16
        np.testing.assert_array_equal(got[1], src.model.buffer(1))
        jmodel = jphytooct.PhytoDeviceModel(jphytooct.PhytoDeviceConfig(
            **dataclasses.asdict(src.device_cfg)))
        np.testing.assert_array_equal(got[2], jmodel.buffer(2))
    finally:
        reg.deactivate()  # close() joins the producer
    assert reg.active_source is None


def test_make_system_defaults_and_volumes():
    sys_ = make_system({})
    try:
        assert sys_.acq.samples_per_line == 1024 and sys_.n_buffers == 4
        assert sys_.device_cfg == PhytoDeviceConfig()
    finally:
        sys_.close()
    sys_ = make_system({"n_volumes": "2", "buffers_per_volume": "3", "seed": "9"})
    try:
        assert sys_.n_buffers == 6 and sys_.device_cfg.seed == 9
    finally:
        sys_.close()


def test_ring_is_allocated_at_the_first_start():
    """A system used for its model and calibration only holds no ring (the
    fidelity anchor's full-geometry device); ``start`` allocates it once,
    and ``close`` before any start is a no-op."""
    idle = PortableOctSystem(PhytoDeviceConfig(**SMALL))
    assert idle._ring is None
    assert idle.recommended_config().fft_via_matmul and idle.curve_kwargs()
    idle.close()
    sys_ = PortableOctSystem(PhytoDeviceConfig(**SMALL))
    try:
        sys_.start()
        ring = sys_._ring
        assert isinstance(ring, HardwareRingSource)
        sys_.start()
        assert sys_._ring is ring
    finally:
        sys_.close()


def test_close_stops_a_producer_on_a_full_ring():
    """A consumer that never reads: the producer waits in short slices and
    close() ends it (the retry watches close())."""
    sys_ = PortableOctSystem(PhytoDeviceConfig(**dict(SMALL, buffers_per_volume=4)),
                             n_slots=1)
    sys_.start()
    thread = sys_._thread
    deadline = time.monotonic() + WAIT_S
    while sys_._ring.ring.produced() < 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert sys_._ring.ring.produced() == 1
    t0 = time.monotonic()
    sys_.close()
    assert not thread.is_alive()
    assert time.monotonic() - t0 < 8.0


# ---------------------------------------------------------------------------
# system registry
# ---------------------------------------------------------------------------

def test_registry_activate_with_settings(tmp_path):
    reg = SystemRegistry(SettingsManager(str(tmp_path / "s.ini")))
    created = []

    def factory(settings):
        created.append(settings)
        return SyntheticSource(ACQ, n_buffers=int(settings.get("n", 1)))

    reg.register("synthetic", factory)
    assert reg.names == ["synthetic"]
    reg.store_settings("synthetic", {"n": 3})
    src = reg.activate("synthetic")
    assert reg.active_name == "synthetic"
    assert created[-1]["n"] == "3"  # round-tripped through the INI as a string
    assert src.total == 3
    assert SettingsManager(str(tmp_path / "s.ini")).get_group("system:synthetic") == {"n": "3"}
    src2 = reg.activate("synthetic", overrides={"n": 5})
    assert src2.total == 5
    reg.deactivate()
    assert reg.active_source is None and reg.active_name is None


def test_registry_refusals_and_failing_close():
    reg = SystemRegistry()
    with pytest.raises(KeyError, match="unknown acquisition system"):
        reg.activate("ghost")
    with pytest.raises(RuntimeError, match="SettingsManager"):
        reg.store_settings("x", {})

    class Broken:
        acq = ACQ

        def buffers(self):
            return iter(())

        def close(self):
            raise OSError("device gone")

    reg.register("broken", lambda settings: Broken())
    reg.activate("broken")
    with pytest.raises(OSError, match="device gone"):
        reg.deactivate()
    assert reg.active_source is None and reg.active_name is None  # never pinned


# ---------------------------------------------------------------------------
# curve files
# ---------------------------------------------------------------------------

CSV_CASES = {
    "plain": ("0;1\n1;2.5\n2;-3\n", None),
    "header-comma-gap": ("index;value\n0;1,5\n1;2.5\n\n3;9\n", None),
    "expected-size": ("0;1\n1;2\n9;99\n", 10),
}


@pytest.mark.parametrize("name", list(CSV_CASES))
def test_curve_csv_load_matches_jax(tmp_path, name):
    text, size = CSV_CASES[name]
    p = tmp_path / "c.csv"
    p.write_text(text)
    got = tcurvefiles.load_curve_csv(str(p), expected_size=size)
    want = jcurvefiles.load_curve_csv(str(p), expected_size=size)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_curve_csv_save_matches_jax(tmp_path):
    curve = np.random.default_rng(4).uniform(-1e3, 1e3, 256).astype(np.float32)
    p = tcurvefiles.save_curve_csv(str(tmp_path / "t" / "c.csv"), curve)
    jp = jcurvefiles.save_curve_csv(str(tmp_path / "j" / "c.csv"), curve)
    assert open(p).read() == open(jp).read()
    np.testing.assert_allclose(tcurvefiles.load_curve_csv(p), curve, rtol=1e-6)


@pytest.mark.parametrize("text,size,match", [
    ("0;1\n1;2\n9;99\n", 4, "10 points.*needs 4"),
    ("justonecolumn\n", None, "index;value"),
    ("", None, "no curve points"),
    ("0;1\nx;2\n", None, "bad entry"),
])
def test_curve_csv_errors_match_jax(tmp_path, text, size, match):
    p = tmp_path / "bad.csv"
    p.write_text(text)
    for mod in (tcurvefiles, jcurvefiles):
        with pytest.raises(ValueError, match=match):
            mod.load_curve_csv(str(p), expected_size=size)
