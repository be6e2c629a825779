"""The port's streaming runtime on the CPU: the behaviours of the JAX
package's engine (tests/test_runtime.py) -- prefetch and back-pressure,
decimated quantized streaming, recorders, extension fan-out, metrics,
chunked dispatch, the upload feeder and the packed-12 wire -- and the
port's StreamingEngine against the JAX package's on the same source data
and configuration.

The engine comparison holds the float32 recorder streams of the two engines
to the bounds of the scaled image (tests/test_torch_pipeline.py): equal
finite masks, |port - jax| <= 1e-4 where the JAX value is at or above the
display floor (>= 0); the quantized streams to one code.  Every run passes
``max_buffers`` or a finite source, and every wait in the engine has a
timeout, so a wedged thread fails a test instead of hanging the suite.
"""

import dataclasses
import glob
import os
import threading
import time

import numpy as np
import pytest
import torch

import octproz_tpu.io.recorder as jrecorder
import octproz_tpu.io.source as jsource
import octproz_tpu.models.fdoct as jfdoct
import octproz_tpu.params as jparams
import octproz_tpu.runtime as jruntime
from octproz_tpu_torch.io.recorder import RecordingParams
from octproz_tpu_torch.io.source import SyntheticSource
from octproz_tpu_torch.kernels import fused_prep as tfp
from octproz_tpu_torch.models.fdoct import FdOctModel
from octproz_tpu_torch.ops.convert import pack_uint12
from octproz_tpu_torch.params import (AcqParams, FpnMode, Interpolation, ProcConfig,
                                      default_full_config)
from octproz_tpu_torch.plugins import Extension, ExtensionManager
from octproz_tpu_torch.runtime import StreamingEngine, ThroughputMeter

ACQ = AcqParams(samples_per_line=64, ascans_per_bscan=16, bscans_per_buffer=4,
                buffers_per_volume=2, bit_depth=12)
CFG = ProcConfig(resampling=True, interpolation=Interpolation.LINEAR,
                 windowing=True, dispersion=False, fpn_mode=FpnMode.OFF,
                 log_scaling=True)
COEFFS = dict(resample_coeffs=(0.0, ACQ.samples_per_line - 1.0, 0.0, 0.0))
SCALE_ATOL = 1e-4


def make_model(cfg=CFG, **kw):
    return FdOctModel(ACQ, cfg, **COEFFS, **kw, device="cpu")


def make_engine(n_buffers=6, cfg=CFG, **kw):
    return StreamingEngine(make_model(cfg), SyntheticSource(ACQ, n_buffers=n_buffers), **kw)


class CollectingExtension(Extension):
    name = "collector"
    wants_raw_data = True
    wants_processed_data = True

    def __init__(self):
        super().__init__()
        self.raw_calls = []
        self.processed_calls = []

    def raw_data_received(self, buffer, bit_depth, spl, apb, bpb, bpv, nr):
        self.raw_calls.append((buffer.shape, bit_depth, nr))

    def processed_data_received(self, buffer, bit_depth, spl, apb, bpb, bpv, nr):
        self.processed_calls.append((buffer.copy(), bit_depth, nr))


def _collect(eng):
    ext = CollectingExtension()
    eng.extensions.add(ext)
    ext.activate()
    return ext


# ---------------------------------------------------------------------------
# the port's engine against the JAX package's
# ---------------------------------------------------------------------------

class ListSource:
    """Yields the given host buffers once (uint16 samples or packed-12
    wire bytes)."""

    def __init__(self, acq, bufs):
        self.acq = acq
        self._bufs = bufs

    def buffers(self):
        yield from self._bufs


def _fold_cfg(**changes):
    return dataclasses.replace(default_full_config(), bitshift=True, bscans_for_noise=2,
                               **changes)


def _jax_cfg(cfg):
    enums = {"fpn_mode": jparams.FpnMode, "interpolation": jparams.Interpolation}
    return jparams.ProcConfig(**{
        f.name: (enums[f.name](getattr(cfg, f.name).value) if f.name in enums
                 else getattr(cfg, f.name)) for f in dataclasses.fields(cfg)})


def _run_pair(tmp_path, cfg, bufs, wire, **kw):
    """The same source data through the port's and the JAX package's engine,
    recording every processed buffer as float32 and streaming the quantized
    stream; returns {tag: (float32 recording, quantized buffers)}."""
    curve_kw = dict(COEFFS, dispersion_coeffs=(0.0, 0.0, 4.0, 0.0))
    jacq = jparams.AcqParams(**dataclasses.asdict(ACQ))
    src = [pack_uint12(b) for b in bufs] if wire == "packed12" else bufs
    out = {}
    for tag in ("port", "jax"):
        got = []
        if tag == "port":
            model = FdOctModel(ACQ, cfg, **curve_kw, device="cpu")
            eng = StreamingEngine(model, ListSource(ACQ, src), wire_format=wire,
                                  stream_to_host=True,
                                  on_processed=lambda b, nr: got.append(b.copy()), **kw)
            params = RecordingParams
        else:
            model = jfdoct.FdOctModel(jacq, _jax_cfg(cfg), **curve_kw)
            eng = jruntime.StreamingEngine(model, ListSource(jacq, src), wire_format=wire,
                                           stream_to_host=True,
                                           on_processed=lambda b, nr: got.append(b.copy()),
                                           **kw)
            params = jrecorder.RecordingParams
        eng.start_recording(params(save_dir=str(tmp_path / tag), name="e",
                                   buffers_to_record=len(bufs), save_raw=False,
                                   save_processed=True, save_as_32bit_float=True,
                                   save_meta=False))
        assert eng.run() == len(bufs)
        (f,) = glob.glob(str(tmp_path / tag / "*_processed_float32_*.raw"))
        out[tag] = (np.fromfile(f, np.float32).reshape(len(bufs), *ACQ.processed_buffer_shape),
                    got)
    return out


ENGINE_CASES = [
    # (fold_concat, matmul_precision, dispatch_chunk, wire)
    (True, "default", 1, "uint16"),
    (True, "high", 3, "uint16"),
    (True, "default", 3, "packed12"),
    (True, "high", 1, "packed12"),
    (False, "default", 3, "uint16"),
    (False, "high", 1, "uint16"),
    (False, "default", 1, "packed12"),
    (False, "high", 3, "packed12"),
]


@pytest.mark.parametrize("concat,precision,chunk,wire", ENGINE_CASES)
def test_engine_matches_jax_engine(tmp_path, concat, precision, chunk, wire):
    """The benchmark chain on the fold path (FPN once), fold_concat on and
    off, per-buffer and chunked dispatch (7 buffers: a batch chunk after the
    FPN buffer and a per-buffer tail), uint16 and packed-12 wires."""
    rng = np.random.default_rng(7)
    bufs = [rng.integers(0, 4096, ACQ.buffer_shape).astype(np.uint16) for _ in range(7)]
    cfg = _fold_cfg(fold_concat=concat, matmul_precision=precision)
    before = dict(tfp.LAUNCHES)
    out = _run_pair(tmp_path, cfg, bufs, wire, dispatch_chunk=chunk)
    assert tfp.LAUNCHES == before  # CPU: plain versions, no kernel launch
    (got_f, got_q), (want_f, want_q) = out["port"], out["jax"]
    np.testing.assert_array_equal(np.isfinite(got_f), np.isfinite(want_f))
    shown = np.isfinite(want_f) & (want_f >= 0)
    assert shown.mean() > 0.5
    assert np.abs(got_f[shown].astype(np.float64) - want_f[shown]).max() <= SCALE_ATOL
    assert len(got_q) == len(want_q) == len(bufs)
    for g, w in zip(got_q, want_q):
        assert g.dtype == w.dtype == np.uint16
        assert np.abs(g.astype(np.int64) - w.astype(np.int64)).max() <= 1


def test_engine_matches_jax_engine_fft_path(tmp_path):
    """The FFT path through the prep kernels' plain versions, chunked."""
    rng = np.random.default_rng(8)
    bufs = [rng.integers(0, 4096, ACQ.buffer_shape).astype(np.uint16) for _ in range(5)]
    cfg = _fold_cfg(fft_via_matmul=False, use_pallas_prep=True)
    out = _run_pair(tmp_path, cfg, bufs, "uint16", dispatch_chunk=2)
    (got_f, _), (want_f, _) = out["port"], out["jax"]
    shown = np.isfinite(want_f) & (want_f >= 0)
    assert np.abs(got_f[shown].astype(np.float64) - want_f[shown]).max() <= SCALE_ATOL


def test_put_packed_buffer_matches_uint16():
    """The packed-12 upload unpacks to the uint16 buffer exactly; bit depths
    other than 12 are refused."""
    model = make_model()
    buf = np.random.default_rng(1).integers(0, 4096, ACQ.buffer_shape).astype(np.uint16)
    got = model.put_packed_buffer(pack_uint12(buf))
    assert got.dtype == torch.uint16 and tuple(got.shape) == ACQ.buffer_shape
    np.testing.assert_array_equal(got.numpy(), buf)
    other = FdOctModel(dataclasses.replace(ACQ, bit_depth=16), CFG, **COEFFS, device="cpu")
    with pytest.raises(ValueError, match="bit_depth=12"):
        other.put_packed_buffer(pack_uint12(buf))


# ---------------------------------------------------------------------------
# the engine's behaviours (tests/test_runtime.py)
# ---------------------------------------------------------------------------

def test_run_processes_all_buffers():
    eng = make_engine(n_buffers=6)
    assert eng.run() == 6
    assert not eng.running


def test_max_buffers_limit():
    assert make_engine(n_buffers=None).run(max_buffers=5) == 5


def test_streaming_decimation_and_quantization():
    got = []
    eng = make_engine(n_buffers=8, stream_to_host=True, streaming_skip=1,
                      on_processed=lambda buf, nr: got.append((buf, nr)))
    eng.run()
    assert len(got) == 4  # skip=1 -> every 2nd buffer
    buf, _ = got[0]
    assert buf.dtype == np.uint16 and buf.shape == ACQ.processed_buffer_shape
    assert buf.max() <= 4095


def test_extension_fanout_and_buffer_nr_wraps():
    eng = make_engine(n_buffers=4, stream_to_host=True)
    ext = _collect(eng)
    eng.run()
    assert [nr for _, _, nr in ext.raw_calls] == [0, 1, 0, 1]  # buffers_per_volume=2
    assert len(ext.processed_calls) == 4


def test_inactive_extension_not_fed():
    ext = CollectingExtension()
    mgr = ExtensionManager()
    mgr.add(ext)  # never activated
    make_engine(n_buffers=3, extensions=mgr, stream_to_host=True).run()
    assert ext.raw_calls == [] and ext.processed_calls == []


def test_recording_raw_and_processed(tmp_path):
    eng = make_engine(n_buffers=6, stream_to_host=True)
    eng.start_recording(RecordingParams(save_dir=str(tmp_path), name="t",
                                        buffers_to_record=2, save_raw=True,
                                        save_processed=True, save_meta=True))
    eng.run()
    raws = glob.glob(str(tmp_path / "*_raw_*.raw"))
    procs = glob.glob(str(tmp_path / "*_processed_*.raw"))
    assert len(raws) == 1 and len(procs) == 1
    assert len(glob.glob(str(tmp_path / "*_meta.json"))) == 1
    np.testing.assert_array_equal(
        np.fromfile(raws[0], np.uint16).reshape(2, *ACQ.buffer_shape),
        np.stack([SyntheticSource(ACQ).read_buffer(i) for i in range(2)]))
    assert np.fromfile(procs[0], np.uint16).size == \
        2 * ACQ.ascans_per_buffer * ACQ.output_ascan_length


def test_recording_float32_equals_process_buffer(tmp_path):
    """The float32 recorder stream is the model's output, buffer by buffer."""
    eng = make_engine(n_buffers=4)
    eng.start_recording(RecordingParams(save_dir=str(tmp_path), name="f",
                                        buffers_to_record=2, save_raw=False,
                                        save_processed=True, save_as_32bit_float=True,
                                        save_meta=False))
    eng.run()
    (f,) = glob.glob(str(tmp_path / "*_processed_float32_*.raw"))
    data = np.fromfile(f, np.float32).reshape(2, *ACQ.processed_buffer_shape)
    ref = make_model()
    for i in range(2):
        want = ref.fetch(ref.process_buffer(SyntheticSource(ACQ).read_buffer(i)))
        np.testing.assert_array_equal(data[i], want)


def test_scheduled_recording_series(tmp_path):
    eng = make_engine(n_buffers=60)
    eng.schedule_recordings(RecordingParams(save_dir=str(tmp_path), name="s",
                                            buffers_to_record=1, save_raw=True,
                                            save_meta=False), interval_s=0.0, total=3)
    eng.run()
    assert len(glob.glob(str(tmp_path / "*_raw_*.raw"))) == 3
    assert eng.scheduler.done == 3 and not eng.scheduler.active


def test_source_error_propagates():
    class BadSource:
        acq = ACQ

        def buffers(self):
            yield np.zeros(ACQ.buffer_shape, np.uint16)
            raise IOError("acquisition hardware vanished")

    for upload_prefetch in (True, False):
        eng = StreamingEngine(make_model(), BadSource(), upload_prefetch=upload_prefetch)
        with pytest.raises(IOError, match="vanished"):
            eng.run()
        assert not eng.running


def test_upload_error_propagates():
    """A failing upload is not retried or worked around: it leaves run()."""
    model = make_model()

    def failing_put(raw):
        raise RuntimeError("upload failed")

    model.put_buffer = failing_put
    eng = StreamingEngine(model, SyntheticSource(ACQ, n_buffers=3), upload_prefetch=True)
    with pytest.raises(RuntimeError, match="upload failed"):
        eng.run()


def test_on_volume_assembly():
    vols = []
    eng = make_engine(n_buffers=6, stream_to_host=True,
                      on_volume=lambda v, i: vols.append((v.copy(), i)))
    eng.run()
    assert [i for _, i in vols] == [0, 1, 2]
    v0 = vols[0][0]
    assert v0.shape == (2 * ACQ.bscans_per_buffer, ACQ.ascans_per_bscan,
                        ACQ.output_ascan_length)
    assert v0.dtype == np.float32 and 0.0 <= v0.min() and v0.max() <= 1.0
    assert v0.max() > 0.2  # normalized by the 12-bit code max, not 16x dark


def test_throughput_meter_matches_jax():
    """Windows, rates and the wire bytes of the packed-12 wire."""
    jacq = jparams.AcqParams(**dataclasses.asdict(ACQ))
    for wire_bytes in (None, ACQ.samples_per_buffer * 3 // 2):
        meter = ThroughputMeter(ACQ, window_s=5.0, wire_bytes_per_buffer=wire_bytes)
        jmeter = jruntime.ThroughputMeter(jacq, window_s=5.0,
                                          wire_bytes_per_buffer=wire_bytes)
        for i in range(13):
            a, b = meter.tick(now=100.0 + 0.9 * i), jmeter.tick(now=100.0 + 0.9 * i)
            assert (a is None) == (b is None)
            if a is not None:
                assert dataclasses.asdict(a) == dataclasses.asdict(b)
                assert a.info_line() == b.info_line()
        assert meter.total_buffers == 13 and meter.last is not None
    assert meter.last.wire_mb < meter.last.buffer_mb


def test_engine_wire_bytes():
    eng = make_engine(wire_format="packed12")
    assert eng.meter._wire_bytes == ACQ.samples_per_buffer * 3 // 2
    with pytest.raises(ValueError, match="wire_format"):
        make_engine(wire_format="packed10")


def test_record_post_background_flow():
    """Record-on-request background capture, installed as the curve of the
    post-process background removal (cuda_code.cu:743-767, 1556-1568)."""
    cfg = dataclasses.replace(CFG, post_background_removal=True,
                              post_background_weight=1.0, post_background_offset=0.0)
    model = make_model(cfg)
    assert not model.curves.post_background.any()
    outs = {}
    eng = StreamingEngine(model, SyntheticSource(ACQ, n_buffers=6), stream_to_host=True,
                          on_processed=lambda b, nr: outs.setdefault(len(outs), b))
    eng.record_post_background(2)
    assert eng.run() == 6
    bg = model.curves.post_background
    assert tuple(bg.shape) == (ACQ.output_ascan_length,) and bg.any()
    late = np.asarray(outs[max(outs)], np.float64)
    first = np.asarray(outs[0], np.float64)
    assert float(np.median(late)) < 0.5 * float(np.median(first))
    with pytest.raises(ValueError):
        eng.record_post_background(0)


def test_unfetched_buffers_carry_no_fetch():
    """With nothing streamed every in-flight entry holds no host buffer;
    on the CPU the step is complete when it returns, so it holds no event
    either (on a GPU: one CUDA event, tests/test_torch_kernels.py cases
    cover the device)."""
    eng = make_engine(n_buffers=8, stream_to_host=False, max_in_flight=2)
    drained = []
    orig = eng._drain_one

    def spy(in_flight):
        drained.append(tuple(in_flight[0]))
        orig(in_flight)

    eng._drain_one = spy
    assert eng.run() == 8
    assert len(drained) == 8
    for nr, host_float, host_quant, record_quant, done in drained:
        assert host_float is None and host_quant is None and done is None


def test_bf16_output_upcast_for_the_recorder(tmp_path):
    eng = make_engine(n_buffers=4, cfg=dataclasses.replace(CFG, output_dtype="bfloat16"))
    eng.start_recording(RecordingParams(save_dir=str(tmp_path), name="b",
                                        buffers_to_record=2, save_raw=False,
                                        save_processed=True, save_as_32bit_float=True,
                                        save_meta=False))
    eng.run()
    (f,) = glob.glob(str(tmp_path / "*_processed_float32_*.raw"))
    data = np.fromfile(f, np.float32)
    assert data.size == 2 * ACQ.ascans_per_buffer * ACQ.output_ascan_length
    assert np.isfinite(data).all()


@pytest.mark.parametrize("cfg,strategy", [
    (dataclasses.replace(CFG, fpn_mode=FpnMode.ONCE), "auto"),
    (_fold_cfg(), "scan"),
    (_fold_cfg(fold_concat=True), "auto"),
    (_fold_cfg(fold_concat=True), "batch"),
])
def test_dispatch_chunk_matches_per_buffer(cfg, strategy):
    """Chunked dispatch produces the stream of per-buffer dispatch, FPN
    state threading and a partial tail chunk included (7 % 3 != 0).  The
    "batch" strategy needs FPN determined, so its first chunk starts after
    the FPN buffer: 1 + 2 * 3 buffers."""

    def run(chunk):
        got = []
        eng = StreamingEngine(make_model(cfg), SyntheticSource(ACQ, n_buffers=7),
                              stream_to_host=True, dispatch_chunk=chunk,
                              chunk_strategy=strategy,
                              on_processed=lambda buf, nr: got.append((buf.copy(), nr)))
        if strategy == "batch":
            eng.model.process_buffer(SyntheticSource(ACQ).read_buffer(0))
        return eng.run(), got

    n1, per_buffer = run(1)
    n3, chunked = run(3)
    assert n1 == n3 == 7 and len(per_buffer) == len(chunked) == 7
    for (a, na), (b, nb) in zip(per_buffer, chunked):
        assert na == nb
        assert np.abs(a.astype(np.int64) - b.astype(np.int64)).max() <= 1


def test_stop_after_record_stops_stream(tmp_path):
    eng = make_engine(n_buffers=None)
    eng.start_recording(RecordingParams(save_dir=str(tmp_path), name="stop",
                                        buffers_to_record=3, save_raw=True,
                                        save_meta=False, stop_after_record=True))
    n = eng.run(max_buffers=100)
    assert 3 <= n < 100
    assert glob.glob(os.path.join(str(tmp_path), "*stop_raw*.raw"))


def test_recording_copies_settings_file(tmp_path):
    ini = tmp_path / "settings.ini"
    ini.write_text("[tpu]\nfold_concat = 1\n")
    eng = make_engine(n_buffers=3)
    eng.start_recording(RecordingParams(save_dir=str(tmp_path), name="meta",
                                        buffers_to_record=2, save_raw=True,
                                        save_meta=True, settings_file=str(ini)))
    eng.run()
    copies = glob.glob(os.path.join(str(tmp_path), "*meta_settings.ini"))
    assert copies and "fold_concat" in open(copies[0]).read()


def test_scheduled_series_honors_stop_after_record_only_at_the_end(tmp_path):
    eng = make_engine(n_buffers=None)
    eng.schedule_recordings(RecordingParams(save_dir=str(tmp_path), name="series",
                                            buffers_to_record=1, save_raw=True,
                                            save_meta=False, stop_after_record=True),
                            interval_s=0.0, total=3)
    n = eng.run(max_buffers=200)
    assert len(glob.glob(str(tmp_path / "*series_raw*.raw"))) == 3
    assert n < 200 and eng.scheduler.done == 3


def test_recording_screenshots_are_refused(tmp_path, monkeypatch):
    """Screenshots were refused until the renderer was ported; now they are
    written: B-scan, en-face and MIP-render PNGs next to the finished
    recording, the render on the model's device (as the JAX package's
    tests/test_runtime.py pins its CPU device), and a screenshot failure is
    reported through on_info without stopping the stream."""
    import octproz_tpu_torch.viz as viz
    from octproz_tpu_torch.viz.image import decode_png

    seen = []
    real = viz.render_volume

    def spy(*a, **kw):
        seen.append(kw.get("device"))
        # one intra-op thread: a thread per core in every xdist worker
        # oversubscribes the cores
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            return real(*a, **kw)
        finally:
            torch.set_num_threads(threads)

    monkeypatch.setattr(viz, "render_volume", spy)
    eng = make_engine(n_buffers=4, stream_to_host=True)
    eng.start_recording(RecordingParams(save_dir=str(tmp_path), name="shot",
                                        buffers_to_record=1, save_raw=False,
                                        save_processed=True, save_meta=False,
                                        save_screenshots=True))
    assert eng.run() == 4
    assert seen == [eng.model.device]
    shapes = {}
    for kind in ("bscan", "enface", "volume"):
        (path,) = glob.glob(str(tmp_path / f"*shot*_{kind}.png"))
        shapes[kind] = decode_png(open(path, "rb").read()).shape
    assert shapes == {"bscan": (ACQ.output_ascan_length, ACQ.ascans_per_bscan),
                      "enface": (ACQ.bscans_per_buffer, ACQ.ascans_per_bscan),
                      "volume": (256, 256, 3)}

    def broken(*a, **kw):
        raise RuntimeError("no renderer")

    monkeypatch.setattr(viz, "render_volume", broken)
    messages = []
    eng = make_engine(n_buffers=3, stream_to_host=True, on_info=messages.append)
    eng.start_recording(RecordingParams(save_dir=str(tmp_path / "broken"), name="shot",
                                        buffers_to_record=1, save_processed=True,
                                        save_meta=False, save_screenshots=True))
    assert eng.run() == 3  # the stream went on
    assert any("screenshot saving failed: no renderer" in m for m in messages)


def test_quantized_recording_without_streaming(tmp_path):
    eng = make_engine(n_buffers=None, stream_to_host=False)
    eng.start_recording(RecordingParams(save_dir=str(tmp_path), name="noq",
                                        buffers_to_record=2, save_raw=False,
                                        save_processed=True, save_meta=False,
                                        stop_after_record=True))
    assert eng.run(max_buffers=50) < 50
    assert glob.glob(str(tmp_path / "*noq_processed*.raw"))


def test_float_recording_keeps_quantized_extension_stream(tmp_path):
    eng = make_engine(n_buffers=6, stream_to_host=True, streaming_skip=1)
    ext = _collect(eng)
    eng.start_recording(RecordingParams(save_dir=str(tmp_path), name="both",
                                        buffers_to_record=6, save_raw=False,
                                        save_processed=True, save_as_32bit_float=True,
                                        save_meta=False))
    eng.run()
    (f,) = glob.glob(str(tmp_path / "*float32*.raw"))
    assert np.fromfile(f, np.float32).size == \
        6 * ACQ.ascans_per_buffer * ACQ.output_ascan_length
    assert len(ext.processed_calls) == 3
    assert all(np.issubdtype(buf.dtype, np.integer) for buf, _, _ in ext.processed_calls)


def test_extension_activated_mid_stream_gets_raw_data():
    eng = make_engine(n_buffers=8, stream_to_host=True)
    ext = CollectingExtension()
    eng.extensions.add(ext)
    seen = []

    def activate_late(host, nr):
        if len(seen) == 2:
            ext.activate()
        seen.append(nr)

    eng.on_processed = activate_late
    eng.run()
    assert ext.raw_calls


def test_recording_started_mid_stream_excludes_in_flight_quantized(tmp_path):
    eng = make_engine(n_buffers=12, stream_to_host=True, max_in_flight=4)

    def cb(host, nr):
        if not eng.recording and not glob.glob(str(tmp_path / "*")):
            eng.start_recording(RecordingParams(
                save_dir=str(tmp_path), name="mid", buffers_to_record=3, save_raw=False,
                save_processed=True, save_as_32bit_float=True, save_meta=False))

    eng.on_processed = cb
    eng.run()
    (f,) = glob.glob(str(tmp_path / "*float32*.raw"))
    data = np.fromfile(f, np.float32)
    assert data.size == 3 * ACQ.ascans_per_buffer * ACQ.output_ascan_length
    assert np.isfinite(data).all() and data.max() < 10.0  # no uint16 codes mixed in


def test_upload_prefetch_matches_inline_uploads():
    def collect(**kw):
        eng = make_engine(n_buffers=5, stream_to_host=True, **kw)
        ext = _collect(eng)
        assert eng.run() == 5
        return [c[0] for c in ext.processed_calls], [c[2] for c in ext.processed_calls]

    base, base_nr = collect(upload_prefetch=False)
    fed, fed_nr = collect(upload_prefetch=True)
    chunked, chunked_nr = collect(upload_prefetch=True, dispatch_chunk=2)
    assert base_nr == fed_nr == chunked_nr
    for a, b, c in zip(base, fed, chunked):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_upload_feeder_stages_device_tensors():
    """With upload_prefetch the step receives a tensor already on the
    model's device (no upload on the loop thread)."""
    model = make_model()
    seen = []
    orig = model.process_buffer

    def spy(raw):
        seen.append(isinstance(raw, torch.Tensor) and raw.device == model.device)
        return orig(raw)

    model.process_buffer = spy
    assert StreamingEngine(model, SyntheticSource(ACQ, n_buffers=3)).run() == 3
    assert seen == [True, True, True]


@pytest.mark.parametrize("kw", [{}, dict(upload_prefetch=False), dict(dispatch_chunk=3)])
def test_packed12_wire_matches_uint16_wire(kw):
    """The packed-12 wire gives the uint16 wire's output exactly, with the
    feeder, inline and chunked."""
    rng = np.random.default_rng(5)
    bufs = [rng.integers(0, 4096, ACQ.buffer_shape).astype(np.uint16) for _ in range(3)]

    def collect(src, **extra):
        eng = StreamingEngine(make_model(), ListSource(ACQ, src), stream_to_host=True,
                              **extra)
        ext = _collect(eng)
        assert eng.run() == 3
        return [c[0] for c in ext.processed_calls]

    base = collect(bufs)
    packed = collect([pack_uint12(b) for b in bufs], wire_format="packed12", **kw)
    for a, b in zip(base, packed):
        np.testing.assert_array_equal(a, b)


def test_packed12_raw_fanout_is_unpacked(tmp_path):
    """Raw extensions see sample values under the packed-12 wire; the raw
    recorder keeps the wire bytes verbatim."""
    rng = np.random.default_rng(6)
    bufs = [rng.integers(0, 4096, ACQ.buffer_shape).astype(np.uint16) for _ in range(2)]
    wire = [pack_uint12(b) for b in bufs]

    class RawCollector(Extension):
        name = "rawcollector"
        wants_raw_data = True

        def __init__(self):
            super().__init__()
            self.buffers = []

        def raw_data_received(self, buffer, *args):
            self.buffers.append(np.array(buffer))

    ext = RawCollector()
    exts = ExtensionManager()
    exts.add(ext)
    ext.activate()
    eng = StreamingEngine(make_model(), ListSource(ACQ, wire), extensions=exts,
                          wire_format="packed12")
    eng.start_recording(RecordingParams(save_dir=str(tmp_path), name="w",
                                        buffers_to_record=2, save_raw=True,
                                        save_meta=False))
    assert eng.run() == 2
    for got, want in zip(ext.buffers, bufs):
        assert got.shape == ACQ.buffer_shape
        np.testing.assert_array_equal(got, want)
    (f,) = glob.glob(str(tmp_path / "*_raw_*.raw"))
    np.testing.assert_array_equal(np.fromfile(f, np.uint8), np.concatenate(wire))


def test_stop_interrupts_run_while_upload_is_wedged():
    """stop() ends the run loop while the upload thread is wedged inside
    put_buffer: every wait polls the stop request."""
    model = make_model()
    release = threading.Event()
    orig = model.put_buffer

    def wedged_put(raw):
        release.wait(timeout=30.0)
        return orig(raw)

    model.put_buffer = wedged_put
    eng = StreamingEngine(model, SyntheticSource(ACQ, n_buffers=4), upload_prefetch=True)
    timer = threading.Timer(0.3, eng.stop)
    timer.start()
    t0 = time.monotonic()
    try:
        n = eng.run()
    finally:
        release.set()
        timer.join(timeout=5.0)
    assert n == 0
    assert time.monotonic() - t0 < 5.0


def test_virtual_source_drives_the_engine(tmp_path):
    """VirtualOctSource in both wire modes over one recorded file: the same
    stream (the chip smoke test's setup at a small size)."""
    from octproz_tpu_torch.io.source import VirtualOctSource

    rng = np.random.default_rng(9)
    bufs = np.stack([rng.integers(0, 4096, ACQ.buffer_shape).astype(np.uint16)
                     for _ in range(2)])
    pack_uint12(bufs).tofile(str(tmp_path / "v12.raw"))
    outs = []
    for keep in (False, True):
        src = VirtualOctSource(str(tmp_path / "v12.raw"), ACQ, packed_12bit=True,
                               keep_packed=keep, total_buffers_to_acquire=4)
        got = []
        eng = StreamingEngine(make_model(), src, stream_to_host=True,
                              wire_format="packed12" if keep else "uint16",
                              on_processed=lambda b, nr: got.append(b.copy()))
        assert eng.run() == 4
        outs.append(got)
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(outs[0][0], outs[0][2])  # the file wraps


def test_jax_source_feeds_the_port_engine():
    """A JAX package source object drives the port's engine: sources are
    plain numpy iterators."""
    jacq = jparams.AcqParams(**dataclasses.asdict(ACQ))
    got = []
    eng = StreamingEngine(make_model(), jsource.SyntheticSource(jacq, n_buffers=2),
                          stream_to_host=True, on_processed=lambda b, nr: got.append(b))
    assert eng.run() == 2 and len(got) == 2
