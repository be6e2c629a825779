"""The port's host-side pieces against the JAX package's: quantization,
the packed-12 unpacks, acquisition sources, recorders and their metadata,
volume assembly, the extension fan-out and the settings file.

Every comparison here is exact (the pieces are numpy, or integer and
float32 casts that both frameworks round the same way): inputs are made
from a seed with numpy and handed to both packages.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import octproz_tpu.io.recorder as jrecorder
import octproz_tpu.io.source as jsource
import octproz_tpu.io.volume as jvolume
import octproz_tpu.params as jparams
import octproz_tpu.plugins as jplugins
from octproz_tpu import native as jnative
from octproz_tpu.ops import convert as jconvert
from octproz_tpu.ops import quantize as jquantize
from octproz_tpu.utils import configmap as jconfigmap
from octproz_tpu.utils import settings as jsettings
from octproz_tpu_torch import plugins as tplugins
from octproz_tpu_torch.io import recorder as trecorder
from octproz_tpu_torch.io import source as tsource
from octproz_tpu_torch.io import volume as tvolume
from octproz_tpu_torch.ops import convert as tconvert
from octproz_tpu_torch.ops import quantize as tquantize
from octproz_tpu_torch.params import AcqParams, FpnMode, ProcConfig, default_full_config
from octproz_tpu_torch.utils import configmap as tconfigmap
from octproz_tpu_torch.utils import settings as tsettings

GEOM = dict(samples_per_line=64, ascans_per_bscan=8, bscans_per_buffer=4,
            buffers_per_volume=2)


def _acqs(bit_depth=12, **changes):
    kw = dict(GEOM, bit_depth=bit_depth, **changes)
    return AcqParams(**kw), jparams.AcqParams(**kw)


def _jax_cfg(cfg: ProcConfig):
    enums = {"fpn_mode": jparams.FpnMode, "interpolation": jparams.Interpolation}
    return jparams.ProcConfig(**{
        f.name: (enums[f.name](getattr(cfg, f.name).value) if f.name in enums
                 else getattr(cfg, f.name)) for f in dataclasses.fields(cfg)})


# ---------------------------------------------------------------------------
# quantize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [8, 10, 12, 16, 24, 32])
def test_quantize_matches_jax(bits):
    """Codes, container dtype and full-scale code per bit depth, with
    saturation below 0 and above 1 (and at +-inf); dequantize divides by
    the code max, not the container max."""
    rng = np.random.default_rng(bits)
    x = np.concatenate([rng.uniform(-0.5, 1.5, 500),
                        [0.0, 1.0, 0.5, 1e-9, 1 - 1e-7, -np.inf, np.inf, 7.0, -3.0]]
                       ).astype(np.float32)
    got = tquantize.quantize(torch.from_numpy(x), bits)
    want = np.asarray(jquantize.quantize(jnp.asarray(x), bits))
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    assert got.dtype == tquantize.output_dtype(bits)
    np.testing.assert_array_equal(got.numpy(), want)
    assert tquantize.code_max(bits) == jquantize.code_max(bits)
    assert got.numpy().max() == want.max() == np.asarray(
        jquantize.quantize(jnp.asarray([1.0], jnp.float32), bits))[0]
    np.testing.assert_array_equal(tquantize.dequantize(got.numpy(), bits),
                                  jquantize.dequantize(want, bits))
    np.testing.assert_array_equal(tquantize.dequantize(x, bits),
                                  jquantize.dequantize(x, bits))


def test_quantize_beyond_32_bits_and_bf16_input():
    x = torch.tensor([0.25, 2.0])
    assert tquantize.code_max(40) == jquantize.code_max(40) == 4294967040.0
    assert tquantize.quantize(x, 40).tolist() == [1073741760, 4294967040]
    got = tquantize.quantize(x.to(torch.bfloat16), 12)
    assert got.dtype == torch.uint16 and got.tolist() == [1023, 4095]


# ---------------------------------------------------------------------------
# packed-12 unpacks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 7, 256, 1000, 1001])
def test_host_unpack_and_pack_match_jax(n):
    """The host unpack and pack, odd tails included, byte for byte."""
    s = np.random.default_rng(n).integers(0, 4096, n).astype(np.uint16)
    packed = tconvert.pack_uint12(s)
    np.testing.assert_array_equal(packed, jnative.pack_uint12(s))
    got = tconvert.unpack_uint12_packed(packed, n)
    np.testing.assert_array_equal(got, jconvert.unpack_uint12_packed(packed, n))
    np.testing.assert_array_equal(got, s)
    with pytest.raises(ValueError, match="too small"):
        tconvert.unpack_uint12_packed(packed[:-2], n)


@pytest.mark.parametrize("n", [2, 100, 256, 1000, 4096])
def test_device_unpack_matches_jax(n):
    """unpack_uint12_device at sizes that are and are not multiples of 256
    (the JAX package takes its lane-aligned route for those, the port has
    one route): bit-identical."""
    wire = np.random.default_rng(n).integers(0, 256, n // 2 * 3).astype(np.uint8)
    got = tconvert.unpack_uint12_device(torch.from_numpy(wire), n)
    want = np.asarray(jconvert.unpack_uint12_device(jnp.asarray(wire), n))
    assert got.dtype == torch.uint16
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        tconvert.unpack_uint12_device(torch.from_numpy(wire), n + 1)
    with pytest.raises(ValueError):
        tconvert.unpack_uint12_device(torch.from_numpy(wire[:-3]), n)


@pytest.mark.parametrize("shape", [(2, 384), (3, 2, 768), (5, 12), (1, 1536 * 3 // 2)])
def test_row_unpack_matches_jax(shape):
    """unpack_uint12_rows keeps the leading axes: against JAX's row unpack
    where JAX takes the shape (multiples of 384 bytes), and against JAX's
    flat unpack of each line elsewhere (the port drops the 384-byte rule)."""
    wire = np.random.default_rng(len(shape)).integers(0, 256, shape).astype(np.uint8)
    got = tconvert.unpack_uint12_rows(torch.from_numpy(wire)).numpy()
    assert got.shape == shape[:-1] + (shape[-1] * 2 // 3,)
    if shape[-1] % 384 == 0:
        np.testing.assert_array_equal(got, np.asarray(jconvert.unpack_uint12_rows(
            jnp.asarray(wire))))
    flat = wire.reshape(-1, shape[-1])
    for line, row in zip(got.reshape(len(flat), -1), flat):
        np.testing.assert_array_equal(line, jconvert.unpack_uint12_packed(row, line.size))
    with pytest.raises(ValueError, match="multiple of 3"):
        tconvert.unpack_uint12_rows(torch.zeros((2, 10), dtype=torch.uint8))


# ---------------------------------------------------------------------------
# acquisition sources
# ---------------------------------------------------------------------------

SOURCE_CASES = {
    "u16-ram": dict(bit_depth=12),
    "u16-stream": dict(bit_depth=12, copy_to_ram=False),
    "u16-offset": dict(bit_depth=12, bscan_offset=3),
    "u16-big-endian": dict(bit_depth=12, big_endian=True, copy_to_ram=False),
    "u8": dict(bit_depth=8),
    "u32-stream": dict(bit_depth=32, copy_to_ram=False, bscan_offset=1),
    "packed": dict(bit_depth=12, packed_12bit=True),
    "packed-stream-offset": dict(bit_depth=12, packed_12bit=True, copy_to_ram=False,
                                 bscan_offset=2),
    "packed-keep": dict(bit_depth=12, packed_12bit=True, keep_packed=True),
    "packed-keep-stream": dict(bit_depth=12, packed_12bit=True, keep_packed=True,
                               copy_to_ram=False),
}


@pytest.mark.parametrize("name", list(SOURCE_CASES))
def test_virtual_source_matches_jax(tmp_path, name):
    """VirtualOctSource over the same file: the same buffers, byte for byte
    and of the same dtype, in RAM and streaming mode, packed-12 (unpacked or
    kept as wire bytes), big-endian, with a B-scan offset; the sequence
    wraps around the file."""
    kw = dict(SOURCE_CASES[name])
    bits = kw.pop("bit_depth")
    acq, jacq = _acqs(bits)
    path = str(tmp_path / "vol.raw")
    rng = np.random.default_rng(len(name))
    n_samples = 3 * acq.samples_per_buffer + 1000
    if kw.get("packed_12bit"):
        jnative.pack_uint12(rng.integers(0, 4096, n_samples)).tofile(path)
    else:
        dtype = {8: np.uint8, 12: np.uint16, 32: np.uint32}[bits]
        rng.integers(0, 4096, n_samples).astype(dtype).tofile(path)
    src = tsource.VirtualOctSource(path, acq, total_buffers_to_acquire=5, **kw)
    jsrc = jsource.VirtualOctSource(path, jacq, total_buffers_to_acquire=5, **kw)
    assert src.buffers_in_file == jsrc.buffers_in_file
    got, want = list(src.buffers()), list(jsrc.buffers())
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert isinstance(src, tsource.AcquisitionSource)


def test_virtual_source_refusals(tmp_path):
    acq, jacq = _acqs(12)
    path = str(tmp_path / "small.raw")
    np.zeros(acq.samples_per_buffer - 1, np.uint16).tofile(path)
    for mod, a in ((tsource, acq), (jsource, jacq)):
        with pytest.raises(ValueError, match="smaller than one buffer"):
            mod.VirtualOctSource(path, a)
        with pytest.raises(ValueError, match="keep_packed"):
            mod.VirtualOctSource(path, a, keep_packed=True)
        with pytest.raises(ValueError, match="big_endian"):
            mod.VirtualOctSource(path, a, packed_12bit=True, big_endian=True)
    with pytest.raises(EOFError):
        tsource.read_file_at(path, 0, acq.bytes_per_buffer)


def test_virtual_source_wait_time(tmp_path):
    import time

    acq, _ = _acqs(12)
    path = str(tmp_path / "v.raw")
    np.zeros(acq.samples_per_buffer, np.uint16).tofile(path)
    src = tsource.VirtualOctSource(path, acq, wait_time_us=20000,
                                   total_buffers_to_acquire=3)
    t0 = time.perf_counter()
    assert len(list(src.buffers())) == 3
    assert time.perf_counter() - t0 >= 0.06


@pytest.mark.parametrize("bits,seed", [(12, 0), (8, 3), (16, 7), (32, 1)])
def test_synthetic_source_matches_jax(bits, seed):
    acq, jacq = _acqs(bits)
    src = tsource.SyntheticSource(acq, n_buffers=3, seed=seed)
    jsrc = jsource.SyntheticSource(jacq, n_buffers=3, seed=seed)
    for g, w in zip(src.buffers(), jsrc.buffers()):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(src.read_buffer(11), jsrc.read_buffer(11))


# ---------------------------------------------------------------------------
# recorder, metadata, scheduler, volume assembly
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gate,count,feed", [(False, 2, 3), (True, 2, 5), (False, 4, 2)])
def test_recorder_files_match_jax(tmp_path, gate, count, feed):
    """The same buffers through both recorders give the same file names and
    bytes: first-buffer-of-volume gating, completion, the end-of-stream
    flush of a partial recording, and same-second series numbering."""
    rng = np.random.default_rng(count)
    bufs = [rng.integers(0, 4096, (4, 8, 32)).astype(np.uint16) for _ in range(feed)]
    paths = {}
    for tag, mod in (("port", trecorder), ("jax", jrecorder)):
        out = tmp_path / tag
        rec = mod.Recorder("raw")
        done = []
        rec.on_done = done.append
        params = mod.RecordingParams(save_dir=str(out), name="r", buffers_to_record=count,
                                     start_with_first_buffer_of_volume=gate)
        for _ in range(2):  # a second recording in the same second gets _2
            rec.start(params, timestamp="20260101_000000")
            for i, b in enumerate(bufs):
                rec.record_buffer(b, i % 2 if gate else 0)
            rec.flush()
        paths[tag] = sorted(os.listdir(out))
        assert done == [os.path.join(str(out), p) for p in paths[tag]]
    assert paths["port"] == paths["jax"] and len(paths["port"]) == 2
    for name in paths["port"]:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    rec = trecorder.Recorder("processed")
    rec.start(trecorder.RecordingParams(save_dir=str(tmp_path)))
    with pytest.raises(RuntimeError, match="already recording"):
        rec.start(trecorder.RecordingParams())
    rec.abort()
    assert not rec.recording and rec.flush() is None


def test_write_meta_matches_jax(tmp_path):
    """The JSON sidecar of the port's configuration equals the JAX
    package's for the same configuration (the timestamp aside)."""
    cfg = dataclasses.replace(default_full_config(), fold_concat=True, matmul_precision="high")
    acq, jacq = _acqs(12)
    params = trecorder.RecordingParams(save_dir=str(tmp_path), name="m", description="d")
    jparams_rec = jrecorder.RecordingParams(save_dir=str(tmp_path), name="m", description="d")
    a = trecorder.write_meta(str(tmp_path / "port"), acq, cfg, params, extra={"k": 1})
    b = jrecorder.write_meta(str(tmp_path / "jax"), jacq, _jax_cfg(cfg), jparams_rec,
                             extra={"k": 1})
    ma, mb = (json.load(open(p)) for p in (a, b))
    ma.pop("timestamp"), mb.pop("timestamp")
    assert ma == mb and ma["processing"]["fold_concat"] is True


def test_recording_scheduler_matches_jax():
    """Delay, interval, total and overlap retry on explicit clocks."""
    logs = {}
    for tag, mod in (("port", trecorder), ("jax", jrecorder)):
        busy = [False, True, False, False, False, False]
        calls = []

        def start():
            ok = not busy.pop(0)
            calls.append(ok)
            return ok

        sched = mod.RecordingScheduler(start, delay_s=1.0, interval_s=2.0,
                                       total_recordings=3, retry_s=0.5)
        sched.start(now=0.0)
        polls = [sched.poll(now=t) for t in (0.5, 1.0, 2.0, 3.0, 3.5, 5.0, 6.0, 9.0)]
        logs[tag] = (polls, calls, sched.done, sched.active)
    assert logs["port"] == logs["jax"]
    assert logs["port"][2] == 3 and not logs["port"][3]


def test_volume_assembler_matches_jax():
    """Blocks in order, out of order, decimated and wrapping: the same
    completed volumes and indices."""
    acq, jacq = _acqs(12, buffers_per_volume=3)
    order = [0, 1, 2, 1, 2, 0, 0, 1, 2, 2, 0, 1]
    rng = np.random.default_rng(2)
    blocks = [rng.uniform(0, 1, acq.processed_buffer_shape).astype(np.float32)
              for _ in order]
    seen = {"port": [], "jax": []}
    asm = {"port": tvolume.VolumeAssembler(
        acq, on_volume=lambda v, i: seen["port"].append((v.copy(), i))),
           "jax": jvolume.VolumeAssembler(
        jacq, on_volume=lambda v, i: seen["jax"].append((v.copy(), i)))}
    for k, blk in zip(order, blocks):
        outs = [asm[t].add(blk, k) for t in ("port", "jax")]
        assert (outs[0] is None) == (outs[1] is None)
    assert len(seen["port"]) == len(seen["jax"]) >= 2
    for (a, i), (b, j) in zip(seen["port"], seen["jax"]):
        assert i == j
        np.testing.assert_array_equal(a, b)
    assert asm["port"].volumes_completed == asm["jax"].volumes_completed
    np.testing.assert_array_equal(asm["port"].volume, asm["jax"].volume)


# ---------------------------------------------------------------------------
# extensions
# ---------------------------------------------------------------------------

def _collector(mod, name, raw, processed):
    class Collector(mod.Extension):
        wants_raw_data = raw
        wants_processed_data = processed

        def __init__(self):
            super().__init__()
            self.calls = []
            self.commands = []

        def raw_data_received(self, buffer, *args):
            self.calls.append(("raw", buffer.sum(), args))

        def processed_data_received(self, buffer, *args):
            self.calls.append(("processed", buffer.sum(), args))

        def receive_command(self, sender, command, params):
            self.commands.append((sender, command, params))

    Collector.name = name
    return Collector()


def test_extension_fanout_matches_jax():
    """Registry, activation and the data feeds' arguments; command routing
    and broadcast on the message bus; removal deactivates."""
    acq, jacq = _acqs(12)
    raw = np.arange(np.prod(acq.buffer_shape)).reshape(acq.buffer_shape) % 4096
    proc = np.ones(acq.processed_buffer_shape, np.uint16)
    logs = {}
    for tag, mod, a in (("port", tplugins, acq), ("jax", jplugins, jacq)):
        mgr = mod.ExtensionManager()
        exts = [_collector(mod, "both", True, True), _collector(mod, "raw", True, False),
                _collector(mod, "off", True, True)]
        for e in exts:
            mgr.add(e)
        mgr.activate("both")
        mgr.activate("raw")
        for nr in range(3):
            mgr.feed_raw(raw, a, nr)
            mgr.feed_processed(proc, a, 8, nr)
        assert mgr.bus.send_command("raw", "both", "go", {"x": 1})
        assert not mgr.bus.send_command("raw", "nobody", "go")
        mgr.bus.broadcast("both", "ping")
        mgr.remove("both")
        logs[tag] = ([e.calls for e in exts], [e.commands for e in exts],
                     exts[0].active, exts[0].bus is None, sorted(mgr.extensions),
                     exts[1].store_settings())
    assert logs["port"] == logs["jax"]
    assert len(logs["port"][0][0]) == 6 and len(logs["port"][0][1]) == 3
    assert logs["port"][0][2] == []


# ---------------------------------------------------------------------------
# settings file
# ---------------------------------------------------------------------------

INI = """[acquisition]
samples_per_line = 1024
ascans_per_bscan = 512
bscans_per_buffer = 256
bit_depth = 12
packed_12bit = 1
copy_file_to_ram = 0

[processing]
bitshift = 1
resampling = 1
resampling_interpolation = cubic
dispersion_compensation = 1
windowing = 1
fixed_pattern_removal = 1
fixed_pattern_removal_continuously = 0
log = 1
max = 70.5
resampling_c1 = 1023.0
resampling_c2 = 20.0
dispersion_compensation_d2 = 10.0
window_type = hanning

[tpu]
fft_via_matmul = 1
fold_concat = 1
matmul_precision = high

[streaming]
streaming_enabled = 1
streaming_skip = 0

[record]
path = /tmp/rec
volumes = 4
record_processed = 1
save_as_32_bit_float = 1
stop_after_record = 1
"""


def _both_bundles(tmp_path, text):
    path = tmp_path / "settings.ini"
    path.write_text(text)
    return (tconfigmap.from_settings(tsettings.SettingsManager(str(path))),
            jconfigmap.from_settings(jsettings.SettingsManager(str(path))))


def test_settings_file_selects_fold_concat_as_in_jax(tmp_path):
    """One INI text: the port's bundle and (AcqParams, ProcConfig) equal the
    JAX package's -- [tpu] fold_concat, [streaming] and [record] included."""
    b, jb = _both_bundles(tmp_path, INI)
    acq, cfg = tconfigmap.build_config(b, require_geometry=True)
    jacq, jcfg = jconfigmap.build_config(jb, require_geometry=True)
    assert dataclasses.asdict(acq) == dataclasses.asdict(jacq)
    assert _jax_cfg(cfg) == jcfg
    assert cfg.fold_concat and cfg.fft_via_matmul and cfg.fpn_mode == FpnMode.ONCE
    for field in ("source_kwargs", "streaming", "recording"):
        assert getattr(b, field) == getattr(jb, field)
    assert {k: v for k, v in b.curve_kwargs.items() if k != "window_type"} == \
        {k: v for k, v in jb.curve_kwargs.items() if k != "window_type"}
    assert b.curve_kwargs["window_type"].value == jb.curve_kwargs["window_type"].value
    assert b.streaming == {"stream_to_host": True, "streaming_skip": 0}
    assert b.recording["save_as_32bit_float"] and b.recording["buffers_to_record"] == 4


@pytest.mark.parametrize("seed", range(3))
def test_settings_round_trip_is_read_by_jax(tmp_path, seed):
    """A configuration written by the port's to_settings reads back equal
    in the port and in the JAX package."""
    rng = np.random.default_rng(seed)
    flip = lambda: bool(rng.integers(0, 2))  # noqa: E731
    concat = flip()
    acq = AcqParams(samples_per_line=int(rng.choice([256, 1024, 1664])),
                    ascans_per_bscan=int(rng.integers(4, 512)),
                    bscans_per_buffer=int(rng.integers(1, 256)),
                    buffers_per_volume=int(rng.integers(1, 8)),
                    bit_depth=int(rng.choice([8, 12, 16])))
    cfg = ProcConfig(bitshift=flip(), resampling=flip(), windowing=flip(),
                     dispersion=flip(), fpn_mode=FpnMode(rng.choice(["off", "once"])),
                     grayscale_max=float(np.round(60 + rng.normal(), 6)),
                     fft_via_matmul=True, fold_concat=concat,
                     matmul_precision=str(rng.choice(["default", "high", "highest"])),
                     output_dtype=str(rng.choice(["float32", "bfloat16"])))
    streaming = dict(stream_to_host=flip(), streaming_skip=int(rng.integers(0, 4)))
    recording = dict(save_dir="/tmp/r", name=f"n{seed}", buffers_to_record=3,
                     save_processed=flip(), save_as_32bit_float=flip())
    path = str(tmp_path / "s.ini")
    sm = tsettings.SettingsManager(path)
    tconfigmap.to_settings(sm, acq=acq, cfg=cfg, streaming=streaming, recording=recording)
    sm.save()
    assert os.path.exists(path) and not os.path.exists(path + ".backup")
    sm.save()
    assert os.path.exists(path + ".backup")
    b = tconfigmap.from_settings(tsettings.SettingsManager(path))
    jb = jconfigmap.from_settings(jsettings.SettingsManager(path))
    acq2, cfg2 = tconfigmap.build_config(b)
    jacq2, jcfg2 = jconfigmap.build_config(jb)
    assert acq2 == acq and cfg2 == cfg
    assert _jax_cfg(cfg2) == jcfg2 and dataclasses.asdict(jacq2) == dataclasses.asdict(acq)
    assert b.streaming == jb.streaming == streaming
    assert b.recording == jb.recording == recording


def test_settings_refusals_name_the_roadmap(tmp_path):
    """What the port does not run raises naming its ROADMAP.md item; bad
    values raise as in the JAX package.  ``compute_dtype = bfloat16`` and
    ``[plugins] load``, once refused, now parse as in the JAX package."""
    b, jb = _both_bundles(tmp_path, INI.replace("matmul_precision = high",
                                                "compute_dtype = bfloat16"))
    acq, cfg = tconfigmap.build_config(b)
    jacq, jcfg = jconfigmap.build_config(jb)
    assert cfg.compute_dtype == "bfloat16" and _jax_cfg(cfg) == jcfg
    assert dataclasses.asdict(acq) == dataclasses.asdict(jacq)
    path = tmp_path / "p.ini"
    path.write_text("[plugins]\nload = pkg.mod:factory; other.mod, \n")
    pb = tconfigmap.from_settings(tsettings.SettingsManager(str(path)))
    jpb = jconfigmap.from_settings(jsettings.SettingsManager(str(path)))
    assert pb.plugins == jpb.plugins == ["pkg.mod:factory", "other.mod"]
    assert dataclasses.asdict(pb) == dataclasses.asdict(jpb)
    for text, match in (("[processing]\nwindow_type = blackman\n", r"\[processing\] window_type"),
                        ("[acquisition]\nbit_depth = twelve\n", r"\[acquisition\] bit_depth")):
        path.write_text(text)
        for mod, sm in ((tconfigmap, tsettings), (jconfigmap, jsettings)):
            with pytest.raises(ValueError, match=match):
                mod.from_settings(sm.SettingsManager(str(path)))
    with pytest.raises(ValueError, match="geometry"):
        tconfigmap.build_config(tconfigmap.SettingsBundle(), require_geometry=True)


def test_settings_manager_matches_jax(tmp_path):
    """Groups, typed getters, key case, copy_to and reload."""
    out = {}
    for tag, mod in (("port", tsettings), ("jax", jsettings)):
        path = str(tmp_path / tag / "s.ini")
        sm = mod.SettingsManager(path)
        sm.set_group("extension:x", {"filePath": "/a", "n": 3, "f": 0.5, "b": True})
        sm.update_group("extension:x", {"n": "4.0"})
        sm.save(timestamp=False)
        sm.reload()
        copy = sm.copy_to(str(tmp_path / tag / "copy.ini"))
        out[tag] = (sm.get_group("extension:x"), sm.get_int("extension:x", "n"),
                    sm.get_float("extension:x", "f"), sm.get_bool("extension:x", "b"),
                    sm.get("nope", "k", "dflt"), sorted(sm.get_group("main")),
                    os.path.basename(copy))
    assert out["port"] == out["jax"]
    assert tsettings.default_settings_path() == jsettings.default_settings_path()
