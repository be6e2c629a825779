"""The port's bundled extensions and plugin loading on the CPU against the
JAX package's: statistics, signal monitor, peaks and PSF fit, the demo
extension, the socket stream, the cameras, the k-lin phase extraction,
the dispersion estimator, the plugin loader (module specs, entry points,
the plugin context) and the ``[plugins] load`` settings key.

Comparisons are exact (numpy on both sides, the same inputs made from a
seed), except the dispersion estimator: the port runs it in torch, the JAX
package under XLA, and their float32 sums differ in order.  Measured on the
CPU on both recipes of tests/test_extensions.py (d2 = 40; d2 = 35,
d3 = -25), and on the d2-only and the small-grid searches: the same d2 and
d3 (gap 0), the sharpness metric within 1.6e-6 relative.  The test holds d2
and d3 to one final grid step (4/14 of the coarse step) and the metric to
1e-5 relative.  Every socket wait has a timeout.
"""

import dataclasses
import json
import socket
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

import octproz_tpu.curves as jcurves
import octproz_tpu.extensions as jext
import octproz_tpu.extensions.demo as jdemo
import octproz_tpu.extensions.peaks as jpeaks
import octproz_tpu.params as jparams
from octproz_tpu.utils import configmap as jconfigmap
from octproz_tpu.utils import settings as jsettings
from octproz_tpu_torch import curves as tcurves
from octproz_tpu_torch import extensions as text
from octproz_tpu_torch.extensions import demo as tdemo
from octproz_tpu_torch.extensions import peaks as tpeaks
from octproz_tpu_torch.extensions.socketstream import read_frame
from octproz_tpu_torch.io.systems import SystemRegistry
from octproz_tpu_torch.models.fdoct import FdOctModel
from octproz_tpu_torch.params import AcqParams, ProcConfig, WindowType
from octproz_tpu_torch.plugins import (ENTRY_POINT_GROUP, ExtensionManager, MessageBus,
                                       Plugin, PluginContext, discover_entry_point_plugins,
                                       load_plugin, load_plugins)
from octproz_tpu_torch.runtime import StreamingEngine
from octproz_tpu_torch.utils import configmap as tconfigmap
from octproz_tpu_torch.utils import settings as tsettings
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

SOCKET_TIMEOUT_S = 5.0


def _buffers(seed, shape=(2, 8, 64)):
    rng = np.random.default_rng(seed)
    return {"u16": rng.integers(0, 4096, shape).astype(np.uint16),
            "u8": rng.integers(0, 256, shape).astype(np.uint8),
            "f32": rng.uniform(-1.0, 3.0, shape).astype(np.float32)}


def _feed(ext, method, buf, bits, nr=0):
    ext.activate()
    getattr(ext, method)(buf, bits, buf.shape[-1], buf.shape[1], buf.shape[0], 1, nr)
    return ext


# ---------------------------------------------------------------------------
# statistics, peaks, demo
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,bits", [("u16", 12), ("u8", 8), ("f32", 32)])
def test_image_statistics_match_jax(kind, bits):
    buf = _buffers(1)[kind]
    got = _feed(text.ImageStatisticsExtension(n_bins=16), "processed_data_received", buf, bits)
    want = _feed(jext.ImageStatisticsExtension(n_bins=16), "processed_data_received", buf, bits)
    for f in ("minimum", "maximum", "mean", "std"):
        assert getattr(got.last, f) == getattr(want.last, f)
    np.testing.assert_array_equal(got.last.histogram, want.last.histogram)
    np.testing.assert_array_equal(got.last.bin_edges, want.last.bin_edges)
    assert json.dumps(got.get_output()) == json.dumps(want.get_output())


def test_image_statistics_decimation():
    ext = text.ImageStatisticsExtension(frame_decimation=3)
    ext.activate()
    buf = _buffers(2)["u16"]
    seen = []
    for nr in range(7):
        ext.last = None
        ext.processed_data_received(buf + nr, 12, 64, 8, 2, 1, nr)
        seen.append(ext.last is not None)
    assert seen == [True, False, False, True, False, False, True]


@pytest.mark.parametrize("kind,bits", [("u16", 12), ("u8", 8)])
def test_signal_monitor_matches_jax(kind, bits):
    buf = _buffers(3)[kind]
    buf.reshape(-1)[:40] = 2 ** bits - 1
    buf.reshape(-1)[40:60] = 0
    got = _feed(text.SignalMonitorExtension(), "raw_data_received", buf, bits)
    want = _feed(jext.SignalMonitorExtension(), "raw_data_received", buf, bits)
    assert dataclasses.asdict(got.last) == dataclasses.asdict(want.last)
    assert got.last.saturation_fraction >= 40 / buf.size
    assert got.get_output() == want.get_output()


def _lines(seed, n=256):
    rng = np.random.default_rng(seed)
    x = np.arange(n)
    line = rng.uniform(0.0, 0.05, n)
    for _ in range(4):
        line += rng.uniform(0.2, 1.0) * np.exp(-0.5 * ((x - rng.uniform(10, n - 10))
                                                       / rng.uniform(1.5, 4.0)) ** 2)
    return line


@pytest.mark.parametrize("seed", range(4))
def test_find_peaks_and_psf_fit_match_jax(seed):
    line = _lines(seed)
    for kw in ({}, dict(threshold=0.3, max_peaks=2, min_distance=6)):
        got, want = tpeaks.find_peaks(line, **kw), jpeaks.find_peaks(line, **kw)
        assert [dataclasses.asdict(p) for p in got] == [dataclasses.asdict(p) for p in want]
    for kw in ({}, dict(peak_index=int(np.argsort(line)[-3]), half_window=5)):
        assert dataclasses.asdict(tpeaks.fit_axial_psf(line, **kw)) == \
            dataclasses.asdict(jpeaks.fit_axial_psf(line, **kw))


def test_fwhm_interpolates_both_crossings_correctly():
    peaks = tpeaks.find_peaks(np.array([0.0, 0.2, 1.0, 0.2, 0.0]))
    assert len(peaks) == 1 and peaks[0].fwhm == pytest.approx(1.25, abs=1e-6)


@pytest.mark.parametrize("kind,bits", [("u16", 12), ("f32", 32)])
def test_line_extensions_match_jax(kind, bits):
    """The peak detector and the PSF analyzer on a processed stream: the
    selected line is dequantized by the code max (or passed through)."""
    vol = np.stack([np.stack([_lines(b * 8 + a, 128) for a in range(8)]) for b in range(2)])
    buf = (vol / vol.max() * 4095).astype(np.uint16) if kind == "u16" else vol.astype(np.float32)
    for cls, kw in (("PeakDetectorExtension", dict(bscan=1, ascan=3, threshold=0.05)),
                    ("AxialPsfAnalyzerExtension", dict(bscan=5, ascan=30))):  # clamped
        got = _feed(getattr(text, cls)(**kw), "processed_data_received", buf, bits)
        want = _feed(getattr(jext, cls)(**kw), "processed_data_received", buf, bits)
        assert got.get_output() == want.get_output() is not None


def test_demo_extension_matches_jax():
    buf = _buffers(5)["u16"]
    exts = [mod.DemoExtension(frame_decimation=2) for mod in (tdemo, jdemo)]
    for ext in exts:
        ext.activate()
        for nr in range(5):
            ext.processed_data_received(buf + nr, 12, 64, 8, 2, 1, nr)
        ext.receive_command("test", "set_decimation", {"value": 5})
    got, want = exts
    assert got.frames_seen == want.frames_seen == 5
    assert got.average_intensity == want.average_intensity
    assert got.frame_decimation == want.frame_decimation == 5


def test_demo_extension_reentrancy_guard():
    ext = tdemo.DemoExtension()
    ext.activate()
    ext._busy.acquire()  # a previous frame still being processed
    try:
        ext.processed_data_received(np.full((1, 2, 8), 2047, np.uint16), 12, 8, 2, 1, 1, 0)
    finally:
        ext._busy.release()
    assert ext.frames_seen == 1 and ext.average_intensity is None


# ---------------------------------------------------------------------------
# socket stream
# ---------------------------------------------------------------------------

class _EchoPlugin(Plugin):
    name = "echo"

    def __init__(self):
        super().__init__()
        self.received = []

    def receive_command(self, sender, command, params):
        self.received.append((sender, command, params))


def _send(sf, obj):
    sf.write((json.dumps(obj) + "\n").encode() if not isinstance(obj, bytes) else obj)
    sf.flush()


def test_socket_stream_roundtrip():
    bus = MessageBus()
    echo = _EchoPlugin()
    bus.register(echo)
    srv = text.SocketStreamServer(bus=bus)
    srv.start()
    try:
        with socket.create_connection((srv.host, srv.port), timeout=SOCKET_TIMEOUT_S) as s:
            sf = s.makefile("rwb")
            _send(sf, {"command": "ping"})
            assert read_frame(sf)["reply"] == "pong"
            _send(sf, {"command": "subscribe"})
            assert read_frame(sf)["reply"] == "subscribed"
            frame = np.arange(24, dtype=np.uint16).reshape(2, 3, 4)
            srv.processed_data_received(frame, 12, 4, 3, 2, 1, 7)
            msg = read_frame(sf)
            assert msg["type"] == "frame" and msg["buffer_nr"] == 7
            np.testing.assert_array_equal(msg["data"], frame)
            _send(sf, {"command": "set_gain", "target": "echo", "value": 3})
            assert read_frame(sf)["reply"] == "ok"
            assert echo.received == [("socket-stream", "set_gain", {"value": 3})]
            _send(sf, {"command": "nonsense", "target": "ghost"})
            assert read_frame(sf)["reply"] == "unknown command"
            _send(sf, {"what": "no command"})
            assert read_frame(sf)["error"] == "missing command"
            _send(sf, b"not json\n")
            assert "error" in read_frame(sf)
            _send(sf, {"command": "unsubscribe"})
            assert read_frame(sf)["reply"] == "unsubscribed"
    finally:
        srv.stop()


def test_socket_stream_survives_non_dict_json_and_stalled_subscriber():
    """A non-dict JSON line gets an error reply (not a dropped connection),
    and a subscriber that stops reading has frames DROPPED while the caller
    of push_frame (the engine thread) never blocks."""
    srv = text.SocketStreamServer(bus=MessageBus())
    srv.start()
    try:
        with socket.create_connection((srv.host, srv.port), timeout=SOCKET_TIMEOUT_S) as s:
            sf = s.makefile("rwb")
            _send(sf, b"[1, 2]\n")
            assert "error" in read_frame(sf)
            _send(sf, {"command": "ping"})
            assert read_frame(sf)["reply"] == "pong"  # the connection survived
            _send(sf, {"command": "subscribe"})
            assert read_frame(sf)["reply"] == "subscribed"
            frame = np.zeros((64, 64, 256), np.float32)  # 4 MB each
            t0 = time.monotonic()
            for nr in range(20):
                srv.processed_data_received(frame, 32, 256, 64, 64, 1, nr)
            assert time.monotonic() - t0 < SOCKET_TIMEOUT_S
            client = srv._server._clients[0]
            assert client.frames_dropped > 0
            assert srv.frames_dropped == client.frames_dropped
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# cameras
# ---------------------------------------------------------------------------

def _camera_dir(tmp_path, n=3):
    from PIL import Image

    d = tmp_path / "cam"
    d.mkdir()
    for i in range(n):
        Image.fromarray(np.full((8, 12, 3), 40 * i, np.uint8)).save(d / f"f{i}.png")
    return str(d)


def test_directory_camera_cycles_and_snapshots(tmp_path):
    from PIL import Image

    src = text.DirectoryCamera(_camera_dir(tmp_path), fps=10.0)
    cam = text.CameraExtension(src)
    seen = []
    for i in range(4):
        src._t0 = time.monotonic() - i / src.fps  # advance the frame clock
        f = cam.current_frame()
        assert f.shape == (8, 12, 3) and f.dtype == np.uint8
        seen.append(int(f[0, 0, 0]))
    assert seen == [0, 40, 80, 0]
    assert cam.frames_served == 4
    snap = cam.snapshot(str(tmp_path / "out" / "snap.png"))
    assert snap and np.asarray(Image.open(snap)).shape == (8, 12, 3)


def test_callable_camera_and_empty_dir(tmp_path):
    with pytest.raises(ValueError, match="no '\\*.png' frames"):
        text.DirectoryCamera(str(tmp_path))
    frames = [None, np.ones((4, 4), np.int64)]
    cam = text.CameraExtension(text.CallableCamera(lambda: frames.pop(0) if frames else None))
    assert cam.snapshot(str(tmp_path / "none.png")) is None  # nothing yet
    got = cam.current_frame()
    assert got.dtype == np.uint8 and got.shape == (4, 4)
    assert cam.current_frame() is got  # source dry: the last frame sticks
    assert cam.frames_served == 1


def test_extensions_import_without_pillow_or_jax():
    """The card's machine has no Pillow and no JAX: the package imports
    without either (Pillow is read only when a frame file is)."""
    import subprocess

    code = ("import sys; sys.modules['PIL'] = None; sys.modules['jax'] = None; "
            "sys.modules['octproz_tpu'] = None; import octproz_tpu_torch.extensions as e; "
            "import numpy as np; "
            "c = e.CameraExtension(e.CallableCamera(lambda: np.zeros((2, 2), np.uint8))); "
            "assert c.current_frame().shape == (2, 2)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=str(__import__("pathlib").Path(__file__).parents[1]))
    assert proc.returncode == 0, proc.stderr


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

KLIN_CASES = {
    "warped": dict(n=512, f=60.0, warp=30.0, kw={}),
    "warped-smooth": dict(n=512, f=60.0, warp=30.0, kw=dict(smooth_bins=5)),
    "linear-band": dict(n=256, f=30.0, warp=0.0, kw=dict(band=(20, 40))),
    "lines": dict(n=256, f=45.0, warp=-12.0, kw={}, lines=6),
}


@pytest.mark.parametrize("name", list(KLIN_CASES))
def test_extract_klin_curve_matches_jax(name):
    c = KLIN_CASES[name]
    n = c["n"]
    x = np.arange(n, dtype=np.float64)
    g = x + c["warp"] * np.sin(np.pi * x / n)
    spectra = np.cos(2 * np.pi * c["f"] * g / n) * 500 + 1000
    if "lines" in c:
        rng = np.random.default_rng(7)
        spectra = spectra + rng.normal(0, 5, (c["lines"], n))
    got = text.extract_klin_curve(spectra, **c["kw"])
    want = jext.extract_klin_curve(spectra, **c["kw"])
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


DISP_ACQ = dict(samples_per_line=256, ascans_per_bscan=32, bscans_per_buffer=1,
                buffers_per_volume=1, bit_depth=12)


def _dispersed_raw(d2_true, d3_true=0.0, n=256, f=40.0):
    """tests/test_extensions.py's chirped interferogram: real fringes with
    the polynomial phase error phi_{d2,d3}(x)."""
    phi = np.asarray(tcurves.polynomial_curve(
        tcurves.normalize_poly_coeffs(0.0, 0.0, d2_true, d3_true, n), n))
    x = np.arange(n)
    line = 2000 + 1000 * np.cos(2 * np.pi * f * x / n + phi)
    return np.clip(np.tile(line, (1, DISP_ACQ["ascans_per_bscan"], 1)), 0, 4095).astype(np.uint16)


DISP_CASES = {
    "d2": (40.0, 0.0, {}),
    "d2-d3": (35.0, -25.0, {}),
    "d2-only": (35.0, -25.0, dict(estimate_d3=False)),
    "small-grid": (20.0, 0.0, dict(d2_range=(-60, 60), n_grid=25, refine_iters=1)),
}


@pytest.mark.parametrize("name", list(DISP_CASES))
def test_estimate_dispersion_matches_jax(name):
    d2_true, d3_true, kw = DISP_CASES[name]
    cfg = ProcConfig(windowing=True, dispersion=True)
    jcfg = jparams.ProcConfig(windowing=True, dispersion=True)
    acq, jacq = AcqParams(**DISP_ACQ), jparams.AcqParams(**DISP_ACQ)
    cv = tcurves.make_curves(acq, cfg, window_type=WindowType.HANNING, device="cpu")
    jcv = jcurves.make_curves(jacq, jcfg, window_type=jparams.WindowType.HANNING)
    raw = _dispersed_raw(d2_true, d3_true)
    d2, d3, metric = text.estimate_dispersion_coeffs(raw, acq, cfg, cv, **kw, device="cpu")
    jd2, jd3, jmetric = jext.estimate_dispersion_coeffs(raw, jacq, jcfg, jcv, **kw)
    n_grid = kw.get("n_grid", 41)
    d2_range = kw.get("d2_range", (-100, 100))
    step = (d2_range[1] - d2_range[0]) / (n_grid - 1) * 4 / 14  # the final zoom's step
    assert abs(d2 - jd2) <= step and abs(d3 - jd3) <= step
    assert metric == pytest.approx(jmetric, rel=1e-5)
    if kw.get("estimate_d3", True):  # the search finds the compensator
        assert abs(d2 - d2_true) < 5.0 and abs(d3 - d3_true) < 5.0


def test_estimate_dispersion_runs_on_the_given_device_only():
    """``device`` is required, and fold-path curves (window and resample
    matrix as host arrays) are moved there for the prep."""
    acq = AcqParams(**DISP_ACQ)
    cfg = ProcConfig(windowing=True, dispersion=True, resampling=True, fft_via_matmul=True)
    cv = tcurves.make_curves(acq, cfg, resample_coeffs=(0.0, 255.0, 0.0, 0.0),
                             window_type=WindowType.HANNING, device="cpu")
    assert isinstance(cv.window, np.ndarray)
    with pytest.raises(TypeError, match="device"):
        text.estimate_dispersion_coeffs(_dispersed_raw(20.0), acq, cfg, cv)
    d2, _, _ = text.estimate_dispersion_coeffs(_dispersed_raw(20.0), acq, cfg, cv,
                                               d2_range=(-60, 60), estimate_d3=False,
                                               n_grid=25, refine_iters=2,
                                               device=torch.device("cpu"))
    assert abs(d2 - 20.0) < 6.0


def test_dispersion_estimator_stateful():
    acq = AcqParams(**DISP_ACQ)
    cfg = ProcConfig(windowing=True, dispersion=True)
    est = text.DispersionEstimator(acq, cfg, tcurves.make_curves(acq, cfg, device="cpu"),
                                   device="cpu")
    with pytest.raises(RuntimeError):
        est.estimate()
    est.feed(_dispersed_raw(20.0))
    d2, d3, _ = est.estimate(d2_range=(-60, 60), n_grid=25, refine_iters=1)
    assert abs(d2 - 20.0) < 6.0


# ---------------------------------------------------------------------------
# plugin loading
# ---------------------------------------------------------------------------

PLUGIN_SOURCE = '''
"""An out-of-tree plugin for the port: a system and an extension."""

import numpy as np

from octproz_tpu_torch.params import AcqParams
from octproz_tpu_torch.plugins import Extension


class BufferCounterExtension(Extension):
    name = "buffer_counter"
    wants_processed_data = True

    def __init__(self):
        super().__init__()
        self.count = 0

    def processed_data_received(self, buffer, bit_depth, *rest):
        self.count += 1

    def get_output(self):
        return {"scalars": {"buffers_seen": self.count}}


class RampSource:
    def __init__(self, acq, n_buffers=3):
        self.acq, self.n_buffers = acq, n_buffers

    def buffers(self):
        for i in range(self.n_buffers):
            yield np.full(self.acq.buffer_shape, 64 * (i + 1), np.uint16)

    def close(self):
        pass


def make_ramp_system(settings):
    acq = AcqParams(samples_per_line=int(settings.get("samples", 64)),
                    ascans_per_bscan=int(settings.get("ascans", 16)),
                    bscans_per_buffer=int(settings.get("bscans", 2)),
                    buffers_per_volume=1, bit_depth=12)
    return RampSource(acq, n_buffers=int(settings.get("n_buffers", 3)))


def octproz_plugin(ctx):
    ctx.register_system("ramp", make_ramp_system)
    return BufferCounterExtension()


def returns_a_callable(ctx):
    return make_ramp_system
'''


@pytest.fixture
def plugin_path(tmp_path):
    (tmp_path / "myoct_torch_plugin.py").write_text(PLUGIN_SOURCE)
    sys.path.insert(0, str(tmp_path))
    try:
        yield tmp_path
    finally:
        sys.path.remove(str(tmp_path))
        sys.modules.pop("myoct_torch_plugin", None)


def _ctx(**kw):
    return PluginContext(extensions=ExtensionManager(), systems=SystemRegistry(), **kw)


def test_load_module_default_entry(plugin_path):
    ctx = _ctx()
    load_plugin("myoct_torch_plugin", ctx)
    assert ctx.loaded == [("system", "ramp"), ("extension", "buffer_counter")]
    assert "buffer_counter" in ctx.extensions.extensions
    assert ctx.systems.names == ["ramp"]


def test_load_explicit_factory_attr(plugin_path):
    ctx = _ctx()
    load_plugin("myoct_torch_plugin:octproz_plugin", ctx)
    assert "ramp" in ctx.systems.names


def test_load_extension_class_target(plugin_path):
    ctx = _ctx()
    load_plugin("myoct_torch_plugin:BufferCounterExtension", ctx)
    assert ctx.loaded == [("extension", "buffer_counter")]


def test_loading_refusals_are_loud(plugin_path):
    with pytest.raises(ValueError, match="octproz_plugin"):
        load_plugin("numpy", _ctx())
    with pytest.raises(TypeError, match="plugin target"):
        load_plugin("numpy:__version__", _ctx())
    with pytest.raises(TypeError, match="returned another callable"):
        load_plugin("myoct_torch_plugin:returns_a_callable", _ctx())
    with pytest.raises(RuntimeError, match="registry"):
        load_plugin("myoct_torch_plugin", PluginContext())
    with pytest.raises(ModuleNotFoundError):
        load_plugin("module_that_does_not_exist", _ctx())


def test_extension_settings_group_round_trip(plugin_path):
    ctx = _ctx(settings={"extension:buffer_counter": {"gain": "3"}})
    load_plugin("myoct_torch_plugin", ctx)
    assert ctx.extensions.extensions["buffer_counter"].settings == {"gain": "3"}


def test_loaded_system_and_extension_end_to_end(plugin_path):
    """A loaded system feeds a loaded extension through the port's streaming
    engine on the CPU."""
    ctx = _ctx()
    load_plugins(["myoct_torch_plugin"], ctx, entry_points=False)
    src = ctx.systems.activate("ramp")
    ext = ctx.extensions.extensions["buffer_counter"]
    ext.activate()
    model = FdOctModel(src.acq, ProcConfig(),
                       resample_coeffs=(0.0, src.acq.samples_per_line - 1.0, 0.0, 0.0),
                       device="cpu")
    eng = StreamingEngine(model, src, extensions=ctx.extensions, stream_to_host=True)
    assert eng.run() == 3
    assert ext.count == 3
    assert ext.get_output()["scalars"]["buffers_seen"] == 3
    ctx.systems.deactivate()


def _fake_distributions(monkeypatch, entries):
    """Installed distributions advertising ``entries`` ((group, name,
    target) triples), as ``importlib.metadata`` reports them."""
    from importlib import metadata

    class Dist(metadata.Distribution):
        def __init__(self, group, name, target):
            self._group, self._name, self._target = group, name, target

        def read_text(self, filename):
            if filename == "METADATA":
                return f"Metadata-Version: 2.1\nName: {self._name}\nVersion: 1.0\n"
            if filename == "entry_points.txt":
                return f"[{self._group}]\n{self._name} = {self._target}\n"
            return None

        def locate_file(self, path):
            return path

    class Finder:
        @staticmethod
        def find_distributions(context=None):
            return [Dist(*e) for e in entries]

    monkeypatch.setattr(sys, "meta_path", [*sys.meta_path, Finder()])


def test_entry_point_discovery(plugin_path, monkeypatch):
    """Distributions advertising the port's group load; one advertising the
    JAX package's group (whose plugins subclass that package's Extension
    and would import JAX) does not."""
    assert ENTRY_POINT_GROUP == "octproz_tpu_torch.plugins"
    _fake_distributions(monkeypatch, [
        ("octproz_tpu_torch.plugins", "myplug", "myoct_torch_plugin:octproz_plugin"),
        ("octproz_tpu.plugins", "jaxplug", "module_that_does_not_exist:thing")])
    ctx = _ctx()
    assert discover_entry_point_plugins(ctx) == ["myplug"]
    assert "ramp" in ctx.systems.names and "buffer_counter" in ctx.extensions.extensions
    ctx = _ctx()
    load_plugins([], ctx)  # entry points on by default
    assert ctx.systems.names == ["ramp"]


def test_entry_point_failure_is_contained(plugin_path, monkeypatch, capsys):
    _fake_distributions(monkeypatch, [
        (ENTRY_POINT_GROUP, "badplug", "module_that_does_not_exist:thing"),
        (ENTRY_POINT_GROUP, "goodplug", "myoct_torch_plugin:octproz_plugin")])
    ctx = _ctx()
    assert discover_entry_point_plugins(ctx) == ["goodplug"]
    assert "ramp" in ctx.systems.names
    assert "failed to load and was skipped" in capsys.readouterr().err


@pytest.mark.parametrize("value", ["myoct_plugin, other.mod:factory",
                                   " a.b:c ; d ,, e:f ", ""])
def test_settings_file_plugins_group_matches_jax(tmp_path, value):
    ini = tmp_path / "s.ini"
    ini.write_text(textwrap.dedent(f"""\
        [plugins]
        load = {value}
        """))
    b = tconfigmap.from_settings(tsettings.SettingsManager(str(ini)))
    jb = jconfigmap.from_settings(jsettings.SettingsManager(str(ini)))
    assert b.plugins == jb.plugins
    assert all(s and s == s.strip() for s in b.plugins)
