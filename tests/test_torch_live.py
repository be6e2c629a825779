"""The port's live HTTP viewer (octproz_tpu_torch.viz.live) on the CPU: the
behaviours of tests/test_live.py, and the served frames and JSON held
against the JAX package's LiveView for the same ``update`` -- PNG pixels
(decoded with Pillow), the centre A-scan, the stats, the data cursor --
exactly.  The volume pane runs the port's raycaster on the device the
viewer was given (or its engine's model's), and a render that fails
raises instead of leaving the pane stale."""

import io
import json
import re
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import octproz_tpu.runtime as jruntime
import octproz_tpu.viz.live as jlive
from octproz_tpu_torch.runtime import ThroughputStats
from octproz_tpu_torch.viz import live as tlive
from octproz_tpu_torch.viz.image import png_size
from octproz_tpu_torch.viz.live import LiveView
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)


def _get(url):
    with urllib.request.urlopen(url, timeout=5) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def _post(url, obj):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(), method="POST")
    try:
        with urllib.request.urlopen(req, timeout=5) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _pixels(png: bytes) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(png)))


STATS = dict(ascans_per_s=1e6, buffers_per_s=10, bscans_per_s=100, volumes_per_s=1,
             mb_per_s=50, buffer_mb=5, buffers_processed=7)


@pytest.mark.parametrize("case", ["float", "float_lut_mip", "uint8", "uint16_lut"])
def test_served_frames_match_jax_viewer(case):
    """The same update through both viewers: the same B-scan and en-face
    pixels, A-scan, stats and data-cursor values."""
    rng = np.random.default_rng(11)
    kw = dict(throttle_s=0.0, bscan_nr=1, enface_depth=5, display_frames=2)
    if case == "float":
        vol = rng.normal(0.4, 0.4, (4, 8, 16)).astype(np.float32)
    elif case == "float_lut_mip":
        vol = rng.normal(0.4, 0.4, (4, 8, 16)).astype(np.float32)
        kw.update(lut="fire", mip=True, display_frames=3)
    elif case == "uint8":
        vol = rng.integers(0, 256, (3, 6, 10)).astype(np.uint8)
    else:
        vol = rng.integers(0, 65536, (3, 6, 10)).astype(np.uint16)
        kw.update(lut="ice")
    port, ref = LiveView(port=0, device="cpu", **kw), jlive.LiveView(port=0, **kw)
    try:
        for view, stats in ((port, ThroughputStats(**STATS)),
                            (ref, jruntime.ThroughputStats(**STATS))):
            view.update(vol, 0)
            view.update_stats(stats)
        for name in ("bscan.png", "enface.png"):
            st, ctype, got = _get(port.url + name)
            assert st == 200 and ctype == "image/png"
            np.testing.assert_array_equal(_pixels(got), _pixels(_get(ref.url + name)[2]))
        for name in ("ascan.json", "stats.json", "display.json",
                     "pixel?img=bscan&x=3&y=4", "pixel?img=enface&x=2&y=1",
                     "pixel?img=bscan&x=999&y=0"):
            assert json.loads(_get(port.url + name)[2]) == json.loads(_get(ref.url + name)[2])
    finally:
        port.close()
        ref.close()


def test_serves_page_and_frames():
    live = LiveView(port=0, throttle_s=0.0, device="cpu")
    try:
        vol = np.zeros((4, 8, 16), np.float32)
        vol[:, :, 5] = 1.0  # bright layer at depth 5
        live.update(vol, 0)
        live.update_stats(ThroughputStats(**STATS))
        status, ctype, body = _get(live.url)
        assert status == 200 and "text/html" in ctype
        assert b"octproz_tpu_torch live" in body
        status, ctype, body = _get(live.url + "bscan.png")
        assert status == 200 and ctype == "image/png" and png_size(body) == (8, 16)
        assert png_size(_get(live.url + "enface.png")[2]) == (8, 4)
        vals = json.loads(_get(live.url + "ascan.json")[2])["values"]
        assert len(vals) == 16 and vals[5] == 1.0
        stats = json.loads(_get(live.url + "stats.json")[2])
        assert stats["ascans_per_s"] == 1e6 and "volumes/s" in stats["info"]
        for missing in ("camera.png", "extension.json?name=x", "nope"):
            with pytest.raises(urllib.error.HTTPError):
                _get(live.url + missing)
    finally:
        live.close()


def test_page_is_the_jax_page_but_for_its_title():
    assert tlive._PAGE.replace("octproz_tpu_torch live", "octproz_tpu live") == jlive._PAGE


def test_page_script_structure():
    """No JS engine here, so pin the page's structural invariants: balanced
    delimiters in the script and every getElementById target present."""
    script = tlive._PAGE.split("<script>")[1].split("</script>")[0]
    html = tlive._PAGE.split("<script>")[0]
    for o, c in (("{", "}"), ("(", ")"), ("[", "]")):
        assert script.count(o) == script.count(c), f"unbalanced {o}{c}"
    ids = set(re.findall(r"id=\"([\w-]+)\"", html))
    wanted = set(re.findall(r"getElementById\('([\w-]+)'\)", script))
    assert not {w for w in wanted if w not in ids}
    assert {"bscanBar", "enfaceBar"} <= ids
    for endpoint in ("/bscan.png", "/enface.png", "/volume.png", "/camera.png", "/ascan.json",
                     "/stats.json", "/params.json", "/render.json", "/extension.json",
                     "/control", "/render", "/display", "/pixel"):
        assert endpoint in script, endpoint


def test_throttle_drops_intermediate_frames():
    live = LiveView(port=0, throttle_s=10.0, device="cpu")
    try:
        for _ in range(5):
            live.update(np.zeros((2, 4, 8), np.float32), 0)
        assert live.frames_rendered == 1  # 80 ms-style redraw throttle
    finally:
        live.close()


def test_attach_chains_engine_callbacks():
    class FakeEngine:
        on_processed = None
        on_metrics = None

    calls = []
    eng = FakeEngine()
    eng.on_processed = lambda v, n: calls.append(("prev", n))
    live = LiveView(port=0, throttle_s=0.0, device="cpu")
    try:
        live.attach(eng)
        eng.on_processed(np.zeros((1, 2, 4), np.float32), 3)
        assert calls == [("prev", 3)] and live.frames_rendered == 1
        eng.on_metrics(ThroughputStats(buffers_processed=1))
        assert json.loads(_get(live.url + "stats.json")[2])["buffers_processed"] == 1
    finally:
        live.close()


class _Assembler:
    volume = np.zeros((6, 6, 12), np.float32)
    volume[1:3, 1:3, 2:5] = 0.9  # an off-center bright blob


def test_volume_raycast_runs_on_the_viewers_device(monkeypatch):
    """The raycast goes to render_volume with the viewer's device and its
    own stream (None on the CPU); attach() moves it to the model's."""
    from octproz_tpu_torch.viz import render as render_mod

    seen = []
    real = render_mod.render_volume

    def spy(volume, *a, **kw):
        seen.append((kw.get("device"), kw.get("stream")))
        return real(volume, *a, **kw)

    monkeypatch.setattr(render_mod, "render_volume", spy)
    live = LiveView(port=0, throttle_s=0.0, volume_render=True, volume_size=16, device="cpu")
    try:
        live._assembler = _Assembler()
        png = live._render_assembled_volume()
        assert png_size(png) == (16, 16)
        assert [(str(d), s) for d, s in seen] == [("cpu", None)]

        class Model:
            device = torch.device("cpu")

        class Engine:
            model, assembler, on_processed, on_metrics = Model(), _Assembler(), None, None

            def on_info(self, msg):
                pass

        live.attach(Engine())
        assert live.device == Model.device
    finally:
        live.close()


def test_volume_render_failure_raises(monkeypatch):
    """No fallback hides the device: a failing raycast raises on the thread
    that asked for it (the JAX viewer swallowed it and kept a stale pane)."""
    from octproz_tpu_torch.viz import render as render_mod

    def broken(*a, **kw):
        raise RuntimeError("device lost")

    monkeypatch.setattr(render_mod, "render_volume", broken)
    live = LiveView(port=0, throttle_s=0.0, volume_render=True, volume_throttle_s=0.0,
                    volume_size=8, device="cpu")
    try:
        live._assembler = _Assembler()
        with pytest.raises(RuntimeError, match="device lost"):
            live.update(np.zeros((2, 4, 8), np.float32), 0)
        assert not live._render_lock.locked()  # released for the next try
    finally:
        live.close()


def test_volume_pane_matches_jax_viewer():
    """The pane's image after the same state changes, within the
    raycaster's bound (tests/test_torch_viz.py): MIP is held on every
    pixel."""
    port = LiveView(port=0, throttle_s=0.0, volume_render=True, volume_size=24, device="cpu")
    ref = jlive.LiveView(port=0, throttle_s=0.0, volume_render=True, volume_size=24)
    try:
        for view in (port, ref):
            view._assembler = _Assembler()
            assert _post(view.url + "render", {"mode": "mip", "yaw": 2.2, "pitch": -0.8,
                                               "lut": "fire"})[0] == 200
        got = _pixels(_get(port.url + "volume.png")[2]).astype(int)
        want = _pixels(_get(ref.url + "volume.png")[2]).astype(int)
        assert np.abs(got - want).max() <= 1  # 5e-5 before rounding to uint8
        st_port = json.loads(_get(port.url + "render.json")[2])
        st_ref = json.loads(_get(ref.url + "render.json")[2])
        assert st_port == st_ref
    finally:
        port.close()
        ref.close()


def test_interactive_render_control():
    """POST /render drives the live raycast: all 7 modes reachable with
    viewpoint/threshold/gamma/step/lut control; each accepted POST
    re-renders at once and the pane differs across viewpoints."""
    live = LiveView(port=0, throttle_s=0.0, volume_render=True, volume_size=24, device="cpu")
    try:
        live._assembler = _Assembler()
        st0 = json.loads(_get(live.url + "render.json")[2])
        assert len(st0["modes"]) == 7 and st0["mode"] == "mip"
        pngs = {}
        for mode in st0["modes"]:
            st, r = _post(live.url + "render", {"mode": mode})
            assert st == 200 and r["reply"]["mode"] == mode
            pngs[mode] = _get(live.url + "volume.png")[2]
            assert png_size(pngs[mode]) == (24, 24)
        st, r = _post(live.url + "render", {"mode": "mip", "yaw": 2.2, "pitch": -0.8})
        assert st == 200 and abs(r["reply"]["yaw"] - 2.2) < 1e-9
        assert _get(live.url + "volume.png")[2] != pngs["mip"]
        st, r = _post(live.url + "render", {"threshold": 0.4, "gamma": 1.5,
                                            "step_length": 1e-6, "lut": "fire"})
        assert st == 200 and r["reply"]["threshold"] == 0.4
        assert r["reply"]["step_length"] >= 0.004 and r["reply"]["lut"] == "fire"
        assert _post(live.url + "render", {"mode": "nope"})[0] == 400
        assert _post(live.url + "render", {"lut": "nope"})[0] == 400
    finally:
        live.close()


def _engine_with_live(**live_kw):
    """Real StreamingEngine + attached LiveView (not run; the controller
    mutates it directly like a live session would)."""
    from octproz_tpu_torch.extensions.peaks import PeakDetectorExtension
    from octproz_tpu_torch.extensions.statistics import ImageStatisticsExtension
    from octproz_tpu_torch.io.source import SyntheticSource
    from octproz_tpu_torch.models.fdoct import FdOctModel
    from octproz_tpu_torch.params import AcqParams, FpnMode, Interpolation, ProcConfig
    from octproz_tpu_torch.plugins import ExtensionManager
    from octproz_tpu_torch.runtime import StreamingEngine

    acq = AcqParams(samples_per_line=64, ascans_per_bscan=8, bscans_per_buffer=2,
                    buffers_per_volume=1, bit_depth=12)
    cfg = ProcConfig(resampling=True, interpolation=Interpolation.LINEAR,
                     windowing=True, fpn_mode=FpnMode.OFF, log_scaling=True)
    model = FdOctModel(acq, cfg, resample_coeffs=(0.0, 63.0, 0.0, 0.0), device="cpu")
    exts = ExtensionManager()
    exts.add(ImageStatisticsExtension())
    exts.add(PeakDetectorExtension())
    eng = StreamingEngine(model, SyntheticSource(acq, n_buffers=2), extensions=exts,
                          stream_to_host=True)
    live = LiveView(port=0, throttle_s=0.0, **live_kw)
    live.attach(eng)
    return eng, live


def test_control_panel_sidebar_parity_round_trips(tmp_path):
    """Every sidebar-parity control reachable from the page round-trips
    through POST /control: window, interpolation, FPN mode, streaming skip,
    recording start/status, extension toggles."""
    eng, live = _engine_with_live()
    try:
        url = live.url + "control"
        st, r = _post(url, {"command": "set_window", "type": "gauss", "center": 0.4,
                            "fill_factor": 0.8})
        assert st == 200 and r["reply"] == "ok"
        st, r = _post(url, {"command": "set_interpolation", "type": "cubic"})
        assert st == 200 and eng.model.cfg.interpolation.value == "cubic"
        st, r = _post(url, {"command": "set_fpn_mode", "mode": "continuous"})
        assert st == 200 and eng.model.cfg.fpn_mode.value == "continuous"
        st, r = _post(url, {"command": "set_streaming", "skip": 3, "enabled": True})
        assert st == 200 and eng.streaming_skip == 3 and eng.stream_to_host
        p = json.loads(_get(live.url + "params.json")[2])
        assert (p["window_type"], p["interpolation"], p["streaming_skip"]) == ("gauss", "cubic", 3)
        st, r = _post(url, {"command": "start_recording", "name": "t", "dir": str(tmp_path),
                            "buffers": 1, "processed": True, "meta": False})
        assert st == 200 and eng.recording
        st, r = _post(url, {"command": "recording_status"})
        assert r["reply"]["recording"] and r["reply"]["processed"]
        st, r = _post(url, {"command": "start_recording"})
        assert st == 400 and "in progress" in r["error"]
        assert _post(url, {"command": "activate_extension", "name": "image-statistics"})[0] == 200
        assert _post(url, {"command": "list_extensions"})[1]["reply"]["image-statistics"] is True
        assert json.loads(_get(live.url + "stats.json")[2])["recording"] is True
    finally:
        live.close()


def test_extension_output_pane():
    """Active extensions' latest results at /extension.json in the generic
    get_output() shapes."""
    eng, live = _engine_with_live()
    try:
        for name in ("image-statistics", "peak-detector"):
            eng.extensions.extensions[name].activate()
        eng.run()
        out = json.loads(_get(live.url + "extension.json?name=image-statistics")[2])
        assert out["active"] and len(out["series"]["histogram"]) == 64
        assert out["scalars"]["maximum"] >= out["scalars"]["minimum"]
        out = json.loads(_get(live.url + "extension.json?name=peak-detector")[2])
        assert isinstance(out.get("table"), list)
        assert out["scalars"]["n_peaks"] == len(out["table"])
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(live.url + "extension.json?name=nope")
        assert e.value.code == 404
    finally:
        live.close()


def test_third_party_extension_pane_and_failures():
    """A new extension's get_output gets a pane with no viewer edits; one
    that raises or returns a non-dict yields an error field; its own
    reserved keys come back as ext_*; numpy values serialize."""
    from octproz_tpu_torch.plugins import Extension

    class Fresh(Extension):
        name = "fresh"
        wants_processed_data = True

        def __init__(self):
            super().__init__()
            self.n = 0

        def processed_data_received(self, *a):
            self.n += 1

        def get_output(self):
            return {"scalars": {"frames": self.n, "mean": np.float32(3.25),
                                "ok": np.bool_(True)},
                    "series": {"ramp": np.linspace(0, 1, 3)},
                    "table": [{"k": "a", "v": 1}], "error": "fit diverged", "active": False}

    class Broken(Extension):
        name = "broken"

        def get_output(self):
            raise RuntimeError("boom")

    class Listy(Extension):
        name = "listy"

        def get_output(self):
            return [1, 2, 3]

    eng, live = _engine_with_live()
    try:
        for ext in (Fresh(), Broken(), Listy()):
            eng.extensions.add(ext)
            ext.activate()
        eng.run()
        out = json.loads(_get(live.url + "extension.json?name=fresh")[2])
        assert out["scalars"] == {"frames": 2, "mean": 3.25, "ok": True}
        assert out["series"]["ramp"] == [0.0, 0.5, 1.0] and out["table"] == [{"k": "a", "v": 1}]
        assert out["active"] is True and "error" not in out
        assert out["ext_error"] == "fit diverged" and out["ext_active"] is False
        assert "boom" in json.loads(_get(live.url + "extension.json?name=broken")[2])["error"]
        assert "must return a dict" in json.loads(
            _get(live.url + "extension.json?name=listy")[2])["error"]
    finally:
        live.close()


def test_display_manipulation_and_data_cursor():
    """POST /display (frame selection, avg/MIP, physical scale) and the
    /pixel data-cursor endpoint."""
    live = LiveView(port=0, throttle_s=0.0, device="cpu")
    try:
        st, r = _post(live.url + "display", {"bscan_nr": 1, "frames": 2, "mip": True,
                                             "depth_mm": 2.5, "width_mm": 10.0})
        assert st == 200 and r["reply"] == {"bscan_nr": 1, "enface_depth": 0, "frames": 2,
                                            "mip": True, "depth_mm": 2.5, "width_mm": 10.0}
        vol = np.zeros((4, 8, 16), np.float32)
        vol[1, 3, 5] = 0.75
        vol[2, :, :] = 0.5
        live.update(vol, 0)
        assert json.loads(_get(live.url + "pixel?img=bscan&x=3&y=10")[2])["value"] == 0.75
        assert json.loads(_get(live.url + "pixel?img=bscan&x=0&y=0")[2])["value"] == 0.5
        assert json.loads(_get(live.url + "pixel?img=bscan&x=999&y=0")[2])["value"] is None
    finally:
        live.close()


def test_camera_pane():
    """attach_camera serves the extension's frames at /camera.png, encoded
    without Pillow; the stats report the pane."""
    from octproz_tpu_torch.extensions.camera import CallableCamera, CameraExtension
    from octproz_tpu_torch.viz.image import decode_png

    frame = np.random.default_rng(12).integers(0, 256, (9, 13, 3)).astype(np.uint8)
    live = LiveView(port=0, throttle_s=0.0, device="cpu")
    try:
        cam = CameraExtension(CallableCamera(lambda: frame))
        live.attach_camera(cam)
        st, ctype, body = _get(live.url + "camera.png")
        assert st == 200 and ctype == "image/png"
        np.testing.assert_array_equal(decode_png(body), frame)
        assert json.loads(_get(live.url + "stats.json")[2])["camera"] is True
        assert cam.frames_served == 1
    finally:
        live.close()
