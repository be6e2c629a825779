"""The port's live re-tuning surface (octproz_tpu_torch.control) on the CPU:
the behaviours of tests/test_control.py, and every controller command on
the port's model and on the JAX package's, the same raw buffer through both
afterwards.

Outputs after a retune are held to the bounds of the scaled image
(tests/test_torch_pipeline.py): equal finite masks, |port - jax| <= 1e-4
where the JAX value is at or above the display floor (>= 0).  A retune
during a stream is held exactly: each streamed buffer equals, bit for bit,
a fresh model's output on the old or on the new parameters -- never a mix.
"""

import json
import socket
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import octproz_tpu.control as jcontrol
import octproz_tpu.io.source as jsource
import octproz_tpu.models.fdoct as jfdoct
import octproz_tpu.params as jparams
import octproz_tpu.runtime as jruntime
from octproz_tpu_torch.control import ParamController
from octproz_tpu_torch.io.recorder import RecordingParams
from octproz_tpu_torch.io.source import SyntheticSource
from octproz_tpu_torch.models.fdoct import FdOctModel
from octproz_tpu_torch.params import AcqParams, FpnMode, Interpolation, ProcConfig, WindowType
from octproz_tpu_torch.runtime import StreamingEngine

ACQ = AcqParams(samples_per_line=64, ascans_per_bscan=16, bscans_per_buffer=4,
                buffers_per_volume=2, bit_depth=12)
CFG = ProcConfig(resampling=True, interpolation=Interpolation.LINEAR,
                 windowing=True, dispersion=True, fpn_mode=FpnMode.OFF,
                 log_scaling=True)
KW = dict(resample_coeffs=(0.0, ACQ.samples_per_line - 1.0, 0.0, 0.0),
          dispersion_coeffs=(0.0, 0.0, 4.0, 0.0))
SCALE_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's small CPU work: under xdist the
    default (a thread per core in every worker) oversubscribes the cores,
    which slows these tests many times over and starves the other workers'."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_model(cfg=CFG):
    return FdOctModel(ACQ, cfg, **KW, device="cpu")


def make_jax_model():
    acq = jparams.AcqParams(**{k: getattr(ACQ, k) for k in (
        "samples_per_line", "ascans_per_bscan", "bscans_per_buffer",
        "buffers_per_volume", "bit_depth")})
    cfg = jparams.ProcConfig(resampling=True, interpolation=jparams.Interpolation.LINEAR,
                             windowing=True, dispersion=True,
                             fpn_mode=jparams.FpnMode.OFF, log_scaling=True)
    return jfdoct.FdOctModel(acq, cfg, **KW)


def _raw(seed=0):
    return np.random.default_rng(seed).integers(
        0, 4095, size=ACQ.buffer_shape).astype(np.uint16)


def _close(got, want):
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert g.shape == w.shape
    np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
    shown = np.isfinite(w) & (w >= 0)
    assert shown.mean() > 0.5
    assert np.abs(g[shown] - w[shown]).max() <= SCALE_ATOL


def _post(url, obj):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(), method="POST")
    try:
        with urllib.request.urlopen(req, timeout=5) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


COMMANDS = {
    "set_klin_coeffs": {"coeffs": [0, 63, 5, -2]},
    "set_dispersion_coeffs": {"d0": 0, "d1": 0, "d2": 40.0, "d3": 0},
    "set_window": {"type": "gauss", "center": 0.4, "fill_factor": 0.9},
    "set_custom_resample_curve": {"values": np.linspace(0, 61, 64).tolist()},
    "set_grayscale": {"min": 0, "max": 30},
    "set_post_background": {"values": np.linspace(0, 0.2, 32).tolist()},
    "set_interpolation": {"type": "cubic"},
    "set_fpn_mode": {"mode": "continuous"},
    "redetermine_fpn": {},
}


@pytest.mark.parametrize("command", list(COMMANDS))
def test_command_on_both_models_then_same_output(command):
    """Each model command through both controllers: the same reply, the
    same described state, and the same raw buffer then gives the same
    image within the scale bound."""
    tm, jm = make_model(), make_jax_model()
    tctl, jctl = ParamController(tm), jcontrol.ParamController(jm)
    raw = _raw()
    before = tm.fetch(tm.process_buffer(raw))
    jm.process_buffer(raw)
    params = COMMANDS[command]
    reply = tctl.handle(command, dict(params))
    assert reply == jctl.handle(command, dict(params)) == {"reply": "ok"}
    assert tctl.describe() == jctl.describe()
    after = tm.fetch(tm.process_buffer(raw))
    _close(after, np.asarray(jm.process_buffer(raw)))
    # (the identity k-lin curve samples whole indices: any interpolation
    # gives the same output there)
    if command in ("set_klin_coeffs", "set_dispersion_coeffs", "set_window",
                   "set_custom_resample_curve", "set_grayscale"):
        assert not np.array_equal(after, before)  # the output actually re-tuned


def test_dispersion_change_keeps_the_step_and_builds_new_curves():
    """A curve change publishes new curves under the same step function (the
    JAX package's recompile-free re-tune); a config change a new step."""
    model = make_model()
    ctl = ParamController(model)
    step, curves = model._step, model.curves
    assert ctl.handle("set_dispersion_coeffs", {"d2": 40.0}) == {"reply": "ok"}
    assert model._step is step and model.curves is not curves
    assert model._exec == (model.cfg, model.curves, model._step)
    assert model._curve_kwargs["dispersion_coeffs"] == (0.0, 0.0, 40.0, 0.0)
    assert ctl.handle("set_grayscale", {"min": 0, "max": 30}) == {"reply": "ok"}
    assert model._step is not step and model.cfg.grayscale_max == 30.0
    assert model._exec == (model.cfg, model.curves, model._step)


def test_klin_window_and_custom_curve_commands():
    model = make_model()
    ctl = ParamController(model)
    assert ctl.handle("set_klin_coeffs", {"coeffs": [0, 63, 5, -2]}) == {"reply": "ok"}
    assert model._curve_kwargs["resample_coeffs"] == (0.0, 63.0, 5.0, -2.0)
    assert ctl.handle("set_window", {"type": "gauss", "center": 0.4,
                                     "fill_factor": 0.9}) == {"reply": "ok"}
    assert model._curve_kwargs["window_type"] == WindowType.GAUSS
    curve = np.linspace(0, ACQ.samples_per_line - 3, ACQ.samples_per_line)
    assert ctl.handle("set_custom_resample_curve", {"values": curve.tolist()}) == {"reply": "ok"}


@pytest.mark.parametrize("command, params", [
    ("warp_speed", {}), ("set_klin_coeffs", {"coeffs": [1, 2]}),
    ("set_window", {"type": "nope"}), ("set_post_background", {}),
    ("record_post_background", {"n": 1}), ("set_streaming", {"skip": 1}),
    ("start_recording", {}), ("recording_status", {}), ("stop", {}),
    ("list_extensions", {}), ("activate_extension", {"name": "x"})])
def test_unknown_invalid_and_engine_commands_without_an_engine(command, params):
    """The same error replies as the JAX package's controller."""
    got = ParamController(make_model()).handle(command, dict(params))
    want = jcontrol.ParamController(make_jax_model()).handle(command, dict(params))
    assert "error" in got
    assert got.keys() == want.keys() and got.get("commands") == want.get("commands")
    if command != "set_window":  # the enum's own message names its module
        assert got == want


def _engines(n_buffers=4, **kw):
    teng = StreamingEngine(make_model(), SyntheticSource(ACQ, n_buffers=n_buffers),
                           stream_to_host=True, **kw)
    jeng = jruntime.StreamingEngine(make_jax_model(), jsource.SyntheticSource(
        make_jax_model().acq, n_buffers=n_buffers), stream_to_host=True, **kw)
    return teng, jeng


def test_engine_commands_on_both_engines(tmp_path):
    """Streaming, recording, background capture, extension and stop
    commands give the same replies and the same engine state on both."""
    from octproz_tpu.plugins import Extension as JExtension
    from octproz_tpu_torch.plugins import Extension

    class Dummy(Extension):
        name = "dummy"

    class JDummy(JExtension):
        name = "dummy"

    teng, jeng = _engines()
    teng.extensions.add(Dummy())
    jeng.extensions.add(JDummy())
    tctl, jctl = ParamController(teng.model, teng), jcontrol.ParamController(jeng.model, jeng)
    steps = [("set_streaming", {"skip": 2, "enabled": True}),
             ("set_streaming", {"skip": -1}),
             ("list_extensions", {}), ("activate_extension", {"name": "dummy"}),
             ("list_extensions", {}), ("deactivate_extension", {"name": "dummy"}),
             ("activate_extension", {"name": "nope"}),
             ("record_post_background", {"n": 1}),
             ("recording_status", {}),
             ("get_params", {}), ("stop", {})]
    for command, params in steps:
        assert tctl.handle(command, dict(params)) == jctl.handle(command, dict(params)), command
    assert teng.streaming_skip == jeng.streaming_skip == 2
    for ctl, eng, sub in ((tctl, teng, "t"), (jctl, jeng, "j")):
        d = tmp_path / sub
        reply = ctl.handle("start_recording", {"dir": str(d), "name": "r", "buffers": 1,
                                               "meta": False})
        assert reply == {"reply": "ok"} and eng.recording
        assert "in progress" in ctl.handle("start_recording", {})["error"]
    assert tctl.handle("recording_status", {}) == jctl.handle("recording_status", {})


def test_get_params_describes_state():
    d = ParamController(make_model()).handle("get_params", {})["reply"]
    assert d == jcontrol.ParamController(make_jax_model()).handle("get_params", {})["reply"]
    assert d["dispersion_coeffs"] == [0.0, 0.0, 4.0, 0.0]
    assert d["window_type"] == "hanning" and d["fpn_mode"] == "off"


class _GatedSource:
    """The same raw buffers each time: ``before`` of them, then a wait for
    ``gate`` (a retune lands meanwhile), then ``after`` more."""

    def __init__(self, frames, before, after, gate):
        self.acq = ACQ
        self._frames, self._before, self._after, self._gate = frames, before, after, gate

    def buffers(self):
        for i in range(self._before + self._after):
            if i == self._before:
                assert self._gate.wait(30)
            yield self._frames[i % len(self._frames)]


def test_retune_mid_stream_lands_on_a_buffer_boundary(tmp_path):
    """POST /control changes the dispersion while the engine streams: the
    float32 recording holds buffers equal, bit for bit, to a fresh model on
    the old coefficients, then buffers equal to one on the new, never a
    mix."""
    from octproz_tpu_torch.viz.live import LiveView

    frames = [_raw(s) for s in range(3)]
    gate = threading.Event()
    model = make_model()
    eng = StreamingEngine(model, _GatedSource(frames, 4, 5, gate), stream_to_host=True)
    live = LiveView(port=0, throttle_s=0.0, device="cpu")
    live.attach(eng)

    def retune():
        while eng.meter.total_buffers < 2:
            if not eng.running and eng.meter.total_buffers:
                break
            threading.Event().wait(0.01)
        status, reply = _post(live.url + "control",
                              {"command": "set_dispersion_coeffs", "d2": 25.0})
        assert status == 200 and reply == {"reply": "ok"}
        gate.set()

    eng.start_recording(RecordingParams(save_dir=str(tmp_path), name="retune",
                                        buffers_to_record=9, save_raw=False,
                                        save_processed=True, save_as_32bit_float=True,
                                        save_meta=False))
    t = threading.Thread(target=retune)
    t.start()
    try:
        assert eng.run() == 9
    finally:
        gate.set()
        t.join()
        live.close()
    got = np.fromfile(eng.processed_recorder.last_file, np.float32).reshape(
        9, *ACQ.processed_buffer_shape)
    old, new = make_model(), make_model()
    new.set_dispersion_coeffs(0.0, 0.0, 25.0, 0.0)
    kinds = []
    for i, g in enumerate(got):
        frame = frames[i % 3]
        is_old = np.array_equal(g, old.fetch(old.process_buffer(frame)))
        is_new = np.array_equal(g, new.fetch(new.process_buffer(frame)))
        assert is_old != is_new, f"buffer {i} is neither (or both)"
        kinds.append("new" if is_new else "old")
    assert kinds == sorted(kinds, key=lambda k: k == "new"), kinds  # old... then new...
    assert kinds.count("old") >= 2 and kinds.count("new") >= 5, kinds


def test_concurrent_commands_serialize():
    """Commands from several threads (the viewer serves each request on its
    own) leave one consistent snapshot: the last curves built belong to
    the coefficients the model reports."""
    model = make_model()
    ctl = ParamController(model)
    errors = []

    def hammer(d2):
        for _ in range(5):
            reply = ctl.handle("set_dispersion_coeffs", {"d2": d2})
            if reply != {"reply": "ok"}:
                errors.append(reply)

    threads = [threading.Thread(target=hammer, args=(float(d),)) for d in (5, 15, 25)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    fresh = make_model()
    fresh.set_dispersion_coeffs(*model._curve_kwargs["dispersion_coeffs"])
    raw = _raw()
    assert np.array_equal(model.fetch(model.process_buffer(raw)),
                          fresh.fetch(fresh.process_buffer(raw)))


def test_live_view_control_endpoint():
    """POST /control re-tunes the running model; /params.json reflects it."""
    from octproz_tpu_torch.viz.live import LiveView

    model = make_model()
    eng = StreamingEngine(model, SyntheticSource(ACQ, n_buffers=4), stream_to_host=True)
    live = LiveView(port=0, throttle_s=0.0)
    live.attach(eng)  # auto-creates the ParamController; the model's device
    try:
        assert str(live.device) == "cpu"
        status, reply = _post(live.url + "control",
                              {"command": "set_dispersion_coeffs", "d2": 25.0})
        assert status == 200 and reply == {"reply": "ok"}
        assert model._curve_kwargs["dispersion_coeffs"] == (0.0, 0.0, 25.0, 0.0)
        with urllib.request.urlopen(live.url + "params.json", timeout=5) as r:
            params = json.loads(r.read())
        assert params["dispersion_coeffs"] == [0.0, 0.0, 25.0, 0.0]
        status, reply = _post(live.url + "control", {"command": "nope"})
        assert status == 400 and "error" in reply
        status, reply = _post(live.url + "control", "redetermine_fpn")
        assert status == 400 and "error" in reply  # not a json object
        assert eng.run() == 4  # stream still healthy after re-tuning
    finally:
        live.close()


def test_socketstream_routes_to_controller():
    """{"command": ..., "target": "processing"} over TCP reaches the model
    (plugin request signals analog, plugin.h:82-84)."""
    from octproz_tpu_torch.extensions.socketstream import SocketStreamServer
    from octproz_tpu_torch.plugins import MessageBus

    model = make_model()
    bus = MessageBus()
    bus.register(ParamController(model))
    srv = SocketStreamServer(port=0, bus=bus)
    srv.start()
    try:
        with socket.create_connection((srv.host, srv.port), timeout=5) as s:
            f = s.makefile("rwb")
            f.write((json.dumps({"command": "set_klin_coeffs", "target": "processing",
                                 "coeffs": [0, 63, 9, -3]}) + "\n").encode())
            f.flush()
            reply = json.loads(f.readline())
        assert reply == {"reply": "ok"}
        assert model._curve_kwargs["resample_coeffs"] == (0.0, 63.0, 9.0, -3.0)
    finally:
        srv.stop()


def test_live_volume_render_of_assembled_stream():
    """volume_render=True: the assembled multi-buffer volume is raycast into
    /volume.png periodically (updateDisplayedVolume analog), on the model's
    device."""
    from octproz_tpu_torch.viz.image import png_size
    from octproz_tpu_torch.viz.live import LiveView

    model = make_model()
    eng = StreamingEngine(model, SyntheticSource(ACQ, n_buffers=6), stream_to_host=True)
    live = LiveView(port=0, throttle_s=0.0, volume_render=True, volume_throttle_s=0.0,
                    volume_size=32)
    live.attach(eng)
    try:
        assert eng.assembler is not None  # attach grew one
        assert eng.run() == 6
        assert live.volume_renders >= 1 and live.last_render_ms > 0
        with urllib.request.urlopen(live.url + "volume.png", timeout=5) as r:
            assert png_size(r.read()) == (32, 32)
        with urllib.request.urlopen(live.url + "stats.json", timeout=5) as r:
            assert json.loads(r.read()).get("volume_renders", 0) >= 1
    finally:
        live.close()
