"""The port's command line (octproz_tpu_torch.cli) on the CPU: the behaviours
of tests/test_cli.py, with ``process``, ``render``, ``settings`` and
``replay`` run through both CLIs on the same small raw file.

Processed volumes are held to the bounds of the scaled image
(tests/test_torch_pipeline.py): equal finite masks, |port - jax| <= 1e-4
where the JAX value is at or above the display floor.  PNGs written from
such volumes may round a pixel the other way (at most one uint8 code); the
port's PNGs equal its own projections of its own volume exactly.  Rendered
PNGs are held to one code on all but the raycaster's flip share
(tests/test_torch_viz.py)."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import octproz_tpu.cli as jcli
from octproz_tpu_torch.cli import main
from octproz_tpu_torch.ops.projections import bscan_frame, enface_frame
from octproz_tpu_torch.viz.image import apply_lut, builtin_lut, decode_png, to_uint8
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

SCALE_ATOL = 1e-4
CPU = ["--device", "cpu"]


def _close(got, want):
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert g.shape == w.shape
    np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
    shown = np.isfinite(w) & (w >= 0)
    assert shown.mean() > 0.5
    assert np.abs(g[shown] - w[shown]).max() <= SCALE_ATOL


def _png(path):
    """Pixels of a PNG from either CLI (Pillow filters the JAX CLI's rows,
    which the port's decoder does not read)."""
    from PIL import Image

    return np.asarray(Image.open(path)).astype(int)


def _own_png(path):
    with open(path, "rb") as f:
        return decode_png(f.read())


@pytest.fixture(scope="module")
def raw_file(tmp_path_factory):
    """Two small buffers of 12-bit fringes with a reflector at depth 20."""
    d = tmp_path_factory.mktemp("cli")
    n, asc, bsc = 128, 8, 4
    k = np.arange(n)
    spec = 1000.0 + 400.0 * np.cos(2 * np.pi * 20 * k / n)
    noise = np.random.default_rng(3).normal(0, 20, (2, bsc, asc, n))
    vol = (np.tile(spec, (2, bsc, asc, 1)) + noise).astype(np.uint16)
    path = d / "in.raw"
    vol.tofile(path)
    return str(path), n, asc, bsc


def _geom(n, asc, bsc):
    return ["--samples", str(n), "--ascans", str(asc), "--bscans", str(bsc),
            "--buffers-per-volume", "2", "--bit-depth", "12"]


@pytest.mark.parametrize("flags", [
    ["--fpn", "off"],
    ["--fpn", "once", "--fpn-bscans", "2", "--klin-coeffs", "0", "127", "6", "-3",
     "--disp-coeffs", "0", "0", "5", "0"],
    ["--fpn", "off", "--fft-matmul"],
    ["--preset", "benchmark", "--fpn", "off", "--lin-scaling", "--window-type", "gauss"],
])
def test_process_matches_jax_cli(raw_file, tmp_path, flags):
    """The same command line through both CLIs: the float32 output within
    the scale bound, the B-scan and en-face PNGs within one code, and the
    port's PNGs equal to its projections of its own output."""
    path, n, asc, bsc = raw_file
    outs = {}
    for tag, run, pre in (("t", main, CPU), ("j", jcli.main, [])):
        out = [str(tmp_path / f"{tag}{x}") for x in (".raw", "_b.png", "_e.png")]
        assert run([*pre, "process", path, *_geom(n, asc, bsc), *flags, "--output", out[0],
                    "--bscan-png", out[1], "--frame", "5", "--enface-png", out[2],
                    "--depth", "20", "--lut", "fire"]) == 0
        outs[tag] = out
    vol = np.fromfile(outs["t"][0], np.float32).reshape(2 * bsc, asc, n // 2)
    _close(vol, np.fromfile(outs["j"][0], np.float32).reshape(vol.shape))
    for got, want in zip(outs["t"][1:], outs["j"][1:]):
        assert np.abs(_png(got) - _png(want)).max() <= 1
    lut = builtin_lut("fire")
    t = torch.from_numpy(vol)
    bscan = np.clip(bscan_frame(t, 5).numpy().T, 0, 1)
    enface = np.clip(enface_frame(t, 20).numpy(), 0, 1)
    np.testing.assert_array_equal(_own_png(outs["t"][1]), to_uint8(apply_lut(bscan, lut)))
    np.testing.assert_array_equal(_own_png(outs["t"][2]), to_uint8(apply_lut(enface, lut)))
    ascan = vol[0, 4]
    if "--lin-scaling" not in flags:
        assert ascan[18:23].max() > np.median(ascan)  # reflector at depth 20


def test_process_fused_matches_unfused(raw_file, tmp_path):
    path, n, asc, bsc = raw_file
    a, b = tmp_path / "a.raw", tmp_path / "b.raw"
    assert main([*CPU, "process", path, *_geom(n, asc, bsc), "--fpn", "off",
                 "--output", str(a)]) == 0
    assert main([*CPU, "process", path, *_geom(n, asc, bsc), "--fpn", "off",
                 "--fused-prep", "--output", str(b)]) == 0
    np.testing.assert_allclose(np.fromfile(a, np.float32), np.fromfile(b, np.float32),
                               atol=5e-2)


def test_process_precision_and_backend_flags(raw_file, tmp_path):
    """--matmul-precision / --compute-dtype / --output-dtype / --fold-backend
    / --fold-ksplit / --pallas-tile reach the pipeline: the fidelity ladder
    stays close to the default output, the accepted-and-unused knobs leave
    it unchanged, bf16 compute and store run (their error is the bf16
    rung's, tests/test_torch_bf16.py)."""
    path, n, asc, bsc = raw_file
    base = [*CPU, "process", path, *_geom(n, asc, bsc), "--fpn", "off", "--fft-matmul"]
    files = {}
    for tag, extra in (("default", []), ("highest", ["--matmul-precision", "highest"]),
                       ("xla", ["--fold-backend", "xla"]),
                       ("knobs", ["--fold-ksplit", "2", "--pallas-tile", "64"]),
                       ("bf16", ["--compute-dtype", "bfloat16", "--output-dtype", "bfloat16"])):
        files[tag] = tmp_path / f"{tag}.raw"
        assert main([*base, *extra, "--output", str(files[tag])]) == 0
    ref = np.fromfile(files["default"], np.float32)
    for tag in ("highest", "xla"):
        np.testing.assert_allclose(np.fromfile(files[tag], np.float32), ref, atol=5e-2)
    np.testing.assert_array_equal(np.fromfile(files["knobs"], np.float32), ref)
    bf16 = np.fromfile(files["bf16"], np.float32)
    assert bf16.shape == ref.shape and np.isfinite(bf16).all()


def test_replay_reports_json_like_jax(raw_file, capsys):
    path, n, asc, bsc = raw_file
    reports = []
    for run, pre in ((main, CPU), (jcli.main, [])):
        assert run([*pre, "replay", path, *_geom(n, asc, bsc), "--fpn", "off",
                    "--max-buffers", "4"]) == 0
        reports.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    assert reports[0].keys() == reports[1].keys()
    assert reports[0]["buffers_processed"] == reports[1]["buffers_processed"] == 4
    assert reports[0]["ascans_per_s"] > 0


def test_replay_live_serves_the_viewer(raw_file, monkeypatch, capsys):
    """replay --live --live-volume: the viewer is attached for the run (its
    frames and the volume pane read just before it closes) and the stream
    reaches it."""
    import urllib.request

    from octproz_tpu_torch.viz import live as live_mod
    from octproz_tpu_torch.viz.image import png_size

    path, n, asc, bsc = raw_file
    seen = {}
    real_close = live_mod.LiveView.close

    def close(view):
        for name in ("bscan.png", "volume.png", "stats.json", "params.json"):
            with urllib.request.urlopen(view.url + name, timeout=5) as r:
                seen[name] = r.read()
        seen["device"] = str(view.device)
        real_close(view)

    monkeypatch.setattr(live_mod.LiveView, "close", close)
    assert main([*CPU, "replay", path, *_geom(n, asc, bsc), "--fpn", "off",
                 "--max-buffers", "4", "--live", "--live-port", "0", "--live-volume"]) == 0
    out = capsys.readouterr().out
    assert "live view: http://127.0.0.1:" in out
    assert json.loads(out.strip().splitlines()[-1])["buffers_processed"] == 4
    assert png_size(seen["bscan.png"]) == (asc, n // 2)
    assert png_size(seen["volume.png"]) == (224, 224)
    assert json.loads(seen["stats.json"])["buffers"] >= 1
    assert json.loads(seen["params.json"])["klin_coeffs"] == [0.0, n - 1.0, 0.0, 0.0]
    assert seen["device"] == "cpu"


def test_render_command_matches_jax(tmp_path):
    vol = np.random.default_rng(0).random((8, 8, 16)).astype(np.float32)
    vol_file = tmp_path / "v.raw"
    vol.tofile(vol_file)
    pngs = []
    for tag, run, pre in (("t", main, CPU), ("j", jcli.main, [])):
        out = tmp_path / f"{tag}.png"
        assert run([*pre, "render", str(vol_file), "--bscans", "8", "--ascans", "8",
                    "--depth", "16", "--mode", "xray", "--size", "16", "--lut", "ice",
                    "--out", str(out)]) == 0
        pngs.append(_png(out))
    diff = np.abs(pngs[0] - pngs[1]).max(axis=-1)
    assert pngs[0].shape == (16, 16, 3) and np.mean(diff > 1) <= 0.005


def test_missing_file_and_bad_reshape_clean_errors(tmp_path, capsys):
    assert main([*CPU, "process", "/nope/missing.raw", "--samples", "64",
                 "--ascans", "8", "--bscans", "2"]) == 1
    assert "error: file not found" in capsys.readouterr().err
    f = tmp_path / "small.raw"
    np.zeros(16, np.float32).tofile(f)
    assert main([*CPU, "render", str(f), "--bscans", "9", "--ascans", "9", "--depth", "9",
                 "--out", str(tmp_path / "x.png")]) == 1
    assert "error:" in capsys.readouterr().err


def test_default_device_without_cuda_fails_clearly(raw_file, monkeypatch, capsys):
    """The default --device cuda never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path, n, asc, bsc = raw_file
    for argv in (["process", path, *_geom(n, asc, bsc)],
                 ["replay", path, *_geom(n, asc, bsc)],
                 ["--device", "cuda:0", "render", path, "--bscans", "1", "--ascans", "1",
                  "--depth", "1", "--out", "x.png"], ["bench"]):
        assert main(argv) == 1
        assert "no CUDA device is available" in capsys.readouterr().err


def test_info_runs(capsys):
    assert main([*CPU, "info", "--no-entry-point-plugins"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("octproz_tpu_torch ")
    assert f"torch {torch.__version__}" in out
    assert "acquisition systems: phytooct" in out and "extensions:" in out


def test_module_entry_point():
    proc = subprocess.run([sys.executable, "-m", "octproz_tpu_torch", "--device", "cpu", "info",
                           "--no-entry-point-plugins"], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "octproz_tpu_torch" in proc.stdout and "device 0:" in proc.stdout


def test_mesh_raises_naming_a13(raw_file, monkeypatch, capsys):
    """--mesh on CUDA takes the local CUDA devices: too few of them is an
    error naming the mesh, never a move to the CPU (the card count faked to
    one).  (The name is kept from the test of the refusal that came before
    the port of the meshes.)"""
    path, n, asc, bsc = raw_file
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert main(["--device", "cuda", "process", path, *_geom(n, asc, bsc),
                 "--mesh", "4,2"]) == 1
    assert "mesh 4x2 needs 8 devices, have 1" in capsys.readouterr().err


def test_mesh_process_matches_single_device(raw_file, tmp_path):
    """process --device cpu --mesh 4,2 writes the same volume as without
    --mesh."""
    path, n, asc, bsc = raw_file
    outs = []
    for extra in ([], ["--mesh", "4,2"]):
        out = tmp_path / f"out{len(extra)}.raw"
        assert main([*CPU, "process", path, *_geom(n, asc, bsc), "--output", str(out),
                     *extra]) == 0
        outs.append(np.fromfile(out, np.float32))
    assert outs[0].size == 2 * bsc * asc * n // 2
    np.testing.assert_allclose(outs[1], outs[0], rtol=2e-4, atol=2e-4)


def test_settings_save_and_show_match_jax(tmp_path, capsys):
    """settings save through both CLIs writes files that settings show
    reads back to the same configuration, from either CLI."""
    base = tmp_path / "base.ini"
    base.write_text("[tpu]\nfold_concat = 1\n[plugins]\nload = a.b\n")
    flags = ["--samples", "256", "--ascans", "32", "--bscans", "8", "--fpn", "once",
             "--disp-coeffs", "0", "0", "7", "0", "--window-type", "taylor", "--bitshift",
             "--settings", str(base), "--plugins", "c.d"]
    shows = []
    for tag, run, pre in (("t", main, CPU), ("j", jcli.main, [])):
        path = str(tmp_path / f"{tag}.ini")
        assert run([*pre, "settings", "save", path, *flags]) == 0
        for reader, rpre in ((main, CPU), (jcli.main, [])):
            capsys.readouterr()
            assert reader([*rpre, "settings", "show", path]) == 0
            shows.append(json.loads(capsys.readouterr().out))
    assert all(s == shows[0] for s in shows)
    assert shows[0]["processing"]["fold_concat"] is True
    assert shows[0]["plugins"] == ["a.b", "c.d"]
    assert shows[0]["curves"]["dispersion_coeffs"] == [0.0, 0.0, 7.0, 0.0]


def _system_ini(tmp_path, buffers_per_volume):
    ini = tmp_path / "s.ini"
    ini.write_text("[system:phytooct]\nsamples_per_line = 128\nascans_per_bscan = 16\n"
                   f"bscans_per_buffer = 2\nbuffers_per_volume = {buffers_per_volume}\n"
                   "exposure_us = 0.0\n")
    return str(ini)


def test_replay_and_process_from_acquisition_system(tmp_path, capsys):
    """'system:phytooct' with its device settings from the [system:phytooct]
    group; explicit flags overlay the device's chain; geometry flags are
    refused."""
    assert main([*CPU, "replay", "system:phytooct", "--settings", _system_ini(tmp_path, 3),
                 "--metrics-window", "0.5"]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "buffers_processed"] == 3
    assert main([*CPU, "replay", "system:phytooct", "--settings", _system_ini(tmp_path, 2),
                 "--fpn", "off", "--max-buffers", "1"]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "buffers_processed"] == 1
    with pytest.raises(SystemExit, match="geometry"):
        main([*CPU, "replay", "system:phytooct", "--samples", "2048"])
    out = tmp_path / "out.raw"
    assert main([*CPU, "process", "system:phytooct", "--settings", _system_ini(tmp_path, 2),
                 "--output", str(out)]) == 0
    assert np.isfinite(np.fromfile(out, np.float32).reshape(4, 16, 64)).all()


def test_preset_base_with_flag_overlay(tmp_path):
    """--preset seeds geometry + chain; explicit flags overlay it."""
    n, asc, bsc = 128, 8, 4
    path = tmp_path / "p.raw"
    np.zeros((bsc, asc, n), np.uint16).tofile(path)
    out = tmp_path / "o.raw"
    assert main([*CPU, "process", str(path), "--preset", "benchmark", "--samples", str(n),
                 "--ascans", str(asc), "--bscans", str(bsc), "--buffers-per-volume", "1",
                 "--fpn", "off", "--output", str(out)]) == 0
    assert out.stat().st_size == bsc * asc * (n // 2) * 4


@pytest.fixture()
def small_raw_file(tmp_path):
    """One tiny 12-bit file: 4 buffers of 2x8 A-scans x 64 samples."""
    rng = np.random.default_rng(9)
    path = tmp_path / "small.raw"
    rng.integers(0, 4095, size=(4, 2, 8, 64)).astype(np.uint16).tofile(path)
    return path


def test_replay_metrics_json_stream(tmp_path, capsys, small_raw_file):
    mpath = tmp_path / "windows.jsonl"
    assert main([*CPU, "replay", str(small_raw_file), "--samples", "64", "--ascans", "8",
                 "--bscans", "2", "--max-buffers", "12", "--wait-us", "20000",
                 "--metrics-window", "0.01", "--metrics-json", str(mpath)]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["buffers_processed"] == 12 and rep["windows"] >= 1
    assert rep["last_window"]["ascans_per_s"] > 0
    lines = [json.loads(line) for line in mpath.read_text().splitlines()]
    assert len(lines) == rep["windows"] and lines[-1] == rep["last_window"]


def test_replay_packed12_wire_matches_uint16(tmp_path, capsys, small_raw_file):
    """The packed-12 wire through the CLI gives the same processed stream as
    the uint16 container wire; inconsistent wire flags are refused."""
    from octproz_tpu_torch.ops.convert import pack_uint12

    raw = np.fromfile(small_raw_file, np.uint16) & 0x0FFF
    packed_path, masked_path = tmp_path / "packed.raw", tmp_path / "masked.raw"
    pack_uint12(raw).tofile(packed_path)
    raw.tofile(masked_path)
    base = [*CPU, "--samples", "64", "--ascans", "8", "--bscans", "2", "--max-buffers", "2"]

    def run(tag, argv):
        d = tmp_path / tag
        d.mkdir()
        assert main([*argv, "--record", "--record-processed", "--record-float32",
                     "--record-buffers", "2", "--record-dir", str(d),
                     "--record-name", tag]) == 0
        assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
            "buffers_processed"] == 2
        (f,) = sorted(d.glob("*_processed_float32_*.raw"))
        return np.fromfile(f, np.float32)

    args = [base[0], base[1]]
    a = run("u16", [*args, "replay", str(masked_path), *base[2:]])
    b = run("p12", [*args, "replay", str(packed_path), "--packed-12bit", "--keep-packed",
                    "--wire-format", "packed12", *base[2:]])
    np.testing.assert_array_equal(a, b)
    with pytest.raises(SystemExit, match="packed"):
        main([*args, "replay", str(packed_path), "--wire-format", "packed12", *base[2:]])
    with pytest.raises(SystemExit, match="keep-packed requires"):
        main([*args, "replay", str(packed_path), "--keep-packed", *base[2:]])
    with pytest.raises(SystemExit, match="wire-format packed12"):
        main([*args, "replay", str(packed_path), "--packed-12bit", "--keep-packed", *base[2:]])
