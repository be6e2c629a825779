"""The port's display side on the CPU -- projections, LUTs, the PNG codec,
the 1-D plots and the seven-mode raycaster -- held against the JAX
package's modules (tests/test_viz.py, tests/test_plots.py) on the same
numpy inputs made from a seed.

Tolerances:
* projections, ``to_uint8``, the LUTs, ``apply_lut``, PNG pixels and
  ``compute_sample_depths``: exact;
* the raycaster: the two frameworks interpolate with the same weights
  rounded in another order (``grid_sample`` against ``map_coordinates``),
  so a sample differs in its last bits.  Each pixel's largest channel
  difference is held to ``RENDER_ATOL``.  MIP and DMIP keep a pixel's value
  continuous in its samples and are held on every pixel (measured, CPU:
  at most 5.1e-6 over four volumes, three views and the stretch).  The
  other modes threshold every sample (XRAY counts the samples above the
  threshold; ISOSURFACE takes the first hit; ALPHA and MIDA freeze at
  a >= 0.9; OCT_DEPTH tests d_delta), so a sample within rounding of a
  threshold may decide a pixel the other way: they are held on all but
  ``FLIP_SHARE`` of the pixels (measured, CPU: at most 1 pixel of 1920,
  in ALPHA with shading, OCT_DEPTH and XRAY at threshold 0.1 in the
  stretched view; elsewhere no pixel above 6e-6).
"""

import dataclasses

import numpy as np
import pytest
import torch

import octproz_tpu.ops.projections as jproj
import octproz_tpu.params as jparams
import octproz_tpu.viz as jviz
import octproz_tpu.viz.plots as jplots
import octproz_tpu.viz.render as jrender
from octproz_tpu_torch.ops import projections as tproj
from octproz_tpu_torch.params import DisplayFunction
from octproz_tpu_torch.viz import image as timage
from octproz_tpu_torch.viz import plots as tplots
from octproz_tpu_torch.viz import render as trender

RENDER_ATOL = 5e-5
FLIP_SHARE = 0.005
CONTINUOUS = ("mip", "depth_mip")
LUTS = ["gray", "fire", "hotter", "ice", "blue", "deep_blue", "deep_red", "six_shades",
        "sixteen_colors", "depth_colors"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's small CPU work: under xdist the
    default (a thread per core in every worker) oversubscribes the cores,
    which slows these tests many times over and starves the other workers'."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def volume():
    """(16, 16, 32) volume: a bright slab at depth 10..14, intensity 0.8."""
    v = np.zeros((16, 16, 32), np.float32)
    v[:, :, 10:14] = 0.8
    v[4:8, 4:8, 20:24] = 0.5  # dimmer deeper blob
    return v


def _asymmetric(seed=5):
    """(12, 20, 28): a slab, two blobs off every axis' centre, noise -- no
    two axes alike, so a swapped sampling axis changes the image."""
    rng = np.random.default_rng(seed)
    v = np.zeros((12, 20, 28), np.float32)
    v[:, :, 9:13] = 0.8
    v[3:7, 4:9, 18:23] = 0.5
    v[8:11, 12:18, 3:6] = 0.95
    return v + rng.random(v.shape).astype(np.float32) * 0.2


# -- projections ---------------------------------------------------------------

@pytest.mark.parametrize("function", [DisplayFunction.AVERAGING, DisplayFunction.MIP])
@pytest.mark.parametrize("which", ["bscan_frame", "enface_frame"])
def test_frame_windows_match_jax_exactly(which, function):
    """Every window (clamped start, skipped tail, 0/1/many frames), both
    composites and the display flip, bit for bit."""
    v = np.random.default_rng(0).normal(0.3, 0.5, (9, 7, 11)).astype(np.float32)
    jfun = jparams.DisplayFunction(int(function))
    for nr in (-3, 0, 2, 5, 8, 10, 20):
        for frames in (0, 1, 2, 3, 4, 5, 7, 12):
            for flip in (False, True):
                want = np.asarray(getattr(jproj, which)(v, nr, frames, jfun, flip))
                got = getattr(tproj, which)(torch.from_numpy(v), nr, frames, function, flip)
                np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{nr} {frames} {flip}")


def test_mip_floor_and_projections_match_jax():
    v = -np.random.default_rng(1).random((5, 4, 6)).astype(np.float32)  # all negative
    got = tproj.bscan_frame(torch.from_numpy(v), 1, 3, DisplayFunction.MIP)
    assert (got.numpy() == 0.0).all()  # the reference's MIP starts at 0
    assert tproj._frame_window(5, -2, 3).tolist() == jproj._frame_window(5, -2, 3).tolist()
    w = np.random.default_rng(2).random((5, 4, 6)).astype(np.float32)
    for axis in range(3):
        np.testing.assert_array_equal(tproj.mip_projection(torch.from_numpy(w), axis).numpy(),
                                      np.asarray(jproj.mip_projection(w, axis)))
        np.testing.assert_allclose(tproj.mean_projection(torch.from_numpy(w), axis).numpy(),
                                   np.asarray(jproj.mean_projection(w, axis)), rtol=1e-6)


# -- LUTs, uint8 and PNG -----------------------------------------------------------

@pytest.mark.parametrize("name", LUTS)
def test_builtin_luts_match_jax(name):
    lut = timage.builtin_lut(name)
    assert lut.shape == (256, 3) and lut.min() >= 0.0 and lut.max() <= 1.0
    np.testing.assert_array_equal(lut, jviz.builtin_lut(name))
    np.testing.assert_array_equal(timage.builtin_lut(name, 17), jviz.builtin_lut(name, 17))


def test_to_uint8_and_apply_lut_match_jax():
    img = np.random.default_rng(3).normal(0.5, 0.6, (13, 9)).astype(np.float32)
    np.testing.assert_array_equal(timage.to_uint8(img), jviz.to_uint8(img))
    for name in ("gray", "fire", "sixteen_colors"):
        lut = timage.builtin_lut(name)
        np.testing.assert_array_equal(timage.apply_lut(img, lut), jviz.apply_lut(img, lut))
    with pytest.raises(ValueError, match="unknown builtin LUT"):
        timage.builtin_lut("nope")


@pytest.mark.parametrize("shape", [(8, 8), (7, 5, 3), (1, 33), (40, 1, 3)])
def test_png_pixels_match_jax_save_png(tmp_path, shape):
    """The port's own PNG writer, decoded by Pillow, holds the same pixels
    as the JAX package's Pillow-written file; the port's decoder reads its
    own file back to those pixels."""
    from PIL import Image

    img = np.random.default_rng(4).random(shape).astype(np.float32)
    got = timage.save_png(str(tmp_path / "t.png"), img)
    want = jviz.save_png(str(tmp_path / "j.png"), img)
    g, w = np.asarray(Image.open(got)), np.asarray(Image.open(want))
    assert Image.open(got).mode == ("L" if len(shape) == 2 else "RGB")
    np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(g, timage.to_uint8(img))
    data = open(got, "rb").read()
    assert timage.png_size(data) == (shape[1], shape[0])
    np.testing.assert_array_equal(timage.decode_png(data), w)


def test_png_codec_refuses_what_it_does_not_read(tmp_path):
    from PIL import Image

    rgb = np.cumsum(np.random.default_rng(6).integers(0, 9, (24, 31, 3)), axis=1)
    rgb = rgb.astype(np.uint8)
    Image.fromarray(rgb).save(tmp_path / "f.png", optimize=True)  # Pillow filters rows
    with pytest.raises(ValueError, match="filter 0"):
        timage.decode_png((tmp_path / "f.png").read_bytes())
    data = bytearray(timage.encode_png(rgb))
    data[40] ^= 0xFF  # inside IDAT
    with pytest.raises(ValueError, match="CRC"):
        timage.decode_png(bytes(data))
    with pytest.raises(ValueError, match="not a PNG"):
        timage.png_size(b"GIF89a" + bytes(30))
    with pytest.raises(ValueError, match="uint8"):
        timage.encode_png(rgb.astype(np.float32))
    with pytest.raises(ValueError, match="pixels"):
        timage.encode_png(np.zeros((4, 4, 4), np.uint8))


def test_lut_png_roundtrip(tmp_path):
    lut = timage.builtin_lut("fire")
    timage.save_png(str(tmp_path / "lut.png"), lut.reshape(1, -1, 3))
    back = timage.load_lut_png(str(tmp_path / "lut.png"))
    assert back.shape == (256, 3)
    np.testing.assert_array_equal(back, jviz.load_lut_png(str(tmp_path / "lut.png")))
    np.testing.assert_allclose(back, lut, atol=1 / 255.0 + 1e-6)


def test_bscan_enface_export_matches_jax(tmp_path, volume):
    """Same PNG pixels as the JAX package's exports, from a host array and
    from a tensor."""
    from PIL import Image

    lut = timage.builtin_lut("fire")
    pairs = [(timage.save_bscan_png(str(tmp_path / "b.png"), volume, frame_nr=2),
              jviz.save_bscan_png(str(tmp_path / "jb.png"), volume, frame_nr=2)),
             (timage.save_enface_png(str(tmp_path / "e.png"), torch.from_numpy(volume),
                                     depth_nr=12, lut=lut, display_frames=3),
              jviz.save_enface_png(str(tmp_path / "je.png"), volume, depth_nr=12,
                                   lut=lut, display_frames=3))]
    assert Image.open(pairs[0][0]).size == (16, 32)   # (ascans, depth)
    assert Image.open(pairs[1][0]).size == (16, 16) and Image.open(pairs[1][0]).mode == "RGB"
    for got, want in pairs:
        np.testing.assert_array_equal(np.asarray(Image.open(got)), np.asarray(Image.open(want)))


# -- the raycaster --------------------------------------------------------------

def _render_pair(v, out_shape=(40, 48), yaw=0.7, pitch=0.4, lut=None, **params):
    mode = params.pop("mode")
    want = np.asarray(jrender.render_volume(
        v, jrender.RenderParams(mode=jrender.RenderMode(mode), **params), yaw=yaw,
        pitch=pitch, out_shape=out_shape, lut=lut))
    got = trender.render_volume(
        v, trender.RenderParams(mode=trender.RenderMode(mode), **params), yaw=yaw,
        pitch=pitch, out_shape=out_shape, lut=lut, device="cpu")
    return got, want


def _hold(got, want, mode):
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.isfinite(got).all() and got.min() >= 0.0 and got.max() <= 1.0
    diff = np.abs(got - want).max(axis=-1)
    share = float(np.mean(diff > RENDER_ATOL))
    if mode in CONTINUOUS:
        assert share == 0.0, diff.max()
    else:
        assert share <= FLIP_SHARE, (share, diff.max())


@pytest.mark.parametrize("mode", [m.value for m in trender.RenderMode])
def test_render_modes_match_jax(mode):
    """Each mode on the asymmetric volume, rotated, against the JAX
    raycaster."""
    got, want = _render_pair(_asymmetric(), mode=mode, step_length=0.02, threshold=0.3)
    _hold(got, want, mode)
    assert want.max() > 0.05


@pytest.mark.parametrize("case", ["alpha_shading", "mip_lut", "dmip_rotated", "xray_stretch",
                                  "isosurface_stretch", "oct_depth_lut"])
def test_render_options_match_jax(case):
    """Shading, a LUT, stretch and a second rotated view (yaw 2.2, pitch
    -0.8): a swapped sampling axis would move every structure."""
    lut = jviz.builtin_lut("fire")
    params = {
        "alpha_shading": dict(mode="alpha_blending", shading=True, threshold=0.3),
        "mip_lut": dict(mode="mip", threshold=0.1, lut=lut),
        "dmip_rotated": dict(mode="depth_mip", threshold=0.2, step_length=0.013,
                             yaw=2.2, pitch=-0.8),
        "xray_stretch": dict(mode="xray", threshold=0.1, stretch=(1.0, 0.7, 1.3),
                             yaw=2.2, pitch=-0.8),
        "isosurface_stretch": dict(mode="isosurface", threshold=0.3, stretch=(1.0, 0.7, 1.3),
                                   yaw=2.2, pitch=-0.8),
        "oct_depth_lut": dict(mode="oct_depth", threshold=0.3, lut=lut, gamma=1.3),
    }[case]
    params.setdefault("step_length", 0.02)
    got, want = _render_pair(_asymmetric(), **params)
    _hold(got, want, params["mode"])


def test_render_axes_are_not_swapped():
    """A bright bar in a corner of a non-cubic volume -- B-scans 0-1 of 6,
    A-scans 0-7 of 10, depths 0-3 of 14 -- seen along the depth axis: the
    port's image equals the JAX package's, and differs from the image of
    the volume with its B-scan and A-scan axes swapped."""
    v = np.zeros((6, 10, 14), np.float32)
    v[0:2, 0:8, 0:4] = 1.0
    got, want = _render_pair(v, out_shape=(24, 24), yaw=0.0, pitch=0.0, mode="mip",
                             step_length=0.02, threshold=0.1)
    _hold(got, want, "mip")
    swapped = trender.render_volume(
        np.ascontiguousarray(v.transpose(1, 0, 2)),
        trender.RenderParams(mode=trender.RenderMode.MIP, step_length=0.02, threshold=0.1),
        out_shape=(24, 24), device="cpu")
    assert np.abs(swapped - got).max() > 0.5


@pytest.mark.parametrize("mode", list(trender.RenderMode))
def test_render_modes_produce_signal(volume, mode):
    params = trender.RenderParams(mode=mode, step_length=0.05, threshold=0.2,
                                  shading=(mode == trender.RenderMode.ISOSURFACE))
    img = trender.render_volume(volume, params, out_shape=(32, 32), device="cpu")
    assert img.shape == (32, 32, 3)
    assert np.isfinite(img).all()
    assert img.min() >= 0.0 and img.max() <= 1.0
    assert img.max() > 0.05, f"{mode} produced an all-black image"


def test_mip_sees_brightest(volume):
    img = trender.render_volume(
        volume, trender.RenderParams(mode=trender.RenderMode.MIP, step_length=0.02,
                                     threshold=0.1, gamma=1.0, alpha_exponent=0.0),
        out_shape=(32, 32), device="cpu")
    # alpha_exponent=0 -> a=1, so the background blend leaves the max itself
    assert abs(img[16, 16].max() - 0.8) < 0.1


def test_render_takes_a_tensor_and_keeps_params_frozen(volume):
    params = trender.RenderParams(mode=trender.RenderMode.XRAY, step_length=0.05)
    a = trender.render_volume(torch.from_numpy(volume), params, out_shape=(16, 16),
                              device="cpu")
    b = trender.render_volume(volume, params, out_shape=(16, 16), device="cpu")
    np.testing.assert_array_equal(a, b)
    with pytest.raises(dataclasses.FrozenInstanceError):
        params.threshold = 0.5


@pytest.mark.parametrize("threshold", [0.1, 0.5, 0.9])
def test_compute_sample_depths_matches_jax_exactly(volume, threshold):
    rng = np.random.default_rng(7)
    for v in (volume, rng.random((5, 6, 64)).astype(np.float32)):
        got = trender.compute_sample_depths(torch.from_numpy(v), threshold).numpy()
        np.testing.assert_array_equal(got, np.asarray(jrender.compute_sample_depths(v, threshold)))
    col = trender.compute_sample_depths(torch.from_numpy(volume), 0.1).numpy()[0, 0]
    assert col[20] == 0.0 and col[13] > 0.9 and col[5] < col[13]


# -- 1-D plots ---------------------------------------------------------------------

def test_plots_numpy_half_matches_jax(tmp_path):
    line = np.random.default_rng(8).normal(1000, 300, 64)
    assert dataclasses.asdict(tplots.LineStats.of(line)) == \
        dataclasses.asdict(jplots.LineStats.of(line))
    assert tplots.LineStats.of(line).label() == jplots.LineStats.of(line).label()
    raw = np.array([16, 4095], np.uint16)
    for shift in (False, True):
        np.testing.assert_array_equal(tplots.cast_raw_line(raw, 12, bitshift=shift),
                                      jplots.cast_raw_line(raw, 12, bitshift=shift))
    buf = np.arange(24).reshape(2, 3, 4)
    np.testing.assert_array_equal(tplots.select_line(buf, 9, 9), buf[1, 2])
    traces = (("raw", np.array([1.5, 2.5])), ("proc", np.array([0.25])))
    got = open(tplots.export_csv(str(tmp_path / "t.csv"), *traces)).read()
    assert got == open(jplots.export_csv(str(tmp_path / "j.csv"), *traces)).read()
    assert got.splitlines()[2] == "1;2.5;"


def test_plot_lines_png(tmp_path):
    from PIL import Image

    raw = 1000 + 500 * np.cos(np.linspace(0, 20, 256))
    proc = np.abs(np.sin(np.linspace(0, 5, 128)))
    p = tplots.plot_lines(str(tmp_path / "p.png"), raw_line=raw, processed_line=proc,
                          overlays=[("reference", proc * 0.5)])
    assert min(Image.open(p).size) > 100
    with pytest.raises(ValueError):
        tplots.plot_lines(str(tmp_path / "x.png"))
