"""The port's torch ops against the JAX package's: decode, the FFT stage
with the real-half identity, window and dispersion, background removal,
both resamplers, the planar and complex FPN with its tie-banded argmin,
the dynamic-range scaling, the post stages, and the shared numerics of the
kernels (bf16 mask truncation, operator splits, fast log2).  Inputs are
made with numpy from a seed and handed to both."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import octproz_tpu.ops.background as jbackground
import octproz_tpu.ops.convert as jconvert
import octproz_tpu.ops.dispersion as jdispersion
import octproz_tpu.ops.fft as jfft
import octproz_tpu.ops.fpn as jfpn
import octproz_tpu.ops.postprocess as jpost
import octproz_tpu.ops.resample as jresample
import octproz_tpu.params as jparams
import octproz_tpu_torch.kernels.fused_prep as tfp
import octproz_tpu_torch.ops.background as tbackground
import octproz_tpu_torch.ops.convert as tconvert
import octproz_tpu_torch.ops.dispersion as tdispersion
import octproz_tpu_torch.ops.fft as tfft
import octproz_tpu_torch.ops.fpn as tfpn
import octproz_tpu_torch.ops.postprocess as tpost
import octproz_tpu_torch.ops.resample as tresample
from octproz_tpu_torch import curves as tcurves
from octproz_tpu_torch.params import AcqParams, FPN_SEGMENTS, FPN_TIE_EPS, Interpolation
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

jfp = importlib.import_module("octproz_tpu.pallas.fused_prep")

DTYPES = {8: np.uint8, 12: np.uint16, 16: np.uint16, 32: np.uint32}


@pytest.mark.parametrize("bit_depth", [8, 12, 16, 32])
@pytest.mark.parametrize("bitshift", [False, True])
def test_decode_exact(bit_depth, bitshift, rng):
    """Exact: every sample of these containers is an integer below 2^24
    (or a float32 quotient by 2^32) that both sides compute identically."""
    hi = min(2 ** bit_depth, 2 ** 32)
    raw = rng.integers(0, hi, size=(4, 8, 64), dtype=np.uint64).astype(DTYPES[bit_depth])
    raw.flat[:3] = [0, hi - 1, hi // 2]
    got = tconvert.decode(torch.from_numpy(raw), bit_depth, bitshift)
    want = np.asarray(jconvert.decode(jnp.asarray(raw), bit_depth, bitshift))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_decode_in_kernel_matches_decode(rng):
    """The kernel's decode (_decode_block) equals ops.convert.decode for the
    8/16-bit containers it takes, and passes float32 through."""
    for dt in (np.uint8, np.uint16):
        raw = torch.from_numpy(rng.integers(0, np.iinfo(dt).max, size=(16, 32)).astype(dt))
        for shift in (False, True):
            np.testing.assert_array_equal(tfp._decode_block(raw, shift).numpy(),
                                          tconvert.decode(raw, 16, shift).numpy())
    f = torch.rand(4, 4)
    assert tfp._decode_block(f, True) is f


def _tied_lines(rng, width=48, seg_width=4):
    """9 segments of ``seg_width`` lines (plus 2 trailing ignored lines):
    segments 2, 5 and 7 are exact copies of one quiet segment (an exact
    tie at the minimum variance); segment 1 is that segment with re scaled
    by (1 + 1e-5) at even depths -- a slightly larger variance, but inside
    the band, so it wins there as the lowest tied index -- and noisy at odd
    depths; the other segments are noisy."""
    n = FPN_SEGMENTS * seg_width + 2
    re = rng.normal(0.0, 5.0, size=(n, width)).astype(np.float32)
    im = rng.normal(0.0, 5.0, size=(n, width)).astype(np.float32)
    quiet_re = rng.normal(3.0, 0.5, size=(seg_width, width)).astype(np.float32)
    quiet_im = rng.normal(-1.0, 0.5, size=(seg_width, width)).astype(np.float32)
    for s in (2, 5, 7):
        re[s * seg_width:(s + 1) * seg_width] = quiet_re
        im[s * seg_width:(s + 1) * seg_width] = quiet_im
    seg1 = slice(seg_width, 2 * seg_width)
    re[seg1, ::2] = quiet_re[:, ::2] * np.float32(1.0 + 1e-5)
    im[seg1, ::2] = quiet_im[:, ::2]
    return re, im


def test_fpn_tied_segments_pick_same_indices(rng):
    """Ties (exact and within the band) resolve to the LOWEST segment index
    in both packages: same chosen segment per depth, and the means agree
    to float32 summation order (rtol 1e-6)."""
    re, im = _tied_lines(rng)
    t_sums = tfpn.segment_sums_planar(torch.from_numpy(re), torch.from_numpy(im))
    j_sums = jfpn.segment_sums_planar(jnp.asarray(re), jnp.asarray(im))
    assert t_sums[3] == j_sums[3]
    for t, j in zip(t_sums[:3], j_sums[:3]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-5)
    # the selection on identical statistics
    sum_re, sum_im, sum_sq = (np.asarray(j) for j in j_sums[:3])
    factor = np.float32(1.0) / np.float32(j_sums[3])
    mean_re, mean_im = sum_re * factor, sum_im * factor
    var = sum_sq * factor - (mean_re ** 2 + mean_im ** 2)
    power = np.mean(sum_sq * factor, axis=0, dtype=np.float32)
    t_best = tfpn._banded_argmin(torch.from_numpy(var), torch.from_numpy(power)).numpy()
    j_best = np.asarray(jfpn._banded_argmin(jnp.asarray(var), jnp.asarray(power)))
    np.testing.assert_array_equal(t_best, j_best)
    assert (t_best[::2] == 1).all()   # in the band, lowest index, not the minimum
    assert (t_best[1::2] == 2).all()  # lowest of the exact ties
    t_mean = tfpn.minimum_variance_mean_planar(torch.from_numpy(re), torch.from_numpy(im))
    j_mean = jfpn.minimum_variance_mean_planar(jnp.asarray(re), jnp.asarray(im))
    for t, j in zip(t_mean, j_mean):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-6)


def test_banded_argmin_lowest_index_rule():
    var = torch.tensor([[5.0, 1.0, 2.0], [1.0, 1.0, 2.0005], [1.0, 3.0, 2.0]])
    power = torch.tensor([1.0, 1.0, 1.0])
    # column 0: rows 1, 2 tie at the minimum -> 1; column 1: rows 0, 1 -> 0;
    # column 2: rows 0, 2 tie exactly and row 1 is inside the band -> 0
    assert tfpn._banded_argmin(var, power).tolist() == [1, 0, 0]
    assert FPN_TIE_EPS == 1e-3


def test_fpn_needs_nine_lines():
    with pytest.raises(ValueError, match="at least 9"):
        tfpn.segment_sums_planar(torch.zeros(8, 4), torch.zeros(8, 4))


@pytest.mark.parametrize("scale", ["log", "lin"])
@pytest.mark.parametrize("gmin,gmax,addend,coeff", [(0.0, 60.0, 0.0, 1.0),
                                                    (10.0, 70.0, 0.05, 0.8)])
def test_scale_planar_matches(scale, gmin, gmax, addend, coeff, rng):
    """float32 on both sides; log10/sqrt may differ in the last ulp, so
    rtol 1e-6 with an absolute floor of 1e-6."""
    re = rng.normal(0, 300.0, size=(16, 64)).astype(np.float32)
    im = rng.normal(0, 300.0, size=(16, 64)).astype(np.float32)
    tf = tpost.scale_log_planar if scale == "log" else tpost.scale_lin_planar
    jf = jpost.scale_log_planar if scale == "log" else jpost.scale_lin_planar
    got = tf(torch.from_numpy(re), torch.from_numpy(im), 64, gmin, gmax, addend, coeff)
    want = np.asarray(jf(jnp.asarray(re), jnp.asarray(im), 64, gmin, gmax, addend, coeff))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_truncate_half():
    z = torch.arange(24.0).reshape(2, 12)
    assert tpost.truncate_half(z).shape == (2, 6)
    np.testing.assert_array_equal(tpost.truncate_half(z).numpy(), z.numpy()[:, :6])


def test_bf16_mask_truncation_and_split_equal(rng):
    """Bit equality: the mask truncation and the operator split must be the
    JAX package's exactly (a cast round trip would round instead)."""
    w = (rng.normal(size=(64, 32)) * 10.0 ** rng.integers(-3, 3, size=(64, 32))).astype(np.float32)
    t_trunc = tfp._bf16_trunc(torch.from_numpy(w)).numpy()
    j_trunc = np.asarray(jfp._bf16_trunc(jnp.asarray(w)))
    np.testing.assert_array_equal(t_trunc, j_trunc)
    assert not np.array_equal(t_trunc, torch.from_numpy(w).to(torch.bfloat16).float().numpy())
    for parts in (2, 3):
        t_parts = tfp._split_bf16(torch.from_numpy(w), parts)
        j_parts = jfp._split_bf16(jnp.asarray(w), parts)
        for t, j in zip(t_parts, j_parts):
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.float().numpy(), np.asarray(j, np.float32))


@pytest.mark.parametrize("parts", [2, 3])
def test_dot_split_matches(parts, rng):
    """Each pass term is an exact bf16 x bf16 product; the sums differ only
    in float32 accumulation order: |diff| <= 1e-6 * max|ref|."""
    x = rng.integers(0, 4096, size=(32, 128)).astype(np.float32)
    w = rng.normal(size=(128, 16)).astype(np.float32)
    got = tfp._dot_split(torch.from_numpy(x), tfp._split_bf16(torch.from_numpy(w), parts))
    want = np.asarray(jfp._dot_split(jnp.asarray(x), jfp._split_bf16(jnp.asarray(w), parts)))
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()


def test_fast_log2_matches(rng):
    """Same exponent extraction and polynomial: |diff| <= 2e-6 (a fused or
    separate multiply-add in Horner's rule moves the last bits)."""
    p = np.concatenate([[0.0, 1.0, 2.0, 1e-30], 10.0 ** rng.uniform(-6, 12, 500)]).astype(np.float32)
    got = tfp._fast_log2(torch.from_numpy(p)).numpy()
    want = np.asarray(jfp._fast_log2(jnp.asarray(p)))
    assert np.isfinite(got[0]) and got[0] < -120  # p == 0 stays finite
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    np.testing.assert_allclose(got[4:], np.log2(p[4:].astype(np.float64)), atol=4e-5)


@pytest.mark.parametrize("log_scaling,fast_log", [(True, False), (False, False),
                                                   (True, True)])
def test_scale_epilogue_matches(log_scaling, fast_log, rng):
    p = np.concatenate([[0.0], 10.0 ** rng.uniform(-3, 10, 300)]).astype(np.float32)
    a, b = tfp._scale_affine(log_scaling, 128, 0.0, 60.0, 0.0, 1.0)
    got = tfp._scale_epilogue(torch.from_numpy(p), log_scaling=log_scaling, a=a, b=b,
                              fast_log=fast_log).numpy()
    want = np.asarray(jfp._scale_epilogue(jnp.asarray(p), log_scaling=log_scaling,
                                          a=a, b=b, fast_log=fast_log))
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6)
    if log_scaling and not fast_log:
        assert got[0] == -np.inf  # p == 0 -> -inf on the exact path


# ---------------------------------------------------------------------------
# The FFT path's ops
# ---------------------------------------------------------------------------

def _rel_l2(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.linalg.norm((got - want).ravel()) / np.linalg.norm(want.ravel())


def test_ifft_spectra_matches(rng):
    """Unnormalised inverse FFT of complex spectra: two float32 FFT
    libraries round differently, ~log2(n) ulps: relative L2 <= 1e-6."""
    x = ((rng.normal(size=(4, 8, 256)) + 1j * rng.normal(size=(4, 8, 256))) * 1e3
         ).astype(np.complex64)
    got = tfft.ifft_spectra(torch.from_numpy(x))
    assert got.dtype == torch.complex64 and tuple(got.shape) == x.shape
    assert _rel_l2(got.numpy(), jfft.ifft_spectra(jnp.asarray(x))) <= 1e-6


def test_ifft_real_half_identity(rng):
    """conj(rfft(x))[:half] equals the first half of the unnormalised
    inverse FFT of real x, and the JAX package's; relative L2 <= 1e-6 (as
    above).  The conjugate is resolved: the result is a plain tensor whose
    storage holds the conjugated values (view_as_real reads it)."""
    x = rng.integers(0, 4096, size=(4, 8, 256)).astype(np.float32)
    got = tfft.ifft_spectra_real_half(torch.from_numpy(x), 128)
    assert got.dtype == torch.complex64 and tuple(got.shape) == (4, 8, 128)
    assert not got.is_conj()
    pairs = torch.view_as_real(got)
    assert torch.equal(pairs[..., 0], got.real) and torch.equal(pairs[..., 1], got.imag)
    assert _rel_l2(got.numpy(), jfft.ifft_spectra_real_half(jnp.asarray(x), 128)) <= 1e-6
    full = tfft.ifft_spectra(torch.from_numpy(x))[..., :128]
    assert _rel_l2(got.numpy(), full.numpy()) <= 1e-6


def test_window_and_dispersion_exact(rng):
    """Elementwise float32 products in the same order: exact."""
    x = rng.integers(0, 4096, size=(4, 8, 64)).astype(np.float32)
    win = rng.uniform(0, 1, size=64).astype(np.float32)
    phase = np.exp(1j * rng.uniform(-3, 3, size=64)).astype(np.complex64)
    tx, tw, tph = torch.from_numpy(x), torch.from_numpy(win), torch.from_numpy(phase)
    np.testing.assert_array_equal(tdispersion.apply_window(tx, tw).numpy(),
                                  np.asarray(jdispersion.apply_window(jnp.asarray(x),
                                                                      jnp.asarray(win))))
    np.testing.assert_array_equal(tdispersion.apply_dispersion(tx, tph).numpy(),
                                  np.asarray(jdispersion.apply_dispersion(jnp.asarray(x),
                                                                          jnp.asarray(phase))))
    for w, ph in ((None, None), (tw, None), (None, tph), (tw, tph)):
        got = tdispersion.prep_spectra(tx, w, ph)
        want = np.asarray(jdispersion.prep_spectra(
            jnp.asarray(x), None if w is None else jnp.asarray(win),
            None if ph is None else jnp.asarray(phase)))
        assert got.dtype == (torch.complex64 if ph is not None else torch.float32)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("window", [1, 8, 64])
def test_remove_background_matches(window, rng):
    """Decoded samples are integers whose prefix sums stay below 2^24, so
    the exclusive cumsum is exact in any order and the result is equal.
    Float input: the prefix sums round in another order, at most
    n * 2^-24 * max|x| apart."""
    x = rng.integers(0, 4096, size=(4, 8, 256)).astype(np.float32)
    got = tbackground.remove_background(torch.from_numpy(x), window).numpy()
    np.testing.assert_array_equal(got, np.asarray(jbackground.remove_background(
        jnp.asarray(x), window)))
    xf = rng.normal(0, 1e3, size=(4, 8, 256)).astype(np.float32)
    got = tbackground.remove_background(torch.from_numpy(xf), window).numpy()
    want = np.asarray(jbackground.remove_background(jnp.asarray(xf), window))
    assert np.abs(got - want).max() <= 256 * 2.0 ** -24 * np.abs(xf).max()


def _curve(n=256):
    acq = AcqParams(samples_per_line=n, ascans_per_bscan=8, bscans_per_buffer=1)
    return tcurves.resample_curve(acq, 0.0, n - 1.0, 10.0, -4.0)


@pytest.mark.parametrize("precision", ["default", "high", "highest"])
def test_apply_matmul_rungs_match(precision, rng):
    """The resample product at each rung (one float32 product, or the bf16
    split passes): the same terms summed in another float32 order,
    |diff| <= 1e-6 * max|ref|."""
    x = rng.integers(0, 4096, size=(4, 8, 256)).astype(np.float32)
    m = tresample.build_resample_matrix(_curve(), Interpolation.CUBIC)
    got = tresample.apply_matmul(torch.from_numpy(x), torch.from_numpy(m), precision=precision)
    want = np.asarray(jresample.apply_matmul(jnp.asarray(x), jnp.asarray(m),
                                             precision=precision))
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("mode", list(Interpolation))
def test_apply_gather_matches(mode, rng):
    """Every interpolator, with the cubic n0 = abs(n1-1) rule and the
    per-tap clamp (the curve starts at 0, so both edges are reached): the
    same float32 formulas; only Lanczos's sin may differ in the last ulp,
    |diff| <= 1e-6 * max|ref|."""
    x = rng.normal(0, 1e3, size=(4, 8, 256)).astype(np.float32)
    curve = _curve()
    got = tresample.apply_gather(torch.from_numpy(x), torch.from_numpy(curve), mode)
    want = np.asarray(jresample.apply_gather(jnp.asarray(x), jnp.asarray(curve),
                                             jparams.Interpolation(mode.value)))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()


def test_complex_fpn_matches_with_ties(rng):
    """The complex FPN functions on the tied lines of the planar test: the
    same segment wins per depth (lowest tied index), means to float32
    summation order (rtol 1e-6)."""
    re, im = _tied_lines(rng)
    z = (re + 1j * im).astype(np.complex64)
    t_sum, t_sq, t_w = tfpn.segment_sums(torch.from_numpy(z))
    j_sum, j_sq, j_w = jfpn.segment_sums(jnp.asarray(z))
    assert t_w == j_w and t_sum.dtype == torch.complex64
    np.testing.assert_allclose(t_sum.numpy(), np.asarray(j_sum), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(t_sq.numpy(), np.asarray(j_sq), rtol=1e-6, atol=1e-5)
    sel = tfpn.select_min_variance_mean(torch.from_numpy(np.array(j_sum)),
                                        torch.from_numpy(np.array(j_sq)), j_w)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(
        jfpn.select_min_variance_mean(j_sum, j_sq, j_w)))
    t_mean = tfpn.minimum_variance_mean(torch.from_numpy(z))
    j_mean = np.asarray(jfpn.minimum_variance_mean(jnp.asarray(z)))
    np.testing.assert_allclose(t_mean.numpy(), j_mean, rtol=1e-6, atol=1e-6)
    # the winning segment's mean at even depths is segment 1's (in the band)
    np.testing.assert_allclose(t_mean.numpy()[::2], z[4:8, ::2].mean(axis=0), rtol=1e-5)
    got = tfpn.subtract_mean_line(torch.from_numpy(z[:4]), t_mean)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jfpn.subtract_mean_line(jnp.asarray(z[:4]), jnp.asarray(t_mean.numpy()))))


@pytest.mark.parametrize("scale", ["log", "lin"])
def test_scale_complex_matches(scale, rng):
    """Complex scaling is the planar scaling of (re, im): rtol 1e-6, atol
    1e-6, as the planar test."""
    z = ((rng.normal(size=(16, 64)) + 1j * rng.normal(size=(16, 64))) * 300).astype(np.complex64)
    tf = tpost.scale_log if scale == "log" else tpost.scale_lin
    jf = jpost.scale_log if scale == "log" else jpost.scale_lin
    got = tf(torch.from_numpy(z), 64, 10.0, 70.0, 0.05, 0.8)
    want = np.asarray(jf(jnp.asarray(z), 64, 10.0, 70.0, 0.05, 0.8))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_bscan_flip_exact(rng):
    vol = rng.normal(size=(5, 16, 8)).astype(np.float32)
    got = tpost.bscan_flip(torch.from_numpy(vol)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jpost.bscan_flip(jnp.asarray(vol))))
    np.testing.assert_array_equal(got[0], vol[0, ::-1])
    np.testing.assert_array_equal(got[1], vol[1])


def test_sinusoidal_correction_matches_with_last_ascan_guard(rng):
    """Linear interpolation in float32 by the same formula: exact.  The
    buffer's last A-scan keeps its input values (the reference's guard)."""
    vol = rng.normal(size=(3, 32, 8)).astype(np.float32)
    curve = tcurves.sinusoidal_scan_curve(32)
    got = tpost.sinusoidal_correction(torch.from_numpy(vol), torch.from_numpy(curve)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jpost.sinusoidal_correction(
        jnp.asarray(vol), jnp.asarray(curve))))
    np.testing.assert_array_equal(got[-1, -1], vol[-1, -1])
    unguarded = got[0, -1]  # the same position in another B-scan is resampled
    assert not np.array_equal(unguarded, vol[0, -1])


def test_post_background_matches(rng):
    """get_background: float32 means in another summation order (rtol
    1e-6); remove_post_background: the same elementwise float32 formula,
    exact, saturated to [0, 1]."""
    vol = rng.uniform(-0.5, 1.5, size=(4, 16, 32)).astype(np.float32)
    bg = tpost.get_background(torch.from_numpy(vol))
    np.testing.assert_allclose(bg.numpy(), np.asarray(jpost.get_background(jnp.asarray(vol))),
                               rtol=1e-6)
    got = tpost.remove_post_background(torch.from_numpy(vol), bg, 0.7, 0.05).numpy()
    want = np.asarray(jpost.remove_post_background(jnp.asarray(vol), jnp.asarray(bg.numpy()),
                                                   0.7, 0.05))
    np.testing.assert_array_equal(got, want)
    assert got.min() == 0.0 and got.max() == 1.0
