"""The fold (one operator per axis, and concatenated [W_re | W_im]) and
prep kernels: each plain PyTorch version against the JAX package's Pallas
kernel (run in interpret mode on the CPU, as its own tests
run it; JAX's own tests never run the prep kernels at "high" or "highest",
these do), and -- on a CUDA GPU only -- each CUDA kernel against its plain
version.

Tolerances (float32 on both sides), those of the kernels' own comparison
(``fused_prep.planar_error`` / ``scale_error`` / ``prep_error``, reasons
stated there):
* planar (re, im): ||port - ref||_2 <= 3e-6 ||ref||_2, and every element
  within 1e-5 * max|ref|.  The contraction is summed in another order.
* prep spectra (complex as (re, im), or real): ||port - ref||_2 <= 1e-6
  ||ref||_2, and every element within 1e-5 * max|ref|.
* scaled image: equal finite masks; where ref is at or above the display
  floor (ref >= 0), RMS error <= 1e-6 and max error <= 1e-4.  Below it
  p -> 0 and log10 amplifies the same rounding without bound; such voxels
  display black.  bfloat16 stores: the max bound plus one bf16 rounding
  step (2^-7 * |ref|).
The bounds separate the rungs: the "highest" operator parts run through the
3-pass math, or the 3-pass math without its x_lo term, fail them
(``test_gates_separate_the_rungs``, ``test_prep_bound_separates_the_rungs``).

The JAX package is imported inside a fixture, so the CUDA tests of this
file also run where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py
"""

import ctypes
import dataclasses
import importlib

import numpy as np
import pytest
import torch

from octproz_tpu_torch import curves as tcurves
from octproz_tpu_torch.kernels import fused_prep as tfp
from octproz_tpu_torch.params import AcqParams, default_full_config

N = 256
PLANAR_RTOL = 1e-5
RUNGS = ["default", "high", "highest"]


@pytest.fixture(scope="module")
def jfp():
    """The JAX package's fused_prep module (the pallas package's __init__
    re-exports a function of the same name, hence import_module)."""
    return importlib.import_module("octproz_tpu.pallas.fused_prep")


@pytest.fixture
def np_rng():
    return np.random.default_rng(4321)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the fold and prep kernels are CUDA C++ "
                    "for sm_90a and have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in true float32
    return torch.device("cuda", 0)


def _operators(n=N):
    """The folded depth operator of the benchmark chain at line length n."""
    acq = AcqParams(samples_per_line=n, ascans_per_bscan=8, bscans_per_buffer=1)
    cfg = dataclasses.replace(default_full_config(), bitshift=True)
    cv = tcurves.make_curves(acq, cfg, resample_coeffs=(0.0, n - 1.0, 10.0, -4.0),
                             dispersion_coeffs=(0.0, 0.0, 8.0, 0.0), device="cpu")
    return cv.depth_op_re.numpy(), cv.depth_op_im.numpy()


def _raw(rng, lines, n=N, dtype=np.uint16):
    hi = 256 if dtype == np.uint8 else 4096
    return rng.integers(0, hi, size=(lines, n)).astype(dtype)


def _planar_close(got, want):
    got = [g.cpu().numpy() if isinstance(g, torch.Tensor) else g for g in got]
    scale = max(np.abs(w).max() for w in want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        assert np.abs(g - w).max() <= PLANAR_RTOL * scale
    err = tfp.planar_error([torch.from_numpy(g) for g in got],
                           [torch.from_numpy(np.array(w)) for w in want])
    assert err <= tfp.PLANAR_REL_L2, err


def _scale_close(got, want):
    """``got`` a tensor in its store dtype (bf16 gets the bf16 bound) or an
    array; ``want`` an array."""
    g = got.cpu() if isinstance(got, torch.Tensor) else torch.from_numpy(np.array(got))
    w = torch.from_numpy(np.array(want, np.float32))
    assert g.shape == w.shape
    rms, worst, ok = tfp.scale_error(g, w)
    assert ok, (rms, worst)


def _jax_depth(jfp, raw, wre, wim, precision, bitshift, bit_depth=12):
    import jax.numpy as jnp

    re, im = jfp._fused_depth_impl(
        jnp.asarray(raw), jnp.asarray(wre), jnp.asarray(wim), bit_depth=bit_depth,
        bitshift=bitshift, compute_dtype="float32", precision=precision,
        interpret=True)
    return np.asarray(re), np.asarray(im)


def _jax_scale(jfp, raw, wre, wim, mean2, precision, bitshift, *, log_scaling=True,
               fast_log=False, output_dtype="float32", bit_depth=12, fold_concat=False):
    import jax.numpy as jnp

    out = jfp._fused_depth_scale_impl(
        jnp.asarray(raw), jnp.asarray(wre), jnp.asarray(wim), jnp.asarray(mean2),
        bit_depth=bit_depth, bitshift=bitshift, compute_dtype="float32",
        precision=precision, log_scaling=log_scaling, gmin=0.0, gmax=60.0,
        addend=0.0, coeff=1.0, output_dtype=output_dtype, fast_log=fast_log,
        fold_concat=fold_concat, interpret=True)
    return np.asarray(out, np.float32)


def _parts(w, precision):
    return tfp._operator_parts(torch.from_numpy(w), precision)


# ---------------------------------------------------------------------------
# plain versions vs the Pallas kernels (CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precision", RUNGS)
@pytest.mark.parametrize("lines,bitshift", [(256, True), (105, False)])
def test_depth_plain_matches_pallas(jfp, np_rng, precision, lines, bitshift):
    """_kernel_depth (default) and _kernel_depth_split (high, highest)."""
    wre, wim = _operators()
    raw = _raw(np_rng, lines)
    got = tfp.fold_depth(torch.from_numpy(raw), _parts(wre, precision),
                         _parts(wim, precision), bitshift=bitshift)
    _planar_close(got, _jax_depth(jfp, raw, wre, wim, precision, bitshift))


def test_depth_plain_uint8_matches_pallas(jfp, np_rng):
    wre, wim = _operators()
    raw = _raw(np_rng, 64, dtype=np.uint8)
    got = tfp.fold_depth(torch.from_numpy(raw), _parts(wre, "high"),
                         _parts(wim, "high"), bitshift=False)
    _planar_close(got, _jax_depth(jfp, raw, wre, wim, "high", False, bit_depth=8))


SCALE_CASES = [
    # (precision, lines, log_scaling, fast_log, output_dtype)
    ("default", 256, True, False, "float32"),
    ("high", 256, True, False, "float32"),
    ("highest", 256, True, False, "float32"),
    ("default", 256, True, True, "float32"),
    ("default", 256, False, False, "float32"),
    ("default", 256, True, False, "bfloat16"),
    ("high", 256, True, False, "bfloat16"),
    ("high", 105, True, False, "float32"),
    ("default", 105, True, True, "bfloat16"),
]


@pytest.mark.parametrize("precision,lines,log_scaling,fast_log,output_dtype", SCALE_CASES)
def test_depth_scale_plain_matches_pallas(jfp, np_rng, precision, lines, log_scaling,
                                          fast_log, output_dtype):
    """_kernel_depth_scale (default) and _kernel_depth_scale_split (high,
    highest): FPN mean subtraction, log/lin/fast-log epilogue, f32/bf16 store."""
    wre, wim = _operators()
    raw = _raw(np_rng, lines)
    mean2 = np_rng.normal(0, 50.0, size=(2, N // 2)).astype(np.float32)
    a, b = tfp._scale_affine(log_scaling, N // 2, 0.0, 60.0, 0.0, 1.0)
    odt = torch.bfloat16 if output_dtype == "bfloat16" else torch.float32
    got = tfp.fold_depth_scale(torch.from_numpy(raw), _parts(wre, precision),
                               _parts(wim, precision), torch.from_numpy(mean2),
                               bitshift=True, log_scaling=log_scaling, a=a, b=b,
                               fast_log=fast_log, out_dtype=odt)
    assert got.dtype == odt
    want = _jax_scale(jfp, raw, wre, wim, mean2, precision, True, log_scaling=log_scaling,
                      fast_log=fast_log, output_dtype=output_dtype)
    _scale_close(got, want)


@pytest.mark.parametrize("precision", ["high", "highest"])
def test_depth_scale_plain_low_bits_matches_pallas(jfp, np_rng, precision):
    """12-bit samples without the bitshift exceed bf16's 8 bits, so the
    split rungs' x_lo terms are nonzero; float32 store."""
    wre, wim = _operators()
    raw = _raw(np_rng, 256)
    mean2 = np_rng.normal(0, 50.0, size=(2, N // 2)).astype(np.float32)
    a, b = tfp._scale_affine(True, N // 2, 0.0, 60.0, 0.0, 1.0)
    got = tfp.fold_depth_scale(torch.from_numpy(raw), _parts(wre, precision),
                               _parts(wim, precision), torch.from_numpy(mean2),
                               bitshift=False, log_scaling=True, a=a, b=b)
    _scale_close(got, _jax_scale(jfp, raw, wre, wim, mean2, precision, False))


def test_gates_separate_the_rungs(np_rng):
    """The agreement bounds catch a kernel that computes a neighbouring
    rung: the "highest" parts through the 3-pass math, and the 3-pass math
    without its x_lo * w_0 term (x_hi in place of x), both fail."""
    wre, wim = _operators()
    x = torch.from_numpy(_raw(np_rng, 256).astype(np.float32))
    mean2 = torch.from_numpy(np_rng.normal(0, 50.0, size=(2, N // 2)).astype(np.float32))
    a, b = tfp._scale_affine(True, N // 2, 0.0, 60.0, 0.0, 1.0)
    kw = dict(bitshift=False, log_scaling=True, a=a, b=b)
    p5 = (_parts(wre, "highest"), _parts(wim, "highest"))
    p3 = (_parts(wre, "high"), _parts(wim, "high"))
    x_hi = tfp._bf16_trunc(x)
    for (xa, wa), (xb, wb) in [((x, [p[:2] for p in p5]), (x, p5)), ((x_hi, p3), (x, p3))]:
        err = tfp.planar_error(tfp.depth_plain(xa, *wa, bitshift=False),
                               tfp.depth_plain(xb, *wb, bitshift=False))
        assert err > 2 * tfp.PLANAR_REL_L2, err
        rms, _, ok = tfp.scale_error(tfp.depth_scale_plain(xa, *wa, mean2, **kw),
                                     tfp.depth_scale_plain(xb, *wb, mean2, **kw))
        assert not ok and rms > 2 * tfp.SCALE_RMS, rms


@pytest.mark.parametrize("precision", RUNGS)
def test_wrappers_take_parts_split_once(np_rng, precision):
    """Curves.depth_parts (split once by make_curves) give the output of
    the float32 operators split per call; a part count that does not match
    the rung is refused."""
    acq, cfg, _, _ = _acq_cfg(matmul_precision=precision)
    wre, wim = (torch.from_numpy(w) for w in _operators())
    parts = (tfp._operator_parts(wre, precision), tfp._operator_parts(wim, precision))
    raw = torch.from_numpy(np_rng.integers(0, 4096, size=acq.buffer_shape).astype(np.uint16))
    mean2 = torch.from_numpy(np_rng.normal(0, 50.0, size=(2, N // 2)).astype(np.float32))
    assert torch.equal(tfp.fused_depth_scale(raw, *parts, mean2, acq, cfg),
                       tfp.fused_depth_scale(raw, wre, wim, mean2, acq, cfg))
    for got, want in zip(tfp.fused_depth_transform(raw, *parts, acq, cfg),
                         tfp.fused_depth_transform(raw, wre, wim, acq, cfg)):
        assert torch.equal(got, want)
    other = "high" if precision == "default" else "default"
    wrong = (tfp._operator_parts(wre, other), tfp._operator_parts(wim, other))
    with pytest.raises(ValueError, match="operator part"):
        tfp.fused_depth_scale(raw, *wrong, mean2, acq, cfg)


def _acq_cfg(**changes):
    import octproz_tpu.params as jparams

    acq = AcqParams(samples_per_line=N, ascans_per_bscan=32, bscans_per_buffer=4)
    cfg = dataclasses.replace(default_full_config(), bitshift=True, **changes)
    jacq = jparams.AcqParams(samples_per_line=N, ascans_per_bscan=32, bscans_per_buffer=4)
    jcfg = dataclasses.replace(jparams.default_full_config(), bitshift=True, **changes)
    return acq, cfg, jacq, jcfg


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("precision", RUNGS)
def test_fused_depth_transform_wrapper_matches(jfp, np_rng, backend, precision):
    """The public wrapper on a (bscans, ascans, samples) buffer, both fold
    backends: the port's "xla" route is plain torch, like JAX's jnp route."""
    import jax.numpy as jnp

    acq, cfg, jacq, jcfg = _acq_cfg(fold_backend=backend, matmul_precision=precision)
    wre, wim = _operators()
    raw = np_rng.integers(0, 4096, size=acq.buffer_shape).astype(np.uint16)
    got = tfp.fused_depth_transform(torch.from_numpy(raw), torch.from_numpy(wre),
                                    torch.from_numpy(wim), acq, cfg)
    want = jfp.fused_depth_transform(jnp.asarray(raw), jnp.asarray(wre), jnp.asarray(wim),
                                     jacq, jcfg, interpret=True)
    assert got[0].shape == (4, 32, N // 2)
    _planar_close(got, [np.asarray(w) for w in want])


@pytest.mark.parametrize("precision", RUNGS)
def test_fused_depth_scale_wrapper_on_a_stack(jfp, np_rng, precision):
    """The public wrapper on a (k, bscans, ascans, samples) stack (the batch
    strategy's call)."""
    import jax.numpy as jnp

    acq, cfg, jacq, jcfg = _acq_cfg(matmul_precision=precision)
    wre, wim = _operators()
    raw = np_rng.integers(0, 4096, size=(2, *acq.buffer_shape)).astype(np.uint16)
    mean2 = np_rng.normal(0, 50.0, size=(2, N // 2)).astype(np.float32)
    got = tfp.fused_depth_scale(torch.from_numpy(raw), torch.from_numpy(wre),
                                torch.from_numpy(wim), torch.from_numpy(mean2), acq, cfg)
    want = jfp.fused_depth_scale(jnp.asarray(raw), jnp.asarray(wre), jnp.asarray(wim),
                                 jnp.asarray(mean2), jacq, jcfg, interpret=True)
    assert tuple(got.shape) == (2, 4, 32, N // 2)
    _scale_close(got, np.asarray(want))


def test_fold_k_split_leaves_output_unchanged(np_rng):
    """fold_k_split was a TPU overlap knob: accepted, output identical."""
    acq, cfg, _, _ = _acq_cfg()
    wre, wim = (torch.from_numpy(w) for w in _operators())
    raw = torch.from_numpy(np_rng.integers(0, 4096, size=acq.buffer_shape).astype(np.uint16))
    mean2 = torch.zeros((2, N // 2))
    base = tfp.fused_depth_scale(raw, wre, wim, mean2, acq, cfg)
    for k in (2, 4):
        cfg_k = dataclasses.replace(cfg, fold_k_split=k, pallas_tile=64)
        assert torch.equal(tfp.fused_depth_scale(raw, wre, wim, mean2, acq, cfg_k), base)


def test_wrappers_refuse_unported_configs(np_rng):
    """compute_dtype="bfloat16" was refused until it was ported: both fold
    wrappers now run it -- the bf16 plain versions on the operators rounded
    to one bf16 part, distinct from the float32 rung -- and only a missing
    operator is refused."""
    acq, cfg, _, _ = _acq_cfg()
    bf16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    wre, wim = (torch.from_numpy(w) for w in _operators())
    raw = torch.from_numpy(np_rng.integers(0, 4096, size=acq.buffer_shape).astype(np.uint16))
    raw2d = raw.reshape(-1, N)
    parts = (tfp._operator_parts(wre, tfp.BF16), tfp._operator_parts(wim, tfp.BF16))
    mean2 = torch.zeros(2, N // 2)
    a, b = tfp._scale_affine(True, N // 2, cfg.grayscale_min, cfg.grayscale_max, cfg.addend,
                             cfg.multiplicator)
    got = tfp.fused_depth_scale(raw, wre, wim, mean2, acq, bf16)
    want = tfp.depth_scale_plain(raw2d, *parts, mean2, bitshift=True, log_scaling=True,
                                 a=a, b=b)
    assert torch.equal(got.reshape(want.shape), want)
    assert not torch.equal(got, tfp.fused_depth_scale(raw, wre, wim, mean2, acq, cfg))
    for g, w in zip(tfp.fused_depth_transform(raw, wre, wim, acq, bf16),
                    tfp.depth_plain(raw2d, *parts, bitshift=True)):
        assert torch.equal(g.reshape(w.shape), w)
    with pytest.raises(ValueError, match="depth_op"):
        tfp.fused_depth_transform(raw, None, wim, acq, cfg)


def test_no_plain_route_for_other_devices():
    """Only a CPU tensor takes the plain version; any other device either
    launches the CUDA kernel or raises -- here the meta device raises."""
    raw = torch.empty((8, N), dtype=torch.uint16, device="meta")
    w = torch.empty((N, N // 2), device="meta")
    with pytest.raises(RuntimeError, match="no fold kernel"):
        tfp.fold_depth(raw, (w,), (w,), bitshift=True)
    with pytest.raises(RuntimeError, match="no fold kernel"):
        tfp.fold_depth_scale(raw, (w,), (w,), torch.empty((2, N // 2), device="meta"),
                             bitshift=True, log_scaling=True, a=1.0, b=0.0)


def test_launch_checks_reject_what_the_kernel_does_not_take():
    """The launch checks (device, dtype, shape, contiguity) before any
    pointer reaches the kernel."""
    raw = torch.zeros((8, N), dtype=torch.uint16)
    w = torch.zeros((N, N // 2))
    assert tfp._check_launch(raw, (w,), (w,)) == (8, N, N // 2)
    with pytest.raises(TypeError):
        tfp._check_launch(raw.to(torch.int16), (w,), (w,))
    with pytest.raises(ValueError):
        tfp._check_launch(raw.t(), (w,), (w,))
    with pytest.raises(ValueError):  # split parts must be bf16
        tfp._check_launch(raw, (w, w), (w, w))
    with pytest.raises(ValueError):
        tfp._check_launch(raw, (w[:, :10],), (w,))
    with pytest.raises(ValueError):
        tfp._check_launch(raw, (w,), (w,), torch.zeros((2, 3)))


# ---------------------------------------------------------------------------
# The concat fold kernels (fold_concat): plain versions vs the Pallas kernels
# ---------------------------------------------------------------------------

def _wide(wre, wim, precision):
    """The concatenated operator's parts as the concat kernels take them."""
    return tfp.concat_operator(torch.from_numpy(wre), torch.from_numpy(wim), precision)


CONCAT_CASES = [
    # (precision, lines, bitshift, log_scaling, output_dtype)
    ("default", 256, True, True, "float32"),
    ("high", 256, True, True, "float32"),
    ("highest", 256, True, True, "float32"),
    ("default", 256, True, False, "float32"),
    ("high", 256, True, False, "float32"),
    ("highest", 256, True, False, "float32"),
    ("default", 256, True, True, "bfloat16"),
    ("high", 256, True, True, "bfloat16"),
    ("highest", 256, True, False, "bfloat16"),
    ("high", 105, False, True, "float32"),
    ("highest", 105, False, True, "float32"),
]


@pytest.mark.parametrize("precision,lines,bitshift,log_scaling,output_dtype", CONCAT_CASES)
def test_depth_scale_concat_plain_matches_pallas(jfp, np_rng, precision, lines, bitshift,
                                                 log_scaling, output_dtype):
    """_kernel_depth_scale_concat (default) and
    _kernel_depth_scale_concat_split (high, highest): one GEMM against the
    wide operator, log/lin epilogue, f32/bf16 store; unshifted 12-bit
    samples make the split rungs' x_lo terms nonzero, 105 lines is odd."""
    wre, wim = _operators()
    raw = _raw(np_rng, lines)
    mean2 = np_rng.normal(0, 50.0, size=(2, N // 2)).astype(np.float32)
    a, b = tfp._scale_affine(log_scaling, N // 2, 0.0, 60.0, 0.0, 1.0)
    odt = torch.bfloat16 if output_dtype == "bfloat16" else torch.float32
    got = tfp.fold_depth_scale_concat(torch.from_numpy(raw), _wide(wre, wim, precision),
                                      torch.from_numpy(mean2), bitshift=bitshift,
                                      log_scaling=log_scaling, a=a, b=b, out_dtype=odt)
    assert got.dtype == odt and tuple(got.shape) == (lines, N // 2)
    want = _jax_scale(jfp, raw, wre, wim, mean2, precision, bitshift,
                      log_scaling=log_scaling, output_dtype=output_dtype, fold_concat=True)
    _scale_close(got, want)


@pytest.mark.parametrize("precision", RUNGS)
def test_split_commutes_with_concatenation(precision):
    """_split_bf16 is elementwise, so the parts of [W_re | W_im] are the
    concatenations of the parts of each half -- exactly; and the concat
    wrapper reaches the same parts from the float32 operators and from
    parts split per axis (Curves.depth_parts)."""
    wre, wim = (torch.from_numpy(w) for w in _operators())
    wide = tfp._operator_parts(torch.cat([wre, wim], dim=1), precision)
    per_axis = (tfp._operator_parts(wre, precision), tfp._operator_parts(wim, precision))
    for w, r, i in zip(wide, *per_axis):
        assert torch.equal(w, torch.cat([r, i], dim=1))
    for got in (tfp.concat_operator(wre, wim, precision),
                tfp.concat_operator(*per_axis, precision)):
        assert len(got) == len(wide) and all(torch.equal(g, w) for g, w in zip(got, wide))


@pytest.mark.parametrize("precision", RUNGS)
def test_concat_equals_two_operator_kernel(np_rng, precision):
    """The concat kernels compute the terms of the two-operator kernels:
    within the scale bounds of the same input on every rung."""
    wre, wim = _operators()
    x = torch.from_numpy(_raw(np_rng, 256))
    mean2 = torch.from_numpy(np_rng.normal(0, 50.0, size=(2, N // 2)).astype(np.float32))
    a, b = tfp._scale_affine(True, N // 2, 0.0, 60.0, 0.0, 1.0)
    kw = dict(bitshift=True, log_scaling=True, a=a, b=b)
    got = tfp.depth_scale_concat_plain(x, _wide(wre, wim, precision), mean2, **kw)
    want = tfp.depth_scale_plain(x, _parts(wre, precision), _parts(wim, precision), mean2,
                                 **kw)
    assert tfp.scale_error(got, want)[2]


def test_concat_gates_separate_the_rungs_and_columns(np_rng):
    """Controls for the concat kernels: the "highest" wide parts through the
    3-pass math, the 3-pass math without x_lo, and a wide operator whose im
    half is read one column early (the im column of bin j at half - 1 + j)
    all fail the scale bounds.  Swapping re and im would not: p is
    symmetric in them."""
    wre, wim = _operators()
    x = torch.from_numpy(_raw(np_rng, 256).astype(np.float32))
    mean2 = torch.from_numpy(np_rng.normal(0, 50.0, size=(2, N // 2)).astype(np.float32))
    a, b = tfp._scale_affine(True, N // 2, 0.0, 60.0, 0.0, 1.0)
    kw = dict(bitshift=False, log_scaling=True, a=a, b=b)
    p5, p3 = _wide(wre, wim, "highest"), _wide(wre, wim, "high")
    (w1,) = _wide(wre, wim, "default")
    shifted = torch.cat([w1[:, :N // 2 + 1], w1[:, N // 2:-1]], dim=1).contiguous()
    swapped = torch.cat([w1[:, N // 2:], w1[:, :N // 2]], dim=1).contiguous()
    mean_swapped = mean2.flip(0).contiguous()
    for (xa, wa), (xb, wb) in [((x, p5[:2]), (x, p5)),
                               ((tfp._bf16_trunc(x), p3), (x, p3)),
                               ((x, (shifted,)), (x, (w1,)))]:
        rms, _, ok = tfp.scale_error(tfp.depth_scale_concat_plain(xa, wa, mean2, **kw),
                                     tfp.depth_scale_concat_plain(xb, wb, mean2, **kw))
        assert not ok and rms > 2 * tfp.SCALE_RMS, rms
    assert torch.equal(tfp.depth_scale_concat_plain(x, (swapped,), mean_swapped, **kw),
                       tfp.depth_scale_concat_plain(x, (w1,), mean2, **kw))


@pytest.mark.parametrize("precision", RUNGS)
@pytest.mark.parametrize("stack", [False, True])
def test_fused_depth_scale_concat_wrapper_matches(jfp, np_rng, precision, stack):
    """The public wrapper with fold_concat on a buffer and on a stack (the
    batch strategy's call) against JAX's; the parts split once per axis
    (Curves.depth_parts) and the float32 operators give the same output."""
    import jax.numpy as jnp

    acq, cfg, jacq, jcfg = _acq_cfg(matmul_precision=precision, fold_concat=True)
    cv = tcurves.make_curves(acq, cfg, resample_coeffs=(0.0, N - 1.0, 10.0, -4.0),
                             dispersion_coeffs=(0.0, 0.0, 8.0, 0.0), device="cpu")
    assert len(cv.depth_parts[0]) == tfp._SPLIT_PARTS.get(precision, 1)
    shape = ((2,) if stack else ()) + acq.buffer_shape
    raw = np_rng.integers(0, 4096, size=shape).astype(np.uint16)
    mean2 = np_rng.normal(0, 50.0, size=(2, N // 2)).astype(np.float32)
    t_raw, t_mean = torch.from_numpy(raw), torch.from_numpy(mean2)
    got = tfp.fused_depth_scale(t_raw, *cv.depth_parts, t_mean, acq, cfg)
    assert tuple(got.shape) == shape[:-1] + (N // 2,)
    assert torch.equal(tfp.fused_depth_scale(t_raw, cv.depth_op_re, cv.depth_op_im,
                                             t_mean, acq, cfg), got)
    want = jfp.fused_depth_scale(jnp.asarray(raw), jnp.asarray(cv.depth_op_re.numpy()),
                                 jnp.asarray(cv.depth_op_im.numpy()), jnp.asarray(mean2),
                                 jacq, jcfg, interpret=True)
    _scale_close(got, np.asarray(want))


def test_concat_launch_checks_reject_what_the_kernel_does_not_take():
    """The concat launch checks before any pointer reaches the kernel: an
    odd operator width, parts of other widths or types, a mean line that
    does not match half the width."""
    raw = torch.zeros((8, N), dtype=torch.uint16)
    w = torch.zeros((N, N))
    mean2 = torch.zeros((2, N // 2))
    assert tfp._check_concat_launch(raw, (w,), mean2) == (8, N, N // 2)
    with pytest.raises(ValueError, match="even"):
        tfp._check_concat_launch(raw, (w[:, :-1].contiguous(),), torch.zeros((2, 127)))
    with pytest.raises(ValueError):
        tfp._check_concat_launch(raw, (w, w), mean2)  # split parts must be bf16
    with pytest.raises(ValueError):
        tfp._check_concat_launch(raw, (w,), torch.zeros((2, N)))
    with pytest.raises(ValueError):
        tfp._check_concat_launch(raw, tuple(w.to(torch.bfloat16) for _ in range(4)), mean2)
    with pytest.raises(RuntimeError, match="no fold kernel"):
        tfp.fold_depth_scale_concat(raw.to("meta"), (w.to("meta"),), mean2.to("meta"),
                                    bitshift=True, log_scaling=True, a=1.0, b=0.0)


# ---------------------------------------------------------------------------
# CUDA kernels vs their plain versions (GPU only)
# ---------------------------------------------------------------------------

CUDA_CASES = [
    # (n_in, lines, input dtype, bitshift, passes, scale mode or None, out dtype)
    (256, 300, torch.uint16, True, 1, None, None),
    (256, 300, torch.uint16, True, 3, None, None),
    (256, 300, torch.uint16, True, 5, None, None),
    (256, 300, torch.uint16, False, 3, None, None),
    (256, 300, torch.uint16, False, 5, None, None),
    (1664, 70, torch.uint16, True, 3, None, None),
    (256, 300, torch.uint16, True, 1, "log", torch.float32),
    (256, 300, torch.uint16, True, 3, "log", torch.float32),
    (256, 300, torch.uint16, True, 5, "log", torch.float32),
    (256, 300, torch.uint16, False, 3, "log", torch.float32),
    (256, 300, torch.uint16, False, 5, "log", torch.float32),
    (256, 300, torch.uint16, True, 1, "fast_log", torch.bfloat16),
    (256, 300, torch.uint8, False, 1, "lin", torch.float32),
    (1664, 70, torch.float32, False, 3, "log", torch.bfloat16),
    # the split kernels' ragged edges: 550 bins (not a multiple of the
    # 64-bin tile) and 300 lines (not a multiple of 128); uint8 input
    (1100, 300, torch.uint16, False, 3, None, None),
    (1100, 300, torch.uint16, True, 3, "log", torch.float32),
    (1100, 300, torch.uint16, False, 5, "lin", torch.float32),
    (256, 300, torch.uint8, False, 3, None, None),
    (256, 300, torch.uint8, False, 3, "log", torch.float32),
    # the one-pass rung on the tensor cores (integer lines: x_lo nonzero
    # unshifted, the ragged edges); float32 lines: the planar and the scaled
    # kernel with three x parts
    (256, 300, torch.uint16, False, 1, None, None),
    (256, 300, torch.uint16, False, 1, "log", torch.float32),
    (256, 300, torch.uint16, False, 1, "fast_log", torch.float32),
    (256, 300, torch.uint16, True, 1, "lin", torch.bfloat16),
    (256, 300, torch.uint8, False, 1, None, None),
    (1664, 70, torch.uint16, False, 1, None, None),
    (1100, 300, torch.uint16, False, 1, None, None),
    (1100, 300, torch.uint16, True, 1, "log", torch.float32),
    (256, 300, torch.float32, False, 1, None, None),
    (256, 300, torch.float32, False, 1, "log", torch.float32),
]


def _cuda_raw(rng, lines, n_in, in_dtype, device):
    if in_dtype == torch.float32:
        raw = rng.integers(0, 1 << 24, size=(lines, n_in)).astype(np.float32)
    else:
        raw = _raw(rng, lines, n_in, np.uint8 if in_dtype == torch.uint8 else np.uint16)
    return torch.from_numpy(raw).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("n_in,lines,in_dtype,bitshift,passes,mode,out_dtype", CUDA_CASES)
def test_cuda_kernel_matches_plain(cuda_device, np_rng, n_in, lines, in_dtype, bitshift,
                                   passes, mode, out_dtype):
    precision = {1: "default", 3: "high", 5: "highest"}[passes]
    wre, wim = (torch.from_numpy(w).to(cuda_device) for w in _operators(n_in))
    parts_re = tfp._operator_parts(wre, precision)
    parts_im = tfp._operator_parts(wim, precision)
    raw = _cuda_raw(np_rng, lines, n_in, in_dtype, cuda_device)
    before = dict(tfp.LAUNCHES)
    if mode is None:
        got = tfp.fold_depth(raw, parts_re, parts_im, bitshift=bitshift)
        want = tfp.depth_plain(raw, parts_re, parts_im, bitshift=bitshift)
        torch.cuda.synchronize()
        _planar_close([g.cpu() for g in got], [w.cpu().numpy() for w in want])
        family = "depth" if passes == 1 else "depth_split"
    else:
        mean2 = torch.from_numpy(np_rng.normal(0, 50.0, size=(2, n_in // 2))
                                 .astype(np.float32)).to(cuda_device)
        a, b = tfp._scale_affine(mode != "lin", n_in // 2, 0.0, 60.0, 0.0, 1.0)
        kw = dict(bitshift=bitshift, log_scaling=mode != "lin", a=a, b=b,
                  fast_log=mode == "fast_log", out_dtype=out_dtype)
        got = tfp.fold_depth_scale(raw, parts_re, parts_im, mean2, **kw)
        want = tfp.depth_scale_plain(raw, parts_re, parts_im, mean2, **kw)
        torch.cuda.synchronize()
        assert got.dtype == out_dtype
        _scale_close(got, want.float().cpu().numpy())
        family = "depth_scale" if passes == 1 else "depth_scale_split"
    assert tfp.LAUNCHES[family] == before[family] + 1


@pytest.mark.cuda
def test_cuda_one_pass_route_follows_the_input_type(cuda_device, np_rng):
    """At one pass uint8/uint16 lines run on the tensor cores, and float32
    lines on the tensor cores with three x parts, for the planar kernel
    (``depth``) and the scaled kernel (``depth_scale``) alike; each counts
    as its family; full 16-bit samples (x_lo in every stage; as float32
    lines x_mid, not x_lo) and 24-bit float32 lines (all three x parts)
    stay within the planar and the scale bounds (display floor 48 and 96
    dB, 20 log10 of the samples' range over 8-bit values)."""
    wre, wim = (tfp._operator_parts(torch.from_numpy(w).to(cuda_device), "default")
                for w in _operators())
    full = torch.from_numpy(np_rng.integers(0, 1 << 16, size=(300, N)).astype(np.uint16))
    wide = torch.from_numpy(np_rng.integers(0, 1 << 24, size=(300, N)).astype(np.float32))
    mean2 = torch.from_numpy(np_rng.normal(0, 50.0, size=(2, N // 2)).astype(np.float32))
    mean2 = mean2.to(cuda_device)
    for raw, floor_db in ((full.to(cuda_device), 48.0), (full.to(cuda_device).float(), 48.0),
                          (wide.to(cuda_device), 96.0)):
        tfp.reset_launch_counts()
        got = tfp.fold_depth(raw, wre, wim, bitshift=False)
        a, b = tfp._scale_affine(True, N // 2, floor_db, floor_db + 60.0, 0.0, 1.0)
        kw = dict(bitshift=False, log_scaling=True, a=a, b=b)
        mag = tfp.fold_depth_scale(raw, wre, wim, mean2, **kw)
        torch.cuda.synchronize()
        assert tfp.LAUNCHES["depth"] == tfp.LAUNCHES["depth_scale"] == 1
        assert tfp.LAUNCHES["depth_split"] == tfp.LAUNCHES["depth_scale_split"] == 0
        for family in ("depth", "depth_scale"):
            assert tfp.ONE_PASS_ROUTES[family] == {"tensor_core": 1, "tensor_core_bf16": 0}
        err = tfp.planar_error(got, tfp.depth_plain(raw, wre, wim, bitshift=False))
        assert err <= tfp.PLANAR_REL_L2, (raw.dtype, err)
        _scale_close(mag, tfp.depth_scale_plain(raw, wre, wim, mean2, **kw).cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [N, 1001])
def test_cuda_three_x_parts_match_plain(cuda_device, np_rng, n):
    """B2 and B7 at one pass on 24-bit float32 lines (the tensor cores with
    three x parts) against their plain versions on 299 lines: n = 256 reads
    the raw tile by TMA, n = 1001 (rows not 16-byte aligned) through the
    element-wise producer, which writes TMA's swizzled layout; display
    floor 96 dB (20 log10 of 2^24 over 2^8)."""
    raw = torch.from_numpy(np_rng.integers(0, 1 << 24, size=(299, n)).astype(np.float32))
    raw = raw.to(cuda_device)
    wre, wim = (tfp._operator_parts(torch.from_numpy(w).to(cuda_device), "default")
                for w in _operators(n))
    half = wre[0].shape[1]
    mean2 = torch.from_numpy(np_rng.normal(0, 50.0, size=(2, half)).astype(np.float32))
    a, b = tfp._scale_affine(True, half, 96.0, 156.0, 0.0, 1.0)
    kw = dict(bitshift=False, log_scaling=True, a=a, b=b)
    tfp.reset_launch_counts()
    got = tfp.fold_depth_scale(raw, wre, wim, mean2.to(cuda_device), **kw)
    op, phase = _prep_operator(n, background_removal=True)
    one = tfp._operator_parts(torch.from_numpy(op).to(cuda_device), "default")
    rows = tuple(r.to(cuda_device) for r in _rows(phase))
    spectra = tfp.prep_phase(raw, one, *rows, bitshift=False)
    torch.cuda.synchronize()
    assert tfp.ONE_PASS_ROUTES["depth_scale"]["tensor_core"] == 1
    assert tfp.ONE_PASS_ROUTES["prep_phase"]["tensor_core"] == 1
    _scale_close(got, tfp.depth_scale_plain(raw, wre, wim, mean2.to(cuda_device), **kw)
                 .cpu().numpy())
    _prep_close(spectra, tfp.prep_phase_plain(raw, one, *rows, bitshift=False).cpu().numpy())


#: (n_in, lines, bits) of B5 and B8 on float32 lines: n_in 1000 gives half =
#: 500 (the concat kernel's im views not 16-byte aligned: the element-wise
#: producer), 1001 rows not 16-byte aligned (the element-wise producer for
#: both), 999 a partial 128-line tile, 131073 lines one more than a buffer.
F32_CONCAT_REAL_CASES = [(256, 299, 24), (256, 299, 32), (1000, 999, 24), (1000, 299, 32),
                         (1001, 999, 24), (1001, 299, 32), (1024, 131073, 24)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,lines,bits", F32_CONCAT_REAL_CASES)
def test_cuda_concat_and_real_three_x_parts_match_plain(cuda_device, np_rng, n, lines, bits):
    """B5 and B8 at one pass on float32 lines of 24- and 32-bit samples (the
    tensor cores with three x parts) against their plain versions, the
    route read back: log scaling over the 60 dB from the samples' display
    floor (96 / 144 dB, 20 log10 of their range over 8-bit values), the
    real spectra with background removal in the operator."""
    raw = torch.from_numpy(np_rng.integers(0, 1 << bits, size=(lines, n), dtype=np.int64)
                           .astype(np.float32)).to(cuda_device)
    wre, wim = (torch.from_numpy(w).to(cuda_device) for w in _operators(n))
    wide = tfp.concat_operator(wre, wim, "default")
    half = n // 2
    mean2 = torch.from_numpy(np_rng.normal(0, 50.0, size=(2, half)).astype(np.float32))
    floor = 20.0 * np.log10(2.0 ** (bits - 8))
    a, b = tfp._scale_affine(True, half, floor, floor + 60.0, 0.0, 1.0)
    kw = dict(bitshift=False, log_scaling=True, a=a, b=b)
    op, _ = _prep_operator(n, background_removal=True)
    one = tfp._operator_parts(torch.from_numpy(op).to(cuda_device), "default")
    tfp.reset_launch_counts()
    got = tfp.fold_depth_scale_concat(raw, wide, mean2.to(cuda_device), **kw)
    spectra = tfp.prep_real(raw, one, bitshift=False)
    torch.cuda.synchronize()
    for family in ("depth_scale_concat", "prep_real"):
        assert tfp.ONE_PASS_ROUTES[family] == \
            {"tensor_core": 1, "tensor_core_bf16": 0}
    _scale_close(got, tfp.depth_scale_concat_plain(raw, wide, mean2.to(cuda_device), **kw)
                 .cpu().numpy())
    _prep_close(spectra, tfp.prep_real_plain(raw, one, bitshift=False).cpu().numpy())


#: (n_in, lines, bits) of B1 on float32 lines: 16 bits (values with no x_lo,
#: the vote skips its group), 24 and 32; n_in 1000 gives half = 500, an
#: operator row pitch TMA cannot describe, and 1001 rows that are not
#: 16-byte aligned (the element-wise producer both); 999 lines a partial
#: 128-line tile, 131073 one more than a buffer.
F32_PLANAR_CASES = [(256, 299, 16), (256, 299, 24), (256, 299, 32), (1000, 999, 24),
                    (1000, 299, 32), (1001, 999, 24), (1001, 299, 32), (1024, 999, 16),
                    (1664, 999, 24), (2048, 999, 32), (4096, 999, 24), (1024, 131073, 24)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,lines,bits", F32_PLANAR_CASES)
def test_cuda_planar_three_x_parts_match_plain(cuda_device, np_rng, n, lines, bits):
    """B1 at one pass on float32 lines of 16-, 24- and 32-bit samples (the
    tensor cores with three x parts) against its plain version within the
    planar bound, the route read back."""
    raw = torch.from_numpy(np_rng.integers(0, 1 << bits, size=(lines, n), dtype=np.int64)
                           .astype(np.float32)).to(cuda_device)
    wre, wim = (tfp._operator_parts(torch.from_numpy(w).to(cuda_device), "default")
                for w in _operators(n))
    tfp.reset_launch_counts()
    got = tfp.fold_depth(raw, wre, wim, bitshift=False)
    torch.cuda.synchronize()
    assert tfp.ONE_PASS_ROUTES["depth"] == {"tensor_core": 1, "tensor_core_bf16": 0}
    err = tfp.planar_error(got, tfp.depth_plain(raw, wre, wim, bitshift=False))
    assert err <= tfp.PLANAR_REL_L2, err


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["depth_scale_concat", "prep_real", "depth"])
def test_cuda_three_x_parts_without_x_lo_fail(cuda_device, np_rng, family):
    """Control: B5, B8 and B1 fed 24-bit float32 lines cut to x_hi + x_mid
    (what the three-x-part kernel sums without x_lo w_0) fail the bounds
    against the float32 product of the whole lines."""
    raw = torch.from_numpy(np_rng.integers(0, 1 << 24, size=(300, N), dtype=np.int64)
                           .astype(np.float32)).to(cuda_device)
    hi = tfp._bf16_trunc(raw)
    cut = hi + tfp._bf16_trunc(raw - hi)
    if family == "depth":
        wre, wim = (tfp._operator_parts(torch.from_numpy(w).to(cuda_device), "default")
                    for w in _operators())
        assert tfp.planar_error(tfp.fold_depth(cut, wre, wim, bitshift=False),
                                tfp.depth_plain(raw, wre, wim, bitshift=False)) \
            > 2 * tfp.PLANAR_REL_L2
        return
    if family == "prep_real":
        op, _ = _prep_operator(background_removal=True)
        one = tfp._operator_parts(torch.from_numpy(op).to(cuda_device), "default")
        assert tfp.prep_error(tfp.prep_real(cut, one, bitshift=False),
                              tfp.prep_real_plain(raw, one, bitshift=False)) \
            > 2 * tfp.PREP_REL_L2
        return
    wre, wim = (torch.from_numpy(w).to(cuda_device) for w in _operators())
    wide = tfp.concat_operator(wre, wim, "default")
    mean2 = torch.zeros((2, N // 2), device=cuda_device)
    a, b = tfp._scale_affine(True, N // 2, 96.0, 156.0, 0.0, 1.0)
    kw = dict(bitshift=False, log_scaling=True, a=a, b=b)
    got = tfp.fold_depth_scale_concat(cut, wide, mean2, **kw)
    assert not tfp.scale_error(got, tfp.depth_scale_concat_plain(raw, wide, mean2, **kw))[2]


@pytest.mark.cuda
def test_cuda_one_pass_launch_without_three_parts_is_refused(cuda_device):
    """On float32 lines at one pass the C entries of B1, B5 and B8 take the
    float32 operator's three bf16 parts only: a launch with the float32
    operator in their place is refused, not run on another kernel."""
    from octproz_tpu_torch.kernels import build

    lib = build.load()
    raw = torch.zeros((8, N), device=cuda_device)
    w = torch.zeros((N, N), device=cuda_device)
    mean2 = torch.zeros((2, N // 2), device=cuda_device)
    out = torch.empty((8, N), device=cuda_device)
    stream = torch.cuda.current_stream().cuda_stream
    rc = lib.prep_gemm_real(raw.data_ptr(), 2, 0, 1, w.data_ptr(), None, None,
                            out.data_ptr(), 8, N, N, stream)
    assert rc != 0
    rc = lib.fold_gemm_scale_concat(raw.data_ptr(), 2, 0, 1, w.data_ptr(), None, None,
                                    mean2.data_ptr(), out.data_ptr(), 0, 0,
                                    ctypes.c_float(1.0), ctypes.c_float(0.0), 8, N, N // 2,
                                    stream)
    assert rc != 0
    half = w[:, :N // 2].contiguous()
    rc = lib.fold_gemm_planar(raw.data_ptr(), 2, 0, 1, half.data_ptr(), None, None,
                              half.data_ptr(), None, None, out.data_ptr(), out.data_ptr(),
                              8, N, N // 2, stream)
    assert rc != 0


@pytest.mark.cuda
@pytest.mark.parametrize("control", ["two of the three parts", "no x_lo"])
def test_cuda_gates_catch_the_one_pass_neighbours(cuda_device, np_rng, control):
    """Controls: the one-pass kernel on the "high" parts (the third zeroed),
    or on x_hi alone, differs from the float32 product by more than the
    planar bound."""
    ops = [tfp._operator_parts(torch.from_numpy(w).to(cuda_device), "default")
           for w in _operators()]
    raw = _cuda_raw(np_rng, 300, N, torch.uint16, cuda_device)
    want = tfp.depth_plain(raw, *ops, bitshift=False)
    if control == "no x_lo":
        x_hi = tfp._bf16_trunc(raw.to(torch.float32)).to(torch.int16).view(torch.uint16)
        got = tfp.fold_depth(x_hi, *ops, bitshift=False)
    else:
        two = [tfp.OnePass(w[0], split=(*w.split[:2], torch.zeros_like(w.split[2])))
               for w in ops]
        got = tfp.fold_depth(raw, *two, bitshift=False)
    assert tfp.planar_error(got, want) > 2 * tfp.PLANAR_REL_L2


@pytest.mark.cuda
def test_cuda_gates_catch_the_3_pass_math(cuda_device, np_rng):
    """Control: the 3-pass kernel fed the "highest" parts differs from the
    5-pass plain version by more than the agreement bounds."""
    wre, wim = (torch.from_numpy(w).to(cuda_device) for w in _operators())
    p5 = (tfp._operator_parts(wre, "highest"), tfp._operator_parts(wim, "highest"))
    raw = _cuda_raw(np_rng, 300, N, torch.uint16, cuda_device)
    got = tfp.fold_depth(raw, p5[0][:2], p5[1][:2], bitshift=False)
    want = tfp.depth_plain(raw, *p5, bitshift=False)
    assert tfp.planar_error(got, want) > 2 * tfp.PLANAR_REL_L2


@pytest.mark.cuda
def test_cuda_wrapper_raises_instead_of_falling_back(cuda_device):
    """A CUDA tensor the kernel cannot take raises; it never runs the plain
    version."""
    raw = torch.zeros((8, N), dtype=torch.int16, device=cuda_device)
    w = torch.zeros((N, N // 2), device=cuda_device)
    with pytest.raises(TypeError):
        tfp.fold_depth(raw, (w,), (w,), bitshift=True)
    with pytest.raises(ValueError):
        tfp.fold_depth(raw.to(torch.uint8), (w.cpu(),), (w,), bitshift=True)


@pytest.mark.cuda
def test_cuda_model_matches_cpu_model(cuda_device):
    """FdOctModel end to end on the GPU (CUDA kernels) and on the CPU (plain
    versions): FPN buffer then steady buffers, the high rung."""
    from octproz_tpu_torch.models.fdoct import FdOctModel

    acq = AcqParams(samples_per_line=N, ascans_per_bscan=32, bscans_per_buffer=8)
    cfg = dataclasses.replace(default_full_config(), bitshift=True, bscans_for_noise=2,
                              matmul_precision="high")
    rng = np.random.default_rng(13)
    raws = [rng.integers(0, 4096, size=acq.buffer_shape).astype(np.uint16) for _ in range(3)]
    kw = dict(resample_coeffs=(0.0, N - 1.0, 10.0, -4.0),
              dispersion_coeffs=(0.0, 0.0, 8.0, 0.0))
    gpu = FdOctModel(acq, cfg, **kw, device=cuda_device)
    cpu = FdOctModel(acq, cfg, **kw, device="cpu")
    before = dict(tfp.LAUNCHES)
    for raw in raws:
        _scale_close(gpu.fetch(gpu.process_buffer(raw)), cpu.fetch(cpu.process_buffer(raw)))
    assert tfp.LAUNCHES["depth_split"] == before["depth_split"] + 1
    assert tfp.LAUNCHES["depth_scale_split"] == before["depth_scale_split"] + 2


# ---------------------------------------------------------------------------
# The prep kernels (FFT path): plain versions vs the Pallas kernels (CPU)
# ---------------------------------------------------------------------------

def _prep_operator(n=N, background_removal=False):
    """The FFT path's prep operator (float32 numpy) and phasor (complex64)
    of the benchmark chain at line length n."""
    acq = AcqParams(samples_per_line=n, ascans_per_bscan=8, bscans_per_buffer=1)
    cfg = dataclasses.replace(default_full_config(), bitshift=True, fft_via_matmul=False,
                              use_pallas_prep=True, background_removal=background_removal)
    cv = tcurves.make_curves(acq, cfg, resample_coeffs=(0.0, n - 1.0, 10.0, -4.0),
                             dispersion_coeffs=(0.0, 0.0, 8.0, 0.0), device="cpu")
    return cv.prep_operator.numpy(), cv.phase.numpy()


def _rows(phase):
    return (torch.from_numpy(np.ascontiguousarray(phase.real)),
            torch.from_numpy(np.ascontiguousarray(phase.imag)))


def _prep_close(got, want):
    """``got`` a tensor, ``want`` an array; the prep bound plus an
    elementwise bound of 1e-5 * max|want|."""
    g = got.cpu()
    w = torch.from_numpy(np.array(want))
    assert g.dtype == w.dtype and g.shape == w.shape
    assert float((g - w).abs().max()) <= PLANAR_RTOL * float(w.abs().max())
    err = tfp.prep_error(g, w)
    assert err <= tfp.PREP_REL_L2, err


def _jax_prep(jfp, raw, op, phase, precision, bitshift, bit_depth=12):
    import jax.numpy as jnp

    rows = (None, None) if phase is None else (jnp.asarray(phase.real).reshape(1, -1),
                                               jnp.asarray(phase.imag).reshape(1, -1))
    out = jfp._fused_prep_impl(jnp.asarray(raw), jnp.asarray(op), *rows,
                               bit_depth=bit_depth, bitshift=bitshift,
                               precision=precision, interpret=True)
    return np.asarray(out)


@pytest.mark.parametrize("precision", RUNGS)
@pytest.mark.parametrize("epi", ["phase", "real"])
@pytest.mark.parametrize("lines,bitshift", [(256, True), (105, False)])
def test_prep_plain_matches_pallas(jfp, np_rng, precision, epi, lines, bitshift):
    """_kernel_phase / _kernel_real (default) and _kernel_phase_split /
    _kernel_real_split (high, highest); unshifted 12-bit samples make the
    split rungs' x_lo terms nonzero; 105 lines is an odd count."""
    op, phase = _prep_operator()
    raw = _raw(np_rng, lines)
    parts = _parts(op, precision)
    if epi == "phase":
        got = tfp.prep_phase(torch.from_numpy(raw), parts, *_rows(phase), bitshift=bitshift)
        assert got.dtype == torch.complex64
    else:
        got = tfp.prep_real(torch.from_numpy(raw), parts, bitshift=bitshift)
        assert got.dtype == torch.float32
    _prep_close(got, _jax_prep(jfp, raw, op, phase if epi == "phase" else None,
                               precision, bitshift))


@pytest.mark.parametrize("kind,precision", [("uint8", "default"), ("uint8", "high"),
                                            ("float32", "highest"), ("float32", "high")])
def test_prep_plain_input_types_match_pallas(jfp, np_rng, kind, precision):
    """uint8 samples, and float32 lines (a >16-bit source decoded before
    the kernel); the operator with background removal folded in (dense)."""
    op, phase = _prep_operator(background_removal=True)
    if kind == "uint8":
        raw, bit_depth = _raw(np_rng, 64, dtype=np.uint8), 8
    else:
        raw, bit_depth = np_rng.integers(0, 1 << 24, size=(64, N)).astype(np.float32), 24
    got = tfp.prep_phase(torch.from_numpy(raw), _parts(op, precision), *_rows(phase),
                         bitshift=False)
    _prep_close(got, _jax_prep(jfp, raw, op, phase, precision, False, bit_depth))


def test_prep_bound_separates_the_rungs(np_rng):
    """The prep bound catches a kernel that computes a neighbouring rung:
    the "highest" parts through the 3-pass math, and the 3-pass math
    without its x_lo terms, both fail it, phase and real."""
    op, phase = _prep_operator()
    x = torch.from_numpy(_raw(np_rng, 256).astype(np.float32))
    p5, p3 = _parts(op, "highest"), _parts(op, "high")
    x_hi = tfp._bf16_trunc(x)
    for (xa, wa), (xb, wb) in [((x, p5[:2]), (x, p5)), ((x_hi, p3), (x, p3))]:
        err = tfp.prep_error(tfp.prep_real_plain(xa, wa, bitshift=False),
                             tfp.prep_real_plain(xb, wb, bitshift=False))
        assert err > 2 * tfp.PREP_REL_L2, err
        err = tfp.prep_error(tfp.prep_phase_plain(xa, wa, *_rows(phase), bitshift=False),
                             tfp.prep_phase_plain(xb, wb, *_rows(phase), bitshift=False))
        assert err > 2 * tfp.PREP_REL_L2, err


@pytest.mark.parametrize("precision", RUNGS)
@pytest.mark.parametrize("dispersion", [True, False])
def test_fused_prep_wrapper_matches(jfp, np_rng, precision, dispersion):
    """The public wrapper on a (bscans, ascans, samples) buffer: complex64
    with the phasor, float32 without, as JAX's; the operator split once
    (``Curves.prep_parts``) gives the output of the float32 operator split
    per call; a part count that does not match the rung is refused."""
    import jax.numpy as jnp

    acq, cfg, jacq, jcfg = _acq_cfg(fft_via_matmul=False, use_pallas_prep=True,
                                    dispersion=dispersion, matmul_precision=precision)
    cv = tcurves.make_curves(acq, cfg, resample_coeffs=(0.0, N - 1.0, 10.0, -4.0),
                             dispersion_coeffs=(0.0, 0.0, 8.0, 0.0), device="cpu")
    raw = np_rng.integers(0, 4096, size=acq.buffer_shape).astype(np.uint16)
    phase = cv.phase if dispersion else None
    got = tfp.fused_prep(torch.from_numpy(raw), cv.prep_operator, phase, acq, cfg)
    assert tuple(got.shape) == (4, 32, N)
    assert got.dtype == (torch.complex64 if dispersion else torch.float32)
    assert torch.equal(tfp.fused_prep(torch.from_numpy(raw), cv.prep_parts, phase, acq, cfg),
                       got)
    want = jfp.fused_prep(jnp.asarray(raw), jnp.asarray(cv.prep_operator.numpy()),
                          None if phase is None else jnp.asarray(phase.numpy()),
                          jacq, jcfg, interpret=True)
    _prep_close(got, np.asarray(want))
    other = "high" if precision == "default" else "default"
    with pytest.raises(ValueError, match="operator part"):
        tfp.fused_prep(torch.from_numpy(raw), tfp._operator_parts(cv.prep_operator, other),
                       phase, acq, cfg)


def test_prep_wrapper_refusals():
    acq, cfg, _, _ = _acq_cfg(fft_via_matmul=False, use_pallas_prep=True)
    raw = torch.zeros(acq.buffer_shape, dtype=torch.uint16)
    with pytest.raises(ValueError, match="prep_operator"):
        tfp.fused_prep(raw, None, None, acq, cfg)
    # compute_dtype="bfloat16", once refused here, runs the real kernel's
    # bf16 plain version on the rounded operator
    op = torch.from_numpy(np.random.default_rng(2).normal(size=(N, N)).astype(np.float32))
    ramp = (torch.arange(raw.numel(), dtype=torch.int32) % 4096).to(torch.uint16)
    got = tfp.fused_prep(ramp.reshape(raw.shape), op, None, acq,
                         dataclasses.replace(cfg, compute_dtype="bfloat16"))
    want = tfp._dot_bf16(tfp._decode_block(ramp.reshape(-1, N), True), op)
    assert torch.equal(got.reshape(want.shape), want)
    meta = torch.empty((8, N), dtype=torch.uint16, device="meta")
    w = torch.empty((N, N), device="meta")
    with pytest.raises(RuntimeError, match="no prep kernel"):
        tfp.prep_real(meta, (w,), bitshift=True)
    with pytest.raises(RuntimeError, match="no prep kernel"):
        tfp.prep_phase(meta, (w,), w[0], w[0], bitshift=True)


def test_prep_launch_checks_reject_what_the_kernel_does_not_take():
    """The prep launch checks (device, dtype, shape, contiguity) before any
    pointer reaches the kernel; a phase launch needs both phasor rows."""
    raw = torch.zeros((8, N), dtype=torch.uint16)
    w = torch.zeros((N, N))
    row = torch.zeros(N)
    assert tfp._check_prep_launch(raw, (w,), row, row) == (8, N, N)
    with pytest.raises(TypeError):
        tfp._check_prep_launch(raw.to(torch.int16), (w,))
    with pytest.raises(ValueError):
        tfp._check_prep_launch(raw.t(), (w,))
    with pytest.raises(ValueError):  # split parts must be bf16
        tfp._check_prep_launch(raw, (w, w))
    with pytest.raises(ValueError):
        tfp._check_prep_launch(raw, (w[:, :10],))
    with pytest.raises(ValueError):
        tfp._check_prep_launch(raw, (w,), row[:10], row)
    with pytest.raises(ValueError):
        tfp._check_prep_launch(raw, tuple(w.to(torch.bfloat16) for _ in range(4)))
    with pytest.raises(ValueError, match="both"):
        tfp._launch_prep(raw, (w,), row, None, bitshift=True)


# ---------------------------------------------------------------------------
# The prep kernels on the GPU
# ---------------------------------------------------------------------------

PREP_CUDA_CASES = [
    # (n_in, lines, input dtype, bitshift, passes, "phase" or "real", background removal)
    (256, 300, torch.uint16, True, 1, "phase", False),
    (256, 300, torch.uint16, True, 3, "phase", False),
    (256, 300, torch.uint16, True, 5, "phase", False),
    (256, 300, torch.uint16, False, 3, "phase", True),
    (256, 300, torch.uint16, False, 5, "real", False),
    (256, 300, torch.uint16, True, 1, "real", False),
    (256, 300, torch.uint16, True, 3, "real", True),
    (1664, 70, torch.uint16, True, 1, "phase", False),
    (1100, 65, torch.uint8, False, 3, "real", False),
    (1100, 65, torch.float32, False, 5, "phase", True),
    # the split kernels' TMA path with a half-empty last 128-column tile
    (1088, 130, torch.uint16, False, 3, "phase", False),
    (1088, 130, torch.uint8, False, 3, "real", True),
    # the one pass on the tensor cores (x_lo terms; the element-wise
    # producer for 1100 uint8 samples, whose rows are not 16-byte aligned)
    (256, 300, torch.uint16, False, 1, "phase", True),
    (1088, 130, torch.uint16, False, 1, "phase", False),
    (256, 300, torch.uint16, False, 1, "real", True),
    (1088, 130, torch.uint16, False, 1, "real", False),
    (1100, 65, torch.uint8, False, 1, "real", False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("n_in,lines,in_dtype,bitshift,passes,epi,bg", PREP_CUDA_CASES)
def test_cuda_prep_kernel_matches_plain(cuda_device, np_rng, n_in, lines, in_dtype,
                                        bitshift, passes, epi, bg):
    precision = {1: "default", 3: "high", 5: "highest"}[passes]
    op, phase = _prep_operator(n_in, bg)
    parts = tfp._operator_parts(torch.from_numpy(op).to(cuda_device), precision)
    rows = tuple(r.to(cuda_device) for r in _rows(phase))
    raw = _cuda_raw(np_rng, lines, n_in, in_dtype, cuda_device)
    family = f"prep_{epi}" + ("_split" if passes > 1 else "")
    before = tfp.LAUNCHES[family]
    if epi == "phase":
        got = tfp.prep_phase(raw, parts, *rows, bitshift=bitshift)
        want = tfp.prep_phase_plain(raw, parts, *rows, bitshift=bitshift)
    else:
        got = tfp.prep_real(raw, parts, bitshift=bitshift)
        want = tfp.prep_real_plain(raw, parts, bitshift=bitshift)
    torch.cuda.synchronize()
    _prep_close(got, want.cpu().numpy())
    assert tfp.LAUNCHES[family] == before + 1


@pytest.mark.cuda
def test_cuda_prep_one_pass_route_follows_the_input_type(cuda_device, np_rng):
    """At one pass the prep kernels run on the tensor cores for uint16
    lines, and on float32 lines (16-bit and 24-bit values) there too with
    three x parts, counted as ``prep_phase`` / ``prep_real`` with their
    route."""
    op, phase = _prep_operator(background_removal=True)
    one = tfp._operator_parts(torch.from_numpy(op).to(cuda_device), "default")
    rows = tuple(r.to(cuda_device) for r in _rows(phase))
    full = torch.from_numpy(np_rng.integers(0, 1 << 16, size=(300, N)).astype(np.uint16))
    wide = torch.from_numpy(np_rng.integers(0, 1 << 24, size=(300, N)).astype(np.float32))
    for raw, route, real_route in ((full.to(cuda_device), "tensor_core", "tensor_core"),
                                   (full.to(cuda_device).float(), "tensor_core", "tensor_core"),
                                   (wide.to(cuda_device), "tensor_core", "tensor_core")):
        tfp.reset_launch_counts()
        got = tfp.prep_phase(raw, one, *rows, bitshift=False)
        real = tfp.prep_real(raw, one, bitshift=False)
        torch.cuda.synchronize()
        assert tfp.LAUNCHES["prep_phase"] == tfp.LAUNCHES["prep_real"] == 1
        assert tfp.ONE_PASS_ROUTES["prep_phase"] == {**{"tensor_core": 0, "tensor_core_bf16": 0}, route: 1}
        assert tfp.ONE_PASS_ROUTES["prep_real"] == \
            {**{"tensor_core": 0, "tensor_core_bf16": 0}, real_route: 1}
        err = tfp.prep_error(got, tfp.prep_phase_plain(raw, one, *rows, bitshift=False))
        assert err <= tfp.PREP_REL_L2, (route, err)
        assert tfp.prep_error(real, tfp.prep_real_plain(raw, one, bitshift=False)) \
            <= tfp.PREP_REL_L2


@pytest.mark.cuda
@pytest.mark.parametrize("control", ["two of the three parts", "no x_lo"])
def test_cuda_prep_bound_catches_the_one_pass_neighbours(cuda_device, np_rng, control):
    """Controls: the one-pass prep kernels on the "high" parts (the third
    zeroed), or on x_hi alone, differ from the float32 product by more than
    the prep bound, phase and real."""
    op, phase = _prep_operator()
    one = tfp._operator_parts(torch.from_numpy(op).to(cuda_device), "default")
    rows = tuple(r.to(cuda_device) for r in _rows(phase))
    raw = _cuda_raw(np_rng, 300, N, torch.uint16, cuda_device)
    if control == "no x_lo":
        x_in = tfp._bf16_trunc(raw.to(torch.float32)).to(torch.int16).view(torch.uint16)
        w_in = one
    else:
        x_in = raw
        w_in = tfp.OnePass(one[0], split=(*one.split[:2], torch.zeros_like(one.split[2])))
    got = tfp.prep_phase(x_in, w_in, *rows, bitshift=False)
    assert tfp.prep_error(got, tfp.prep_phase_plain(raw, one, *rows, bitshift=False)) \
        > 2 * tfp.PREP_REL_L2
    got = tfp.prep_real(x_in, w_in, bitshift=False)
    assert tfp.prep_error(got, tfp.prep_real_plain(raw, one, bitshift=False)) \
        > 2 * tfp.PREP_REL_L2


@pytest.mark.cuda
def test_cuda_prep_bound_catches_the_3_pass_math(cuda_device, np_rng):
    """Control: the 3-pass prep kernel fed the "highest" parts differs from
    the 5-pass plain version by more than the prep bound."""
    op, phase = _prep_operator()
    p5 = tfp._operator_parts(torch.from_numpy(op).to(cuda_device), "highest")
    raw = _cuda_raw(np_rng, 300, N, torch.uint16, cuda_device)
    got = tfp.prep_real(raw, p5[:2], bitshift=False)
    assert tfp.prep_error(got, tfp.prep_real_plain(raw, p5, bitshift=False)) \
        > 2 * tfp.PREP_REL_L2


@pytest.mark.cuda
def test_cuda_prep_wrapper_raises_instead_of_falling_back(cuda_device):
    raw = torch.zeros((8, N), dtype=torch.int16, device=cuda_device)
    w = torch.zeros((N, N), device=cuda_device)
    with pytest.raises(TypeError):
        tfp.prep_real(raw, (w,), bitshift=True)
    with pytest.raises(ValueError):
        tfp.prep_phase(raw.to(torch.uint8), (w,), w[0].cpu(), w[0], bitshift=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dispersion", [True, False])
def test_cuda_fft_model_matches_cpu_model(cuda_device, dispersion):
    """FdOctModel on the FFT path on the GPU (prep kernel, cuFFT) and on
    the CPU (plain version, pocketfft): FPN buffer then steady buffers, the
    high rung."""
    from octproz_tpu_torch.models.fdoct import FdOctModel

    acq = AcqParams(samples_per_line=N, ascans_per_bscan=32, bscans_per_buffer=8)
    cfg = dataclasses.replace(default_full_config(), bitshift=True, bscans_for_noise=2,
                              fft_via_matmul=False, use_pallas_prep=True,
                              dispersion=dispersion, matmul_precision="high")
    rng = np.random.default_rng(17)
    raws = [rng.integers(0, 4096, size=acq.buffer_shape).astype(np.uint16) for _ in range(3)]
    kw = dict(resample_coeffs=(0.0, N - 1.0, 10.0, -4.0),
              dispersion_coeffs=(0.0, 0.0, 8.0, 0.0))
    gpu = FdOctModel(acq, cfg, **kw, device=cuda_device)
    cpu = FdOctModel(acq, cfg, **kw, device="cpu")
    family = "prep_phase_split" if dispersion else "prep_real_split"
    before = tfp.LAUNCHES[family]
    for raw in raws:
        _scale_close(gpu.fetch(gpu.process_buffer(raw)), cpu.fetch(cpu.process_buffer(raw)))
    assert tfp.LAUNCHES[family] == before + 3


# ---------------------------------------------------------------------------
# The concat fold kernels on the GPU
# ---------------------------------------------------------------------------

CONCAT_CUDA_CASES = [
    # (n_in, lines, input dtype, bitshift, passes, log_scaling, out dtype)
    (256, 300, torch.uint16, True, 1, True, torch.float32),
    (256, 300, torch.uint16, True, 3, True, torch.float32),
    (256, 300, torch.uint16, True, 5, True, torch.float32),
    (256, 300, torch.uint16, False, 3, True, torch.float32),
    (256, 300, torch.uint16, False, 5, False, torch.float32),
    (256, 300, torch.uint16, True, 1, False, torch.bfloat16),
    (1664, 70, torch.uint8, False, 3, True, torch.float32),
    (1664, 70, torch.float32, False, 5, True, torch.bfloat16),
    # the split rung's views: 544 bins (a half-empty last 64-bin tile), and
    # 550 (the im view not 16-byte aligned: the element-wise producer)
    (1088, 130, torch.uint16, False, 3, True, torch.float32),
    (1100, 65, torch.uint16, True, 5, True, torch.float32),
    # the one pass on the tensor cores: x_lo terms, then the same two
    # shapes, each view three parts; float32 lines with three x parts, 1000
    # samples (half % 8 != 0) on the element-wise producer
    (256, 300, torch.uint16, False, 1, True, torch.float32),
    (1088, 130, torch.uint16, True, 1, True, torch.float32),
    (1100, 65, torch.uint16, True, 1, False, torch.float32),
    (1664, 70, torch.float32, False, 1, True, torch.float32),
    (1000, 130, torch.float32, False, 1, True, torch.float32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("n_in,lines,in_dtype,bitshift,passes,log_scaling,out_dtype",
                         CONCAT_CUDA_CASES)
def test_cuda_concat_kernel_matches_plain(cuda_device, np_rng, n_in, lines, in_dtype,
                                          bitshift, passes, log_scaling, out_dtype):
    precision = {1: "default", 3: "high", 5: "highest"}[passes]
    wre, wim = (torch.from_numpy(w).to(cuda_device) for w in _operators(n_in))
    wide = tfp.concat_operator(wre, wim, precision)
    raw = _cuda_raw(np_rng, lines, n_in, in_dtype, cuda_device)
    mean2 = torch.from_numpy(np_rng.normal(0, 50.0, size=(2, n_in // 2))
                             .astype(np.float32)).to(cuda_device)
    a, b = tfp._scale_affine(log_scaling, n_in // 2, 0.0, 60.0, 0.0, 1.0)
    kw = dict(bitshift=bitshift, log_scaling=log_scaling, a=a, b=b, out_dtype=out_dtype)
    family = "depth_scale_concat" + ("_split" if passes > 1 else "")
    before = tfp.LAUNCHES[family]
    got = tfp.fold_depth_scale_concat(raw, wide, mean2, **kw)
    want = tfp.depth_scale_concat_plain(raw, wide, mean2, **kw)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype
    _scale_close(got, want.float().cpu().numpy())
    assert tfp.LAUNCHES[family] == before + 1


def _concat_one_pass(cuda_device, raw, wide, floor_db):
    """The concat kernel and its plain version at one pass, log scaling
    over the 60 dB from ``floor_db``: (kernel, plain)."""
    mean2 = torch.zeros((2, N // 2), device=cuda_device)
    a, b = tfp._scale_affine(True, N // 2, floor_db, floor_db + 60.0, 0.0, 1.0)
    kw = dict(bitshift=False, log_scaling=True, a=a, b=b)
    return (tfp.fold_depth_scale_concat(raw, wide, mean2, **kw),
            tfp.depth_scale_concat_plain(raw, wide, mean2, **kw))


@pytest.mark.cuda
def test_cuda_concat_one_pass_route_follows_the_input_type(cuda_device, np_rng):
    """At one pass the concat kernel runs on the tensor cores for uint16
    lines (unshifted 12-bit: x_lo terms) and for float32 lines (three x
    parts), both counted as ``depth_scale_concat``, both within the scale
    bounds (display floor 24 dB, as for 12-bit samples in
    ``chip_smoke.py``)."""
    wre, wim = (torch.from_numpy(w).to(cuda_device) for w in _operators())
    wide = tfp.concat_operator(wre, wim, "default")
    raw = _cuda_raw(np_rng, 300, N, torch.uint16, cuda_device)
    for lines in (raw, raw.float()):
        tfp.reset_launch_counts()
        got, want = _concat_one_pass(cuda_device, lines, wide, 24.0)
        torch.cuda.synchronize()
        assert tfp.LAUNCHES["depth_scale_concat"] == 1
        assert tfp.ONE_PASS_ROUTES["depth_scale_concat"] == \
            {"tensor_core": 1, "tensor_core_bf16": 0}
        _scale_close(got, want.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("control", ["two of the three parts", "no x_lo"])
def test_cuda_concat_gates_catch_the_one_pass_neighbours(cuda_device, np_rng, control):
    """Controls: the one-pass concat kernel on the "high" parts of the wide
    operator (the third zeroed), or on x_hi alone, fails the scale bounds
    against the float32 product."""
    wre, wim = (torch.from_numpy(w).to(cuda_device) for w in _operators())
    wide = tfp.concat_operator(wre, wim, "default")
    raw = _cuda_raw(np_rng, 300, N, torch.uint16, cuda_device)
    if control == "no x_lo":
        x_hi = tfp._bf16_trunc(raw.to(torch.float32)).to(torch.int16).view(torch.uint16)
        got, _ = _concat_one_pass(cuda_device, x_hi, wide, 24.0)
    else:
        two = tfp.OnePass(wide[0], split=(*wide.split[:2], torch.zeros_like(wide.split[2])))
        got, _ = _concat_one_pass(cuda_device, raw, two, 24.0)
    _, want = _concat_one_pass(cuda_device, raw, wide, 24.0)
    assert not tfp.scale_error(got, want)[2]


@pytest.mark.cuda
def test_cuda_concat_bounds_catch_a_wrong_column(cuda_device, np_rng):
    """Control: the concat kernel fed a wide operator whose im half starts
    one column early disagrees with the plain version of the right one."""
    wre, wim = (torch.from_numpy(w).to(cuda_device) for w in _operators())
    (w1,) = tfp.concat_operator(wre, wim, "default")
    shifted = torch.cat([w1[:, :N // 2 + 1], w1[:, N // 2:-1]], dim=1).contiguous()
    raw = _cuda_raw(np_rng, 300, N, torch.uint16, cuda_device)
    mean2 = torch.zeros((2, N // 2), device=cuda_device)
    a, b = tfp._scale_affine(True, N // 2, 0.0, 60.0, 0.0, 1.0)
    kw = dict(bitshift=False, log_scaling=True, a=a, b=b)
    got = tfp.fold_depth_scale_concat(raw, (shifted,), mean2, **kw)
    assert not tfp.scale_error(got, tfp.depth_scale_concat_plain(raw, (w1,), mean2, **kw))[2]


@pytest.mark.cuda
@pytest.mark.parametrize("chunk,wire", [(1, "uint16"), (3, "packed12")])
def test_cuda_engine_matches_cpu_engine(cuda_device, tmp_path, chunk, wire):
    """The streaming engine on the GPU (upload stream, pinned ring, events,
    D2H stream; the concat kernels) and on the CPU (plain versions): the
    same float32 recorder stream within the scale bounds, the same
    quantized stream within one code; every in-flight entry carries an
    event on the GPU."""
    from octproz_tpu_torch.io.recorder import RecordingParams
    from octproz_tpu_torch.io.source import SyntheticSource
    from octproz_tpu_torch.models.fdoct import FdOctModel
    from octproz_tpu_torch.ops.convert import pack_uint12
    from octproz_tpu_torch.runtime import StreamingEngine

    acq = AcqParams(samples_per_line=N, ascans_per_bscan=32, bscans_per_buffer=8,
                    buffers_per_volume=2)
    cfg = dataclasses.replace(default_full_config(), bitshift=True, bscans_for_noise=2,
                              fold_concat=True, matmul_precision="high")
    synth = SyntheticSource(acq, seed=3)
    bufs = [synth.read_buffer(i) for i in range(7)]
    src = [pack_uint12(b) for b in bufs] if wire == "packed12" else bufs
    kw = dict(resample_coeffs=(0.0, N - 1.0, 10.0, -4.0),
              dispersion_coeffs=(0.0, 0.0, 8.0, 0.0))

    class Source:
        def buffers(self):
            yield from src

    out = {}
    for dev in (cuda_device, "cpu"):
        tag = str(dev)
        quant = []
        eng = StreamingEngine(FdOctModel(acq, cfg, **kw, device=dev), Source(),
                              wire_format=wire, stream_to_host=True, dispatch_chunk=chunk,
                              on_processed=lambda b, nr: quant.append(b.copy()))
        eng.start_recording(RecordingParams(save_dir=str(tmp_path / tag.replace(":", "")),
                                            buffers_to_record=7, save_raw=False,
                                            save_processed=True, save_as_32bit_float=True,
                                            save_meta=False))
        drained = []
        orig = eng._drain_one
        eng._drain_one = lambda fl: (drained.append(fl[0][-1]), orig(fl))
        before = dict(tfp.LAUNCHES)
        assert eng.run() == 7
        if dev != "cpu":
            # one event per device of the model (runtime._mark_done)
            assert all(e and all(isinstance(ev, torch.cuda.Event) for ev in e) for e in drained)
            assert tfp.LAUNCHES["depth_split"] == before["depth_split"] + 1
            assert tfp.LAUNCHES["depth_scale_concat_split"] > before["depth_scale_concat_split"]
            assert tfp.LAUNCHES["depth_scale_split"] == before["depth_scale_split"]
        rec = np.fromfile(eng.processed_recorder.last_file, np.float32)
        out[tag] = (rec.reshape(7, *acq.processed_buffer_shape), quant)
    (g_f, g_q), (c_f, c_q) = out[str(cuda_device)], out["cpu"]
    for a, b in zip(g_f, c_f):
        _scale_close(torch.from_numpy(a), b)
    for a, b in zip(g_q, c_q):
        assert np.abs(a.astype(np.int64) - b.astype(np.int64)).max() <= 1
