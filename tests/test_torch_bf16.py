"""``compute_dtype="bfloat16"`` in the port: the five kernel families that
take it (B1 ``_kernel_depth``, B2 ``_kernel_depth_scale``, B5
``_kernel_depth_scale_concat``, B7 ``_kernel_phase``, B8 ``_kernel_real``)
through the public wrappers against the JAX package's Pallas kernels in
interpret mode, over every input type; the rung's form of the operators
(one bf16 part, rounded to nearest, made once per curve build); that
"high"/"highest" leave bf16 output unchanged bit for bit; and -- on a CUDA
GPU only -- each kernel's bf16 route against its plain version, with the
two controls that must fail.  The model end to end at bf16 is in
``tests/test_torch_pipeline.py`` (``SLICE_CONFIGS``, "bf16-*").

Both sides round x and the operator to bf16 (round to nearest even) and
form the exact float32 products of the same bf16 values; only the order of
the float32 sums differs.  So the float32 bounds of the kernels' own
comparison hold (``fused_prep.planar_error`` / ``scale_error`` /
``prep_error``, reasons stated there): planar relative L2 <= 3e-6, prep
spectra <= 1e-6, scaled images RMS <= 1e-6 and max <= 1e-4 display units
above the display floor (one bf16 step more for a bf16 store).  The
display floor follows the samples' range, 20 log10 of it over that of
8-bit values (0, 24, 48 and 96 dB for 8/shifted-12, 12, 16 and 24 bits),
as the one-pass rung's cases on the card set it: below it log10 amplifies
the same rounding without bound.  Linear scaling is checked on 8-bit
ranges only, its bound being absolute display units.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

from octproz_tpu_torch import curves as tcurves
from octproz_tpu_torch.kernels import fused_prep as tfp
from octproz_tpu_torch.models.fdoct import FdOctModel
from octproz_tpu_torch.params import AcqParams, default_full_config
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

N = 256
#: input kind -> (bit depth, bitshift, display floor dB)
KINDS = {"u8": (8, False, 0.0), "u12-shifted": (12, True, 0.0), "u12": (12, False, 24.0),
         "u16": (16, False, 48.0), "u24": (24, False, 96.0)}
EIGHT_BIT = ("u8", "u12-shifted")
CURVE_KW = dict(resample_coeffs=(0.0, N - 1.0, 10.0, -4.0),
                dispersion_coeffs=(0.0, 0.0, 8.0, 0.0))


@pytest.fixture(scope="module")
def jfp():
    """The JAX package's fused_prep module (the pallas package's __init__
    re-exports a function of the same name, hence import_module)."""
    return importlib.import_module("octproz_tpu.pallas.fused_prep")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the bf16 route is CUDA C++ for sm_90a and "
                    "has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in true float32
    return torch.device("cuda", 0)


def _setup(kind, **changes):
    """(acq, cfg, jacq, jcfg) at bf16 compute for input ``kind``, the scale's
    60 dB display range from the kind's floor up, then ``changes``."""
    import octproz_tpu.params as jparams

    bit_depth, bitshift, floor = KINDS[kind]
    geometry = dict(samples_per_line=N, ascans_per_bscan=16, bscans_per_buffer=4,
                    bit_depth=bit_depth)
    fields = dict(bitshift=bitshift, compute_dtype="bfloat16", grayscale_min=floor,
                  grayscale_max=floor + 60.0, **changes)
    cfg = dataclasses.replace(default_full_config(), **fields)
    jcfg = dataclasses.replace(jparams.default_full_config(), **fields)
    return AcqParams(**geometry), cfg, jparams.AcqParams(**geometry), jcfg


def _raw(acq, seed=11, lead=()):
    dtype = {torch.uint8: np.uint8, torch.uint16: np.uint16, torch.uint32: np.uint32}
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << acq.bit_depth, size=(*lead, *acq.buffer_shape)).astype(
        dtype[acq.raw_dtype])


def _depth_operators(acq, cfg):
    cv = tcurves.make_curves(acq, dataclasses.replace(cfg, fft_via_matmul=True),
                             **CURVE_KW, device="cpu")
    return cv.depth_op_re, cv.depth_op_im


def _prep_curves(acq, cfg):
    return tcurves.make_curves(acq, cfg, **CURVE_KW, device="cpu")


def _planar_close(got, want):
    err = tfp.planar_error(got, [torch.from_numpy(np.array(w)) for w in want])
    assert err <= tfp.PLANAR_REL_L2, err


def _scale_close(got, want):
    rms, worst, ok = tfp.scale_error(got, torch.from_numpy(np.array(want, np.float32)))
    assert ok, (rms, worst)


def _prep_close(got, want):
    want = torch.from_numpy(np.array(want))
    assert got.dtype == want.dtype and got.shape == want.shape
    err = tfp.prep_error(got, want)
    assert err <= tfp.PREP_REL_L2, err


# ---------------------------------------------------------------------------
# the wrappers against the Pallas kernels (CPU: the plain versions)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_bf16_depth_matches_pallas(jfp, kind, backend):
    """B1 (``_kernel_depth`` at bf16) and the plain-matmul route: x and the
    operators rounded to bf16, one float32 product each of re and im."""
    import jax.numpy as jnp

    acq, cfg, jacq, jcfg = _setup(kind, fold_backend=backend)
    wre, wim = _depth_operators(acq, cfg)
    raw = _raw(acq)
    got = tfp.fused_depth_transform(torch.from_numpy(raw), wre, wim, acq, cfg)
    want = jfp.fused_depth_transform(jnp.asarray(raw), jnp.asarray(wre.numpy()),
                                     jnp.asarray(wim.numpy()), jacq, jcfg, interpret=True)
    assert got[0].shape == (4, 16, N // 2) and got[0].dtype == torch.float32
    _planar_close(got, want)


SCALE_MODES = {"log": dict(), "fast-log": dict(fast_log=True),
               "lin": dict(log_scaling=False), "log-bf16-store": dict(output_dtype="bfloat16")}
SCALE_CASES = [(kind, mode) for kind in KINDS for mode in SCALE_MODES
               if mode != "lin" or kind in EIGHT_BIT]


@pytest.mark.parametrize("kind,mode", SCALE_CASES)
def test_bf16_depth_scale_matches_pallas(jfp, kind, mode):
    """B2 (``_kernel_depth_scale`` at bf16): the GEMMs of B1, FPN mean
    subtraction, log / fast log / lin, float32 or bf16 store."""
    import jax.numpy as jnp

    acq, cfg, jacq, jcfg = _setup(kind, **SCALE_MODES[mode])
    wre, wim = _depth_operators(acq, cfg)
    raw = _raw(acq, seed=12)
    mean2 = np.random.default_rng(3).normal(0, 50.0, size=(2, N // 2)).astype(np.float32)
    got = tfp.fused_depth_scale(torch.from_numpy(raw), wre, wim, torch.from_numpy(mean2),
                                acq, cfg)
    want = jfp.fused_depth_scale(jnp.asarray(raw), jnp.asarray(wre.numpy()),
                                 jnp.asarray(wim.numpy()), jnp.asarray(mean2), jacq, jcfg,
                                 interpret=True)
    assert got.dtype == (torch.bfloat16 if mode == "log-bf16-store" else torch.float32)
    _scale_close(got, want)


CONCAT_CASES = [(kind, mode) for kind in KINDS for mode in ("log", "lin", "log-bf16-store")
                if mode != "lin" or kind in EIGHT_BIT]


@pytest.mark.parametrize("kind,mode", CONCAT_CASES)
def test_bf16_concat_matches_pallas(jfp, kind, mode):
    """B5 (``_kernel_depth_scale_concat`` at bf16): one product against the
    rounded [W_re | W_im], re and im sliced from it, the epilogue of B2."""
    import jax.numpy as jnp

    acq, cfg, jacq, jcfg = _setup(kind, fold_concat=True, **SCALE_MODES[mode])
    wre, wim = _depth_operators(acq, cfg)
    raw = _raw(acq, seed=13)
    mean2 = np.random.default_rng(4).normal(0, 50.0, size=(2, N // 2)).astype(np.float32)
    got = tfp.fused_depth_scale(torch.from_numpy(raw), wre, wim, torch.from_numpy(mean2),
                                acq, cfg)
    want = jfp.fused_depth_scale(jnp.asarray(raw), jnp.asarray(wre.numpy()),
                                 jnp.asarray(wim.numpy()), jnp.asarray(mean2), jacq, jcfg,
                                 interpret=True)
    _scale_close(got, want)


@pytest.mark.parametrize("background", [False, True])
@pytest.mark.parametrize("dispersion", [True, False])
@pytest.mark.parametrize("kind", list(KINDS))
def test_bf16_prep_matches_pallas(jfp, kind, dispersion, background):
    """B7 (``_kernel_phase``, dispersion) and B8 (``_kernel_real``) at bf16:
    one product against the rounded prep operator, then the float32
    phasor epilogue (complex64) or the float32 store; with and without
    background removal folded into the operator."""
    import jax.numpy as jnp

    acq, cfg, jacq, jcfg = _setup(kind, fft_via_matmul=False, use_pallas_prep=True,
                                  dispersion=dispersion, background_removal=background,
                                  rolling_average_window=8)
    cv = _prep_curves(acq, cfg)
    raw = _raw(acq, seed=14)
    phase = cv.phase if dispersion else None
    got = tfp.fused_prep(torch.from_numpy(raw), cv.prep_operator, phase, acq, cfg)
    want = jfp.fused_prep(jnp.asarray(raw), jnp.asarray(cv.prep_operator.numpy()),
                          None if phase is None else jnp.asarray(phase.numpy()),
                          jacq, jcfg, interpret=True)
    assert got.dtype == (torch.complex64 if dispersion else torch.float32)
    _prep_close(got, want)


def test_bf16_resampler_matches_jax():
    """The torch-ops FFT path's resampler at bf16: x and R.T rounded, one
    float32 product (``octproz_tpu/ops/resample.py``'s bf16 matmul)."""
    import jax.numpy as jnp

    from octproz_tpu.ops import resample as jresample
    from octproz_tpu_torch.ops import resample as tresample

    rng = np.random.default_rng(6)
    x = rng.normal(0, 700.0, size=(64, N)).astype(np.float32)
    r = rng.normal(0, 1.0, size=(N, N)).astype(np.float32)
    got = tresample.apply_matmul(torch.from_numpy(x), torch.from_numpy(r), precision="bfloat16")
    want = jresample.apply_matmul(jnp.asarray(x), jnp.asarray(r), jnp.bfloat16)
    assert got.dtype == torch.float32
    _prep_close(got, want)
    plain = tresample.apply_matmul(torch.from_numpy(x), torch.from_numpy(r))
    assert tfp.prep_error(got, plain) > 100 * tfp.PREP_REL_L2  # it did round


# ---------------------------------------------------------------------------
# the rung's operator form, and matmul_precision ignored
# ---------------------------------------------------------------------------

def test_bf16_operator_form():
    """At bf16 the rung is "bfloat16" whatever matmul_precision says; the
    operator is one bf16 part rounded to nearest (not the mask truncation
    of the split rungs), a tuple of it passes through, and a form made for
    another rung is refused."""
    acq, cfg, _, _ = _setup("u12")
    assert tfp.operator_rung(cfg) == tfp.BF16
    for precision in ("high", "highest"):
        assert tfp.operator_rung(dataclasses.replace(cfg, matmul_precision=precision)) == tfp.BF16
    assert tfp.operator_rung(dataclasses.replace(cfg, compute_dtype="float32")) == "default"
    w = torch.from_numpy(np.random.default_rng(8).normal(size=(N, N // 2)).astype(np.float32))
    (part,) = tfp._operator_parts(w, tfp.BF16)
    assert part.dtype == torch.bfloat16 and torch.equal(part, w.to(torch.bfloat16))
    assert not torch.equal(part.float(), tfp._bf16_trunc(w))  # rounded, not truncated
    assert tfp._operator_parts((part,), tfp.BF16)[0] is part
    with pytest.raises(ValueError, match="operator part"):
        tfp._operator_parts(tfp._operator_parts(w, "default"), tfp.BF16)
    with pytest.raises(ValueError, match="operator part"):
        tfp._operator_parts((part,), "default")
    wide = tfp.concat_operator((part,), (part,), tfp.BF16)
    assert len(wide) == 1 and torch.equal(wide[0], torch.cat([part, part], dim=1))
    assert torch.equal(tfp.concat_operator(w, w, tfp.BF16)[0], wide[0])


def test_bf16_plain_product_is_float32():
    """The plain product keeps the float32 sum of the exact bf16 products:
    equal to a float64 product of the rounded operands within float32
    rounding, where a matmul of the bf16 tensors themselves (bf16 result)
    is ~2^-9 off."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.integers(0, 4096, size=(64, N)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(N, 64)).astype(np.float32))
    got = tfp._dot_bf16(x, w)
    exact = x.to(torch.bfloat16).double() @ w.to(torch.bfloat16).double()
    assert got.dtype == torch.float32
    assert tfp.prep_error(got, exact) < 1e-6
    assert tfp.prep_error((x.to(torch.bfloat16) @ w.to(torch.bfloat16)).float(), exact) > 1e-4


@pytest.mark.parametrize("precision", ["high", "highest"])
@pytest.mark.parametrize("path", ["depth", "scale", "concat", "phase", "real"])
def test_bf16_ignores_matmul_precision(path, precision):
    """bf16 + "high"/"highest" gives bf16 + "default" bit for bit, on every
    family (``tests/test_pallas.py``'s
    ``test_bf16_compute_never_passes_native_high_precision``)."""
    changes = {"depth": {}, "scale": {}, "concat": dict(fold_concat=True),
               "phase": dict(fft_via_matmul=False, use_pallas_prep=True),
               "real": dict(fft_via_matmul=False, use_pallas_prep=True, dispersion=False)}[path]
    acq, cfg, _, _ = _setup("u12", **changes)
    raw = torch.from_numpy(_raw(acq, seed=15))
    mean2 = torch.from_numpy(np.random.default_rng(5).normal(0, 50.0, size=(2, N // 2))
                             .astype(np.float32))
    outs = []
    for prec in ("default", precision):
        c = dataclasses.replace(cfg, matmul_precision=prec)
        if path in ("phase", "real"):
            cv = _prep_curves(acq, c)
            outs.append([tfp.fused_prep(raw, cv.prep_operator, cv.phase if path == "phase"
                                        else None, acq, c)])
        else:
            wre, wim = _depth_operators(acq, c)
            outs.append(list(tfp.fused_depth_transform(raw, wre, wim, acq, c))
                        if path == "depth" else [tfp.fused_depth_scale(raw, wre, wim, mean2,
                                                                       acq, c)])
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_bf16_parts_made_once_per_curve_build():
    """make_curves holds the rounded bf16 operators of bf16 compute --
    ``depth_parts``, with fold_concat ``depth_concat_parts``, and on the FFT
    path ``prep_parts`` -- and the wrappers give the same output from them
    as from the float32 operators rounded per call."""
    acq, cfg, _, _ = _setup("u12")
    cv = tcurves.make_curves(acq, cfg, **CURVE_KW, device="cpu")
    for parts, op in zip(cv.depth_parts, (cv.depth_op_re, cv.depth_op_im)):
        assert len(parts) == 1 and torch.equal(parts[0], op.to(torch.bfloat16))
    raw = torch.from_numpy(_raw(acq, seed=16))
    mean2 = torch.zeros((2, N // 2))
    assert torch.equal(tfp.fused_depth_scale(raw, *cv.depth_parts, mean2, acq, cfg),
                       tfp.fused_depth_scale(raw, cv.depth_op_re, cv.depth_op_im, mean2, acq,
                                             cfg))
    concat = dataclasses.replace(cfg, fold_concat=True)
    cc = tcurves.make_curves(acq, concat, **CURVE_KW, device="cpu")
    assert len(cc.depth_concat_parts) == 1 and torch.equal(
        cc.depth_concat_parts[0],
        torch.cat([cc.depth_op_re, cc.depth_op_im], dim=1).to(torch.bfloat16))
    assert torch.equal(
        tfp.fused_depth_scale(raw, *cc.depth_parts, mean2, acq, concat,
                              wide=cc.depth_concat_parts),
        tfp.fused_depth_scale(raw, cc.depth_op_re, cc.depth_op_im, mean2, acq, concat))
    fft = dataclasses.replace(cfg, fft_via_matmul=False, use_pallas_prep=True)
    cp = tcurves.make_curves(acq, fft, **CURVE_KW, device="cpu")
    assert len(cp.prep_parts) == 1 and torch.equal(cp.prep_parts[0],
                                                   cp.prep_operator.to(torch.bfloat16))
    assert torch.equal(tfp.fused_prep(raw, cp.prep_parts, cp.phase, acq, fft),
                       tfp.fused_prep(raw, cp.prep_operator, cp.phase, acq, fft))


def test_set_config_to_and_from_bf16_rebuilds_the_operators():
    """FdOctModel.set_config(compute_dtype=...) rebuilds the held operators
    in the new rung's form, both ways, and the output follows."""
    acq, cfg, _, _ = _setup("u12")
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    tm = FdOctModel(acq, f32, **CURVE_KW, device="cpu")
    raw = _raw(acq, seed=17)
    ref32 = tm.process_buffer(raw)
    assert all(isinstance(p, tfp.OnePass) for p in tm.curves.depth_parts)
    tm.set_config(compute_dtype="bfloat16")
    tm.redetermine_fpn()
    cfg_now, curves, _ = tm._exec
    assert cfg_now.compute_dtype == "bfloat16"
    assert all(len(p) == 1 and p[0].dtype == torch.bfloat16 for p in curves.depth_parts)
    out16 = tm.process_buffer(raw)
    assert torch.equal(out16, FdOctModel(acq, cfg, **CURVE_KW, device="cpu").process_buffer(raw))
    assert not torch.equal(out16, ref32)
    tm.set_config(compute_dtype="float32")
    tm.redetermine_fpn()
    assert all(isinstance(p, tfp.OnePass) for p in tm._exec[1].depth_parts)
    assert torch.equal(tm.process_buffer(raw), ref32)


# ---------------------------------------------------------------------------
# the kernels' bf16 route on the card
# ---------------------------------------------------------------------------

def _card_raw(kind, lines, n, g, dev):
    if kind == "u8":
        return torch.randint(0, 256, (lines, n), dtype=torch.uint8, generator=g, device=dev)
    if kind == "f32":
        return torch.randint(0, 1 << 24, (lines, n), dtype=torch.int32, generator=g,
                             device=dev).to(torch.float32)
    return torch.randint(0, 4096, (lines, n), dtype=torch.int16, generator=g,
                         device=dev).view(torch.uint16)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["u8", "u12-shifted", "u12", "f32"])
def test_bf16_kernels_match_plain_on_card(cuda_device, kind):
    """Each family's bf16 route on the card against its plain version, on
    uint8, shifted and unshifted 12-bit and float32 lines (the route
    counted as ``tensor_core_bf16`` for every input type), with n_in = 1100
    for the concat kernel (half % 8 != 0: the element-wise producer)."""
    g = torch.Generator(device=cuda_device)
    g.manual_seed(21)
    bitshift = kind == "u12-shifted"
    for n in (1024, 1100):
        acq = AcqParams(samples_per_line=n, ascans_per_bscan=8, bscans_per_buffer=1)
        cfg = dataclasses.replace(default_full_config(), compute_dtype="bfloat16")
        cv = tcurves.make_curves(acq, cfg, **dict(CURVE_KW, resample_coeffs=(
            0.0, n - 1.0, 10.0, -4.0)), device=cuda_device)
        pc = tcurves.make_curves(acq, dataclasses.replace(cfg, fft_via_matmul=False,
                                                          use_pallas_prep=True),
                                 **dict(CURVE_KW, resample_coeffs=(0.0, n - 1.0, 10.0, -4.0)),
                                 device=cuda_device)
        raw = _card_raw(kind, 999, n, g, cuda_device)
        wre, wim = cv.depth_parts
        tfp.reset_launch_counts()
        got = tfp.fold_depth(raw, wre, wim, bitshift=bitshift)
        assert tfp.planar_error(got, tfp.depth_plain(raw, wre, wim, bitshift=bitshift)) \
            <= tfp.PLANAR_REL_L2
        mean2 = torch.randn((2, n // 2), generator=g, device=cuda_device) * 50.0
        a, b = tfp._scale_affine(True, n // 2, 96.0 if kind == "f32" else 24.0,
                                 156.0 if kind == "f32" else 84.0, 0.0, 1.0)
        kw = dict(bitshift=bitshift, log_scaling=True, a=a, b=b)
        assert tfp.scale_error(tfp.fold_depth_scale(raw, wre, wim, mean2, **kw),
                               tfp.depth_scale_plain(raw, wre, wim, mean2, **kw))[2]
        wide = tfp.concat_operator(wre, wim, tfp.BF16)
        assert tfp.scale_error(tfp.fold_depth_scale_concat(raw, wide, mean2, **kw),
                               tfp.depth_scale_concat_plain(raw, wide, mean2, **kw))[2]
        rows = (pc.phase.real.contiguous(), pc.phase.imag.contiguous())
        assert tfp.prep_error(tfp.prep_phase(raw, pc.prep_parts, *rows, bitshift=bitshift),
                              tfp.prep_phase_plain(raw, pc.prep_parts, *rows,
                                                   bitshift=bitshift)) <= tfp.PREP_REL_L2
        assert tfp.prep_error(tfp.prep_real(raw, pc.prep_parts, bitshift=bitshift),
                              tfp.prep_real_plain(raw, pc.prep_parts, bitshift=bitshift)) \
            <= tfp.PREP_REL_L2
        torch.cuda.synchronize()
        for family in ("depth", "depth_scale", "depth_scale_concat", "prep_phase", "prep_real"):
            assert tfp.ONE_PASS_ROUTES[family] == {"tensor_core": 0,
                                                   "tensor_core_bf16": 1}, family


@pytest.mark.cuda
def test_bf16_controls_fail_on_card(cuda_device):
    """On unshifted 12-bit samples (more than bf16's 8 significant bits) a
    kernel fed truncated x, and the one-pass rung's three-part route, both
    fail the bounds against the bf16 plain version."""
    g = torch.Generator(device=cuda_device)
    g.manual_seed(22)
    acq = AcqParams(samples_per_line=1024, ascans_per_bscan=8, bscans_per_buffer=1)
    cfg = dataclasses.replace(default_full_config(), compute_dtype="bfloat16")
    cv = tcurves.make_curves(acq, cfg, **dict(CURVE_KW, resample_coeffs=(
        0.0, 1023.0, 10.0, -4.0)), device=cuda_device)
    raw = _card_raw("u12", 4096, 1024, g, cuda_device)
    want = tfp.depth_plain(raw, *cv.depth_parts, bitshift=False)
    x_trunc = tfp._bf16_trunc(raw.to(torch.float32)).to(torch.int16).view(torch.uint16)
    three = [tfp._operator_parts(w, "default") for w in (cv.depth_op_re, cv.depth_op_im)]
    for got in (tfp.fold_depth(x_trunc, *cv.depth_parts, bitshift=False),
                tfp.fold_depth(raw, *three, bitshift=False)):
        assert tfp.planar_error(got, want) > 10 * tfp.PLANAR_REL_L2
