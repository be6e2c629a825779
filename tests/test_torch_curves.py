"""The port's host-side numpy copies against the JAX package's originals:
curves, windows, interpolation operators, folded operators, the scale
affine constants and the parameter classes.  All are pure numpy on both
sides, so the comparison is byte equality (np.array_equal), not a
tolerance."""

import dataclasses
import enum
import importlib

import numpy as np
import pytest

import octproz_tpu.curves as jcurves
import octproz_tpu.ops.background as jbackground
import octproz_tpu.ops.resample as jresample
import octproz_tpu.params as jparams
import octproz_tpu_torch.curves as tcurves
import octproz_tpu_torch.kernels.fused_prep as tfp
import octproz_tpu_torch.ops.background as tbackground
import octproz_tpu_torch.ops.resample as tresample
import octproz_tpu_torch.params as tparams
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

# the JAX package's pallas/__init__ re-exports a function named fused_prep
jfp = importlib.import_module("octproz_tpu.pallas.fused_prep")

N = 256
T_ACQ = tparams.AcqParams(samples_per_line=N, ascans_per_bscan=32, bscans_per_buffer=4)
J_ACQ = jparams.AcqParams(samples_per_line=N, ascans_per_bscan=32, bscans_per_buffer=4)


def _jax_cfg(cfg: tparams.ProcConfig) -> jparams.ProcConfig:
    """The JAX ProcConfig with the same field values (enums by value)."""
    vals = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if isinstance(v, enum.Enum):
            v = getattr(jparams, type(v).__name__)(v.value)
        vals[f.name] = v
    return jparams.ProcConfig(**vals)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b, equal_nan=True)


INTERPS = ["linear", "quadratic", "cubic", "lanczos"]
WINDOWS = [w.value for w in tparams.WindowType]


@pytest.mark.parametrize("coeffs", [(0.0, N - 1.0, 10.0, -4.0), (3.0, 200.0, -30.0, 9.0),
                                    (0.0, 0.0, 0.0, 0.0)])
def test_resample_curve_equal(coeffs):
    _same(tcurves.resample_curve(T_ACQ, *coeffs), jcurves.resample_curve(J_ACQ, *coeffs))
    _same(tcurves.polynomial_curve(coeffs, N), jcurves.polynomial_curve(coeffs, N))


def test_custom_and_identity_resample_curve_equal():
    custom = np.linspace(-5.0, N + 5.0, N).astype(np.float32)
    _same(tcurves.resample_curve(T_ACQ, custom=custom),
          jcurves.resample_curve(J_ACQ, custom=custom))
    _same(tcurves.identity_resample_curve(T_ACQ), jcurves.identity_resample_curve(J_ACQ))
    with pytest.raises(ValueError):
        tcurves.resample_curve(T_ACQ, custom=custom[:-1])


@pytest.mark.parametrize("interp", INTERPS)
def test_interpolation_operator_equal(interp):
    curve = tcurves.resample_curve(T_ACQ, 0.0, N - 1.0, 10.0, -4.0)
    ti, tw = tresample.interpolation_taps(curve, tparams.Interpolation(interp))
    ji, jw = jresample.interpolation_taps(curve, jparams.Interpolation(interp))
    _same(ti, ji)
    _same(tw, jw)
    _same(tresample.build_resample_matrix(curve, tparams.Interpolation(interp)),
          jresample.build_resample_matrix(curve, jparams.Interpolation(interp)))


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("center,fill", [(0.5, 1.0), (0.4, 0.7), (0.9, 0.001)])
def test_window_equal(window, center, fill):
    _same(tcurves.window_curve(tparams.WindowType(window), N, center, fill),
          jcurves.window_curve(jparams.WindowType(window), N, center, fill))


@pytest.mark.parametrize("coeffs", [(0.0, 0.0, 8.0, 0.0), (1.0, -3.0, 20.0, -6.0)])
def test_dispersion_phase_equal(coeffs):
    _same(tcurves.dispersion_phase(T_ACQ, *coeffs), jcurves.dispersion_phase(J_ACQ, *coeffs))
    _same(tcurves.dispersion_phase(T_ACQ, *coeffs, factor=0.5, direction=-1),
          jcurves.dispersion_phase(J_ACQ, *coeffs, factor=0.5, direction=-1))


def test_sinusoidal_curve_and_background_indices_equal():
    _same(tcurves.sinusoidal_scan_curve(32), jcurves.sinusoidal_scan_curve(32))
    for window in (1, 16, 64, 400):
        for t, j in zip(tbackground.rolling_average_indices(N, window),
                        jbackground.rolling_average_indices(N, window)):
            _same(t, j)


OPERATOR_CFGS = [
    dict(resampling=True, windowing=True, dispersion=True),
    dict(resampling=True, windowing=True, dispersion=False),
    dict(background_removal=True, rolling_average_window=16, resampling=True,
         windowing=True, dispersion=True),
    dict(windowing=True),
]


@pytest.mark.parametrize("interp", INTERPS)
@pytest.mark.parametrize("flags", OPERATOR_CFGS)
def test_folded_operators_equal(interp, flags):
    cfg = tparams.ProcConfig(interpolation=tparams.Interpolation(interp),
                             fft_via_matmul=True, **flags)
    jcfg = _jax_cfg(cfg)
    curve = tcurves.resample_curve(T_ACQ, 0.0, N - 1.0, 10.0, -4.0)
    rm = tresample.build_resample_matrix(curve, cfg.interpolation)
    win = tcurves.window_curve(tparams.WindowType.HANNING, N)
    phase = tcurves.dispersion_phase(T_ACQ, 0.0, 0.0, 8.0, 0.0)
    _same(tfp.build_prep_operator(T_ACQ, cfg, rm, win),
          jfp.build_prep_operator(J_ACQ, jcfg, rm, win))
    for t, j in zip(tfp.build_depth_operator(T_ACQ, cfg, rm, win, phase),
                    jfp.build_depth_operator(J_ACQ, jcfg, rm, win, phase)):
        _same(t, j)


def test_folded_operator_missing_inputs_raise():
    cfg = tparams.ProcConfig(resampling=True, windowing=True, dispersion=True)
    with pytest.raises(ValueError):
        tfp.build_prep_operator(T_ACQ, cfg, None, None)
    with pytest.raises(ValueError):
        tfp.build_depth_operator(T_ACQ, cfg, np.eye(N, dtype=np.float32),
                                 np.ones(N, np.float32), None)


@pytest.mark.parametrize("log_scaling", [True, False])
@pytest.mark.parametrize("gmin,gmax,addend,coeff", [(0.0, 60.0, 0.0, 1.0),
                                                    (10.0, 75.0, 0.1, 0.9),
                                                    (5.0, 5.0, 0.0, 1.0)])
def test_scale_affine_equal(log_scaling, gmin, gmax, addend, coeff):
    assert tfp._scale_affine(log_scaling, 128, gmin, gmax, addend, coeff) == \
        jfp._scale_affine(log_scaling, 128, gmin, gmax, addend, coeff)


CURVE_CFGS = [
    dict(fft_via_matmul=True, resampling=True, windowing=True, dispersion=True),
    dict(use_pallas_prep=True, resampling=True, dispersion=True),
    dict(use_pallas_prep=True, resampling=True, windowing=True, background_removal=True,
         matmul_precision="highest"),
    dict(use_pallas_prep=True, fft_via_matmul=True, resampling=True, windowing=True,
         matmul_precision="high"),
    dict(resampling=True, windowing=True, dispersion=True),
    dict(resampling=True, resample_via_matmul=False, sinusoidal_correction=True,
         post_background_removal=True),
    dict(fft_via_matmul=True, fold_concat=True, resampling=True, windowing=True,
         dispersion=True, matmul_precision="highest"),
]


@pytest.mark.parametrize("flags", CURVE_CFGS)
def test_make_curves_equal(flags):
    """Every field of make_curves equals the JAX package's (as numpy), and
    exactly the consumed fields are tensors on the requested device.  The
    port's own ``depth_parts`` is the depth operator split once for the
    configured rung, and with ``fold_concat`` ``depth_concat_parts`` the
    concatenated operator split for it."""
    import torch

    cfg = tparams.ProcConfig(**flags)
    jcfg = _jax_cfg(cfg)
    assert tcurves.consumed_fields(cfg) == jcurves.consumed_fields(jcfg)
    kw = dict(resample_coeffs=(0.0, N - 1.0, 10.0, -4.0),
              dispersion_coeffs=(0.0, 0.0, 8.0, 0.0))
    tc = tcurves.make_curves(T_ACQ, cfg, **kw, device="cpu")
    jc = jcurves.make_curves(J_ACQ, jcfg, **kw)
    used = tcurves.consumed_fields(cfg)
    assert {f.name for f in dataclasses.fields(tparams.Curves)} == \
        {f.name for f in dataclasses.fields(jcurves.Curves)} | {"depth_parts", "prep_parts",
                                                               "depth_concat_parts"}
    split = {"depth_parts": (tc.depth_op_re, tc.depth_op_im) if cfg.fft_via_matmul else None,
             "prep_parts": (tc.prep_operator,) if "prep_operator" in used else None}
    for name, ops in split.items():
        parts = getattr(tc, name)
        if ops is None:
            assert parts is None, name
            continue
        if name == "prep_parts":
            parts = (parts,)
        for got, op in zip(parts, ops):
            want = tfp._operator_parts(op, cfg.matmul_precision)
            assert len(got) == len(want)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
    wide = tc.depth_concat_parts
    if not cfg.fold_concat:
        assert wide is None
    else:
        want = tfp._operator_parts(torch.cat([tc.depth_op_re, tc.depth_op_im], dim=1),
                                   cfg.matmul_precision)
        assert len(wide) == len(want) and all(torch.equal(g, w) for g, w in zip(wide, want))
    for f in dataclasses.fields(jcurves.Curves):
        t, j = getattr(tc, f.name), getattr(jc, f.name)
        assert (t is None) == (j is None), f.name
        if t is None:
            continue
        assert isinstance(t, torch.Tensor) == (f.name in used), f.name
        _same(t.numpy() if isinstance(t, torch.Tensor) else t, np.asarray(j))


def test_param_classes_match():
    """Same enums, constants, fields and defaults as the JAX package."""
    for name in ("Interpolation", "WindowType", "FpnMode", "DisplayFunction"):
        assert [(m.name, m.value) for m in getattr(tparams, name)] == \
            [(m.name, m.value) for m in getattr(jparams, name)]
    assert tparams.FPN_SEGMENTS == jparams.FPN_SEGMENTS
    assert tparams.FPN_TIE_EPS == jparams.FPN_TIE_EPS
    for tcls, jcls in ((tparams.ProcConfig, jparams.ProcConfig),
                       (tparams.AcqParams, jparams.AcqParams)):
        tf = [(f.name, f.default) for f in dataclasses.fields(tcls)]
        jf = [(f.name, f.default) for f in dataclasses.fields(jcls)]
        assert [n for n, _ in tf] == [n for n, _ in jf]
        for (n, td), (_, jd) in zip(tf, jf):
            assert getattr(td, "value", td) == getattr(jd, "value", jd), n
    assert _jax_cfg(tparams.default_full_config()) == jparams.default_full_config()
    for acq_t, acq_j in ((T_ACQ, J_ACQ),):
        for prop in ("bytes_per_sample", "ascans_per_buffer", "samples_per_buffer",
                     "buffer_shape", "output_ascan_length",
                     "processed_buffer_shape", "bytes_per_buffer"):
            assert getattr(acq_t, prop) == getattr(acq_j, prop), prop


@pytest.mark.parametrize("bit_depth,dtype", [(8, "uint8"), (12, "uint16"),
                                             (16, "uint16"), (24, "uint32")])
def test_raw_dtype_is_torch(bit_depth, dtype):
    import torch

    assert tparams.AcqParams(bit_depth=bit_depth).raw_dtype == getattr(torch, dtype)
    assert np.dtype(jparams.AcqParams(bit_depth=bit_depth).raw_dtype).name == dtype


BAD_CONFIGS = [dict(fold_backend="mega"), dict(compute_dtype="float16"),
               dict(matmul_precision="hi"), dict(output_dtype="int8"),
               dict(fold_k_split=0), dict(pallas_tile=-1), dict(pallas_tile=4),
               dict(rolling_average_window=0), dict(bscans_for_noise=0),
               dict(fold_concat=True, fast_log=True),
               dict(matmul_precision="high", fast_log=True),
               dict(matmul_precision="highest", fold_k_split=2)]


@pytest.mark.parametrize("bad", BAD_CONFIGS)
def test_invalid_configs_raise_in_both(bad):
    with pytest.raises(ValueError):
        jparams.ProcConfig(**bad)
    with pytest.raises(ValueError):
        tparams.ProcConfig(**bad)


@pytest.mark.parametrize("bad", [dict(samples_per_line=3), dict(bit_depth=0),
                                 dict(bit_depth=33)])
def test_invalid_acq_raise_in_both(bad):
    with pytest.raises(ValueError):
        jparams.AcqParams(**bad)
    with pytest.raises(ValueError):
        tparams.AcqParams(**bad)
