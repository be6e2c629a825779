"""Both pipeline branches end to end: the port's FdOctModel against the
JAX package's on the same inputs (FPN buffer, steady buffers, batch and
scan chunks) on the fold path and the FFT path (prep kernels or torch ops,
then the FFT), with and without the post stages; the presets;
process_volume; the golden-pair gate and the float64-oracle precision
ladder on both paths; the interop round trip; and the refusals of
configurations the port does not run yet.

Tolerances (float32 on both sides, on the CPU the port runs the kernels'
plain versions):
* scaled images: equal finite masks, and |port - jax| <= 1e-4 where the JAX
  value is at or above the display floor (>= 0); below it p -> 0 and
  log10 amplifies float32 summation-order differences without bound.
  bfloat16 stores add one bf16 rounding step (2^-7 * |value|).
* FPN mean lines: rtol 1e-5 with an absolute floor of 1e-5 * max|mean|.
On the FFT path the two FFT libraries round differently as well (relative
1e-7, tests/test_torch_ops.py), far inside both bounds.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import octproz_tpu.models.fdoct as jfdoct
import octproz_tpu.params as jparams
from octproz_tpu import curves as jcurves
from octproz_tpu import pipeline as jpipeline
from octproz_tpu_torch import bench, interop
from octproz_tpu_torch import curves as tcurves
from octproz_tpu_torch import pipeline as tpipeline
from octproz_tpu_torch.models.fdoct import FdOctModel
from octproz_tpu_torch.params import (AcqParams, FpnMode, Interpolation, ProcConfig,
                                      WindowType, default_full_config)
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

N, ASCANS, BSCANS = 256, 32, 8
KW = dict(resample_coeffs=(0.0, N - 1.0, 10.0, -4.0),
          dispersion_coeffs=(0.0, 0.0, 8.0, 0.0), window_type=WindowType.HANNING)
JKW = dict(KW, window_type=jparams.WindowType.HANNING)
SCALE_ATOL = 1e-4
BF16_STEP = 2.0 ** -7


#: A post-process background line (made from a seed) for configurations
#: that remove one.
POST_BG = np.random.default_rng(5).uniform(0.0, 0.3, size=N // 2).astype(np.float32)


def _jax_cfg(cfg: ProcConfig):
    """The JAX package's ProcConfig with the same field values."""
    enums = {"fpn_mode": jparams.FpnMode, "interpolation": jparams.Interpolation}
    return jparams.ProcConfig(**{
        f.name: (enums[f.name](getattr(cfg, f.name).value) if f.name in enums
                 else getattr(cfg, f.name)) for f in dataclasses.fields(cfg)})


def _models(base_cfg=None, bit_depth=12, window=None, **changes):
    """The port's and the JAX package's model on the same configuration:
    ``base_cfg`` (default: the benchmark chain) with bitshift and FPN from
    the first two B-scans, then ``changes``; samples of ``bit_depth`` bits;
    ``window`` (type, center, fill factor) in place of the Hann window; the
    same post background line where the configuration removes one."""
    cfg = dataclasses.replace(base_cfg or default_full_config(), bitshift=True,
                              bscans_for_noise=2)
    cfg = dataclasses.replace(cfg, **changes)
    geometry = dict(samples_per_line=N, ascans_per_bscan=ASCANS, bscans_per_buffer=BSCANS,
                    bit_depth=bit_depth)
    post = dict(post_background=POST_BG) if cfg.post_background_removal else {}
    kw, jkw = dict(KW), dict(JKW)
    if window is not None:
        kind, center, fill = window
        kw.update(window_type=kind, window_center=center, window_fill_factor=fill)
        jkw.update(kw, window_type=jparams.WindowType(kind.value))
    tm = FdOctModel(AcqParams(**geometry), cfg, **kw, **post, device="cpu")
    jm = jfdoct.FdOctModel(jparams.AcqParams(**geometry), _jax_cfg(cfg), **jkw, **post)
    return tm, jm


def _buffers(count, seed=99, bit_depth=12):
    """Raw buffers of ``bit_depth``-bit samples in their container type."""
    rng = np.random.default_rng(seed)
    dtype = np.uint8 if bit_depth <= 8 else np.uint16 if bit_depth <= 16 else np.uint32
    return [rng.integers(0, 1 << bit_depth, size=(BSCANS, ASCANS, N)).astype(dtype)
            for _ in range(count)]


def _close(got, want):
    g = got.float().numpy().astype(np.float64) if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape
    np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
    shown = np.isfinite(w) & (w >= 0)
    assert shown.mean() > 0.5
    limit = SCALE_ATOL + (BF16_STEP * np.abs(w[shown])
                          if isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
                          else 0.0)
    err = np.abs(g[shown] - w[shown])
    assert (err <= limit).all(), err.max()


def _same_fpn(tm, jm):
    assert tm.fpn_state.determined == bool(jm.fpn_state.determined)
    t = tm.fpn_state.mean_line.numpy()
    j = np.asarray(jm.fpn_state.mean_line)
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5 * max(np.abs(j).max(), 1.0))


SLICE_CONFIGS = {
    "once-default": {},
    "once-high": dict(matmul_precision="high"),
    "once-highest": dict(matmul_precision="highest"),
    "fpn-off": dict(fpn_mode=FpnMode.OFF),
    "fpn-continuous": dict(fpn_mode=FpnMode.CONTINUOUS),
    "fold-xla": dict(fold_backend="xla"),
    "unfused-scale": dict(fused_scale=False),
    "bf16-store": dict(output_dtype="bfloat16"),
    "fast-log": dict(fast_log=True),
    "lin-scale": dict(log_scaling=False),
    # the fold path with the post stages (the kernel stores float32 while a
    # post stage consumes it; a bf16 store narrows after them)
    "fold-bscan-flip": dict(bscan_flip=True),
    "fold-sinusoidal": dict(sinusoidal_correction=True),
    "fold-post-background": dict(post_background_removal=True,
                                 post_background_weight=0.8, post_background_offset=0.05),
    "fold-post-stages-bf16": dict(bscan_flip=True, sinusoidal_correction=True,
                                  post_background_removal=True, output_dtype="bfloat16"),
    "fold-ignores-use-pallas-prep": dict(use_pallas_prep=True),
    # the concat fold kernels (one GEMM against [W_re | W_im]); the FPN
    # buffer still runs the two-operator planar kernels
    "fold-concat": dict(fold_concat=True),
    "fold-concat-high": dict(fold_concat=True, matmul_precision="high"),
    "fold-concat-highest": dict(fold_concat=True, matmul_precision="highest"),
    "fold-concat-lin-bf16": dict(fold_concat=True, log_scaling=False, output_dtype="bfloat16"),
    "fold-concat-fpn-off": dict(fold_concat=True, fpn_mode=FpnMode.OFF),
    "fold-concat-post-stages": dict(fold_concat=True, bscan_flip=True,
                                    sinusoidal_correction=True),
    # the FFT path: the prep kernels (phase with dispersion, real without)
    "fft-prep-default": dict(fft_via_matmul=False, use_pallas_prep=True),
    "fft-prep-high": dict(fft_via_matmul=False, use_pallas_prep=True, matmul_precision="high"),
    "fft-prep-highest": dict(fft_via_matmul=False, use_pallas_prep=True,
                             matmul_precision="highest"),
    "fft-prep-real-default": dict(fft_via_matmul=False, use_pallas_prep=True, dispersion=False),
    "fft-prep-real-high": dict(fft_via_matmul=False, use_pallas_prep=True, dispersion=False,
                               matmul_precision="high"),
    "fft-prep-background": dict(fft_via_matmul=False, use_pallas_prep=True,
                                background_removal=True, rolling_average_window=8),
    # the FFT path through torch ops
    "fft-matmul": dict(fft_via_matmul=False),
    "fft-matmul-high": dict(fft_via_matmul=False, matmul_precision="high"),
    "fft-gather-cubic": dict(fft_via_matmul=False, resample_via_matmul=False),
    "fft-gather-lanczos": dict(fft_via_matmul=False, resample_via_matmul=False,
                               interpolation=Interpolation.LANCZOS),
    "fft-background": dict(fft_via_matmul=False, background_removal=True),
    "fft-fpn-off": dict(fft_via_matmul=False, use_pallas_prep=True, fpn_mode=FpnMode.OFF),
    "fft-fpn-continuous": dict(fft_via_matmul=False, use_pallas_prep=True,
                               fpn_mode=FpnMode.CONTINUOUS),
    "fft-lin-scale": dict(fft_via_matmul=False, use_pallas_prep=True, log_scaling=False),
    "fft-bf16-store": dict(fft_via_matmul=False, output_dtype="bfloat16"),
    "fft-post-stages-bf16": dict(fft_via_matmul=False, use_pallas_prep=True, bscan_flip=True,
                                 sinusoidal_correction=True, post_background_removal=True,
                                 output_dtype="bfloat16"),
    # beyond 12-bit input: the sample widths on which the one-pass fold
    # kernel's two routes differ (integers of up to 16 bits go through the
    # three-part split, wider samples are decoded to float32 first), with and
    # without the 4-bit shift
    "fold-8bit": dict(bit_depth=8, bitshift=False),
    "fold-8bit-shift": dict(bit_depth=8),
    "fold-10bit": dict(bit_depth=10, bitshift=False),
    "fold-10bit-shift": dict(bit_depth=10),
    "fold-16bit": dict(bit_depth=16, bitshift=False),
    "fold-16bit-shift": dict(bit_depth=16),
    "fold-24bit": dict(bit_depth=24, bitshift=False),
    # (the shift of a wide container scales to [0, 1): a display range for it)
    "fold-24bit-shift": dict(bit_depth=24, grayscale_min=-120.0, grayscale_max=40.0),
    "fold-32bit": dict(bit_depth=32, bitshift=False),
    "fold-32bit-shift": dict(bit_depth=32, grayscale_min=-120.0, grayscale_max=40.0),
    "fold-16bit-high": dict(bit_depth=16, bitshift=False, matmul_precision="high"),
    "fold-16bit-fast-log": dict(bit_depth=16, bitshift=False, fast_log=True),
    # other operators folded into the depth GEMM
    "fold-background": dict(background_removal=True, rolling_average_window=8),
    "fold-background-high": dict(background_removal=True, rolling_average_window=8,
                                 matmul_precision="high"),
    "fold-linear": dict(interpolation=Interpolation.LINEAR),
    "fold-quadratic": dict(interpolation=Interpolation.QUADRATIC),
    "fold-lanczos": dict(interpolation=Interpolation.LANCZOS),
    "fold-no-resampling": dict(resampling=False),
    "fold-gauss-window": dict(window=(WindowType.GAUSS, 0.5, 0.8)),
    "fold-taylor-window": dict(window=(WindowType.TAYLOR, 0.45, 0.9)),
    "fold-highest-continuous": dict(matmul_precision="highest", fpn_mode=FpnMode.CONTINUOUS),
    # continuous FPN on wide samples: the planar kernel (B1, three x parts on
    # float32 lines) on every buffer, then the FPN and the scaling
    "fold-24bit-continuous": dict(bit_depth=24, bitshift=False, fpn_mode=FpnMode.CONTINUOUS),
    "fold-32bit-continuous": dict(bit_depth=32, bitshift=False, fpn_mode=FpnMode.CONTINUOUS),
    "fft-prep-8bit": dict(fft_via_matmul=False, use_pallas_prep=True, bit_depth=8,
                          bitshift=False),
    "fft-prep-16bit-high": dict(fft_via_matmul=False, use_pallas_prep=True, bit_depth=16,
                                bitshift=False, matmul_precision="high"),
    "fft-gather-linear-16bit": dict(fft_via_matmul=False, resample_via_matmul=False,
                                    interpolation=Interpolation.LINEAR, bit_depth=16,
                                    bitshift=False),
    # compute_dtype="bfloat16": x and every operator rounded to bf16, one
    # float32-accumulated product (B1 on the FPN buffer, B2 / B5 steady, B7
    # / B8 on the FFT path; the torch-ops resampler likewise)
    "bf16-fold": dict(compute_dtype="bfloat16"),
    "bf16-fold-high-ignored": dict(compute_dtype="bfloat16", matmul_precision="high"),
    "bf16-fold-xla": dict(compute_dtype="bfloat16", fold_backend="xla"),
    "bf16-fold-concat": dict(compute_dtype="bfloat16", fold_concat=True),
    "bf16-fold-concat-bf16-store": dict(compute_dtype="bfloat16", fold_concat=True,
                                        output_dtype="bfloat16"),
    "bf16-fold-fast-log": dict(compute_dtype="bfloat16", fast_log=True),
    "bf16-fold-16bit": dict(compute_dtype="bfloat16", bit_depth=16, bitshift=False),
    "bf16-fold-24bit": dict(compute_dtype="bfloat16", bit_depth=24, bitshift=False),
    "bf16-fold-post-stages": dict(compute_dtype="bfloat16", bscan_flip=True,
                                  sinusoidal_correction=True, post_background_removal=True),
    "bf16-fft-prep": dict(compute_dtype="bfloat16", fft_via_matmul=False, use_pallas_prep=True),
    "bf16-fft-prep-real": dict(compute_dtype="bfloat16", fft_via_matmul=False,
                               use_pallas_prep=True, dispersion=False),
    "bf16-fft-prep-8bit": dict(compute_dtype="bfloat16", fft_via_matmul=False,
                               use_pallas_prep=True, bit_depth=8, bitshift=False),
    "bf16-fft-matmul": dict(compute_dtype="bfloat16", fft_via_matmul=False),
}


@pytest.mark.parametrize("name", list(SLICE_CONFIGS))
def test_model_matches_jax_buffer_by_buffer(name):
    """Buffer 0 (FPN determination), two steady buffers, then a chunk of two
    with strategy "auto" (batch wherever the JAX model batches)."""
    tm, jm = _models(**SLICE_CONFIGS[name])
    raws = _buffers(5, bit_depth=tm.acq.bit_depth)
    for raw in raws[:3]:
        got = tm.process_buffer(raw)
        want = jm.process_buffer(raw)
        assert got.dtype == (torch.bfloat16 if tm.cfg.output_dtype == "bfloat16"
                             else torch.float32)
        _close(got, np.asarray(want, np.float32))
        _same_fpn(tm, jm)
    assert tm._batch_ready() == jm._batch_ready()
    got = tm.process_chunk(np.stack(raws[3:]))
    want = jm.process_chunk(np.stack(raws[3:]))
    assert tuple(got.shape) == (2, BSCANS, ASCANS, N // 2)
    _close(got, np.asarray(want, np.float32))
    _same_fpn(tm, jm)


@pytest.mark.parametrize("name", ["once-default", "once-high", "fpn-continuous",
                                  "fft-prep-default", "fft-matmul", "fft-fpn-continuous",
                                  "bf16-fold", "bf16-fft-prep"])
def test_scan_chunk_matches_jax(name):
    """strategy="scan" from a fresh FPN state: the state threads through the
    stack exactly as per-buffer calls."""
    tm, jm = _models(**SLICE_CONFIGS[name])
    stack = np.stack(_buffers(3, seed=5))
    got = tm.process_chunk(stack, strategy="scan")
    _close(got, np.asarray(jm.process_chunk(stack, strategy="scan"), np.float32))
    _same_fpn(tm, jm)
    tm2, _ = _models(**SLICE_CONFIGS[name])
    per_buffer = torch.stack([tm2.process_buffer(r) for r in stack])
    assert torch.equal(got, per_buffer)


def test_batch_equals_per_buffer_steps():
    """After FPN determination the batch kernel call over a stack equals
    the per-buffer steps (same finite mask, 1e-5)."""
    tm, _ = _models()
    raws = _buffers(4, seed=7)
    tm.process_buffer(raws[0])
    steps = [tm.process_buffer(r) for r in raws[1:]]
    batch = tm.process_chunk(np.stack(raws[1:]), strategy="batch")
    for a, b in zip(steps, batch):
        assert torch.equal(torch.isfinite(a), torch.isfinite(b))
        fin = torch.isfinite(a)
        assert torch.allclose(a[fin], b[fin], atol=1e-5, rtol=1e-5)


def test_model_controls():
    tm, _ = _models()
    raw = _buffers(1)[0]
    with pytest.raises(ValueError, match="batch"):
        tm.process_chunk(raw[None], strategy="batch")  # FPN not determined yet
    with pytest.raises(ValueError, match="strategy"):
        tm.process_chunk(raw[None], strategy="mega")
    first = tm.process_buffer(raw)
    assert tm.fpn_state.determined and tm._batch_ready()
    tm.redetermine_fpn()
    assert not tm.fpn_state.determined and not tm._batch_ready()
    assert torch.equal(tm.process_buffer(raw), first)
    tm.set_klin_coeffs(0.0, N - 1.0, 0.0, 0.0)
    assert not torch.equal(tm.process_buffer(raw), first)
    tm.set_window(WindowType.GAUSS, 0.5, 0.8)
    tm.set_dispersion_coeffs(0.0, 0.0, 2.0, 0.0)
    tm.set_custom_resample_curve(np.linspace(0, N - 3, N))
    tm.set_config(grayscale_max=80.0, output_dtype="bfloat16")
    out = tm.process_buffer(raw)
    assert out.dtype == torch.bfloat16
    fetched = tm.fetch(out)
    assert isinstance(fetched, np.ndarray) and fetched.dtype == np.float32


def test_set_config_splits_the_operator_once():
    """make_curves splits the depth operator for the configured rung; a
    rung change rebuilds the parts in the published snapshot."""
    tm, _ = _models()
    assert [len(p) for p in tm.curves.depth_parts] == [1, 1]
    # the default rung's float32 operator carries its three bf16 parts, made
    # with the curves for the steady-state kernel: with fold_concat those of
    # the wide operator, which the concat kernel reads (the per-axis parts
    # are split by the FPN buffer's kernel, at its first launch)
    assert all("split" in vars(p) and len(p.split) == 3 for p in tm.curves.depth_parts)
    concat = _models(fold_concat=True)[0].curves
    assert not any("split" in vars(p) for p in concat.depth_parts)
    assert "split" in vars(concat.depth_concat_parts) and len(concat.depth_concat_parts.split) == 3
    tm.set_config(matmul_precision="highest")
    cfg, curves, _ = tm._exec
    assert cfg.matmul_precision == "highest"
    assert [len(p) for p in curves.depth_parts] == [3, 3]
    assert all(p.dtype == torch.bfloat16 for parts in curves.depth_parts for p in parts)


@pytest.mark.parametrize("precision", ["default", "high", "highest"])
def test_fold_concat_operator_made_once_per_curve_build(monkeypatch, precision):
    """With fold_concat, make_curves holds the parts of [W_re | W_im]
    (``Curves.depth_concat_parts``, the part pairs of ``depth_parts``
    concatenated); the steady step and the batch chunk read them and form no
    operator, and give bit for bit what concatenating per call gives."""
    from octproz_tpu_torch.kernels import fused_prep as tfp

    tm, _ = _models(fold_concat=True, matmul_precision=precision)
    wide = tm.curves.depth_concat_parts
    want = tfp.concat_operator(*tm.curves.depth_parts, precision)
    assert len(wide) == len(want) and all(torch.equal(a, b) for a, b in zip(wide, want))
    assert _models()[0].curves.depth_concat_parts is None
    raws = [torch.from_numpy(r) for r in _buffers(3, seed=12)]
    tm.process_buffer(raws[0])  # FPN determination
    per_call = dataclasses.replace(tm.curves, depth_concat_parts=None)
    steady, _ = tpipeline.process_buffer(raws[1], per_call, tm.fpn_state, tm.acq, tm.cfg)
    chunk, _ = tpipeline.process_buffer(torch.stack(raws[1:]), per_call, tm.fpn_state,
                                        tm.acq, tm.cfg)

    def refuse(*args, **kw):
        raise AssertionError("the step formed the concatenated operator")

    monkeypatch.setattr(tfp, "concat_operator", refuse)
    assert torch.equal(tm.process_buffer(raws[1]), steady)
    assert torch.equal(tm.process_chunk(torch.stack(raws[1:]), strategy="batch"), chunk)


@pytest.mark.parametrize("dispersion", [True, False])
def test_prep_operator_split_once_for_the_phase_kernel(dispersion):
    """On the FFT path at the default rung the prep operator's three bf16
    parts are made with the curves: the phase kernel (with dispersion) and
    the real kernel (without) both read them on integer lines."""
    tm, _ = _models(**FFT_PREP, dispersion=dispersion)
    parts = tm.curves.prep_parts
    assert len(parts) == 1 and torch.equal(parts[0], tm.curves.prep_operator)
    assert "split" in vars(parts) and len(parts.split) == 3


UNPORTED = [dict(compute_dtype="bfloat16"), dict(fold_concat=True, compute_dtype="bfloat16")]


@pytest.mark.parametrize("changes", UNPORTED)
def test_unported_configs_raise_naming_the_roadmap(changes):
    """These configurations (bf16 compute, with and without fold_concat)
    were refused until they were ported: the constructor, make_step and
    set_config now take them, and all three give the same output."""
    acq = AcqParams(samples_per_line=N, ascans_per_bscan=ASCANS, bscans_per_buffer=BSCANS)
    cfg = dataclasses.replace(default_full_config(), **changes)
    raw = _buffers(1, seed=31)[0]
    tm = FdOctModel(acq, cfg, **KW, device="cpu")
    assert tm.cfg is cfg
    want = tm.process_buffer(raw)
    step = tpipeline.make_step(acq, cfg)
    got, _ = step(torch.from_numpy(raw), tm.curves, tpipeline.initial_fpn_state(acq, device="cpu"))
    assert torch.equal(got, want)
    other = FdOctModel(acq, default_full_config(), **KW, device="cpu")
    other.set_config(**changes)
    assert other.cfg == cfg and torch.equal(other.process_buffer(raw), want)


def test_unported_entry_points_raise():
    """A mesh that is not a parallel.Mesh, a device that is not the mesh's
    first, and neither a device nor a mesh are refused; a single-device
    model is not multi-host.  (The name is kept from the test of the
    refusal of every mesh that came before the port of the meshes.)"""
    from octproz_tpu_torch.parallel import make_mesh

    acq = AcqParams(samples_per_line=N, ascans_per_bscan=ASCANS, bscans_per_buffer=BSCANS)
    with pytest.raises(TypeError, match="parallel.Mesh"):
        FdOctModel(acq, default_full_config(), mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="device"):
        FdOctModel(acq, default_full_config())
    with pytest.raises(ValueError, match="first device"):
        FdOctModel(acq, default_full_config(), device="meta",
                   mesh=make_mesh(2, 1, devices=[torch.device("cpu")] * 2))
    tm, _ = _models()
    assert tm.is_multihost is False


def test_mesh_model_matches_single_device():
    """FdOctModel(mesh=make_mesh(2, 1, devices=[cpu] * 2)) gives the
    single-device model's volume (2e-4) and mean line (1e-4/1e-5) over the
    FPN buffer and a steady one."""
    from octproz_tpu_torch.parallel import make_mesh

    tm, _ = _models()
    acq, cfg = tm.acq, tm.cfg
    sharded = FdOctModel(acq, cfg, **KW, mesh=make_mesh(2, 1, devices=[torch.device("cpu")] * 2))
    assert sharded.device == torch.device("cpu") and not sharded.is_multihost
    rng = np.random.default_rng(11)
    for _ in range(2):
        raw = rng.integers(0, 4095, size=acq.buffer_shape, dtype=np.uint16)
        np.testing.assert_allclose(sharded.fetch(sharded.process_buffer(raw)),
                                   tm.fetch(tm.process_buffer(raw)), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(sharded.fpn_state.mean_line.numpy(),
                               tm.fpn_state.mean_line.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("changes", [
    {}, dict(fpn_mode=FpnMode.OFF), dict(fpn_mode=FpnMode.CONTINUOUS), dict(fold_backend="xla"),
    dict(fft_via_matmul=False), dict(fft_via_matmul=False, use_pallas_prep=True),
    dict(fft_via_matmul=False, resample_via_matmul=False),
    dict(fft_via_matmul=False, resampling=False, windowing=False, dispersion=False,
         fpn_mode=FpnMode.OFF),
    dict(sinusoidal_correction=True), dict(post_background_removal=True),
    dict(fft_via_matmul=False, bscan_flip=True)])
def test_preflight_footprint_matches_jax(changes):
    """The device-memory estimate is the JAX package's arithmetic, on the
    fold and the FFT path and with the post stages; a budget below it
    refuses with the breakdown; the CPU reports no limit."""
    from octproz_tpu.utils.memory import estimate_footprint as jax_estimate
    from octproz_tpu_torch.utils.memory import estimate_footprint, preflight_check

    tm, jm = _models(**changes)
    assert estimate_footprint(tm.acq, tm.cfg) == jax_estimate(jm.acq, jm.cfg)
    need = estimate_footprint(tm.acq, tm.cfg)["total"]
    with pytest.raises(MemoryError, match="raw="):
        preflight_check(tm.acq, tm.cfg, "cpu", limit_bytes=need)
    assert preflight_check(tm.acq, tm.cfg, "cpu")["total"] == need


FFT_PREP = dict(fft_via_matmul=False, use_pallas_prep=True)


@pytest.mark.parametrize("rung", ["default", "high", "highest", "xla", "fft-default",
                                  "fft-high", "fft-torch", "concat-default", "concat-high"])
def test_golden_pair_gate(rung):
    """The gate of tests/test_fidelity.py:125-127 on the port: the fold
    path at each rung and backend, the FFT path through the prep kernels at
    default and high, and through torch ops; with fold_concat the buffer a
    second time, once its FPN is determined, so the concat kernel's plain
    version makes the compared output."""
    changes = {"xla": dict(fold_backend="xla"),
               "fft-default": FFT_PREP,
               "fft-high": dict(FFT_PREP, matmul_precision="high"),
               "fft-torch": dict(fft_via_matmul=False),
               "concat-default": dict(fold_concat=True, steady=True),
               "concat-high": dict(fold_concat=True, matmul_precision="high", steady=True),
               }.get(rung, dict(matmul_precision=rung))
    res = bench.golden_pair("cpu", **changes)
    assert res.psnr_db >= 60.0, res
    assert res.min_bscan_psnr_db >= 55.0, res
    assert res.mean_ssim >= 0.99, res


LADDER_ACQ = AcqParams(samples_per_line=128, ascans_per_bscan=16, bscans_per_buffer=2)
LADDER_KW = dict(resample_coeffs=(0.0, 127.0, 10.0, -4.0),
                 dispersion_coeffs=(0.0, 0.0, 8.0, 0.0), window_type=WindowType.HANNING)


def _ladder(fpn_on: bool, rungs=("default", "high", "highest"), **changes):
    """PSNR (dB, display range) per rung (``bench.at_rung``) vs the float64
    oracle, as tests/test_pallas.py:285-361 measures it."""
    import oracle

    cfg = ProcConfig(**{"resampling": True, "interpolation": Interpolation.CUBIC,
                        "windowing": True, "dispersion": True, "log_scaling": True,
                        "fft_via_matmul": True,
                        "fpn_mode": FpnMode.ONCE if fpn_on else FpnMode.OFF,
                        "bscans_for_noise": 2, **changes})
    cv = tcurves.make_curves(LADDER_ACQ, cfg, **LADDER_KW, device="cpu")
    raw = np.random.default_rng(1234).integers(0, 4095, size=LADDER_ACQ.buffer_shape
                                                ).astype(np.uint16)
    want, _ = oracle.full_pipeline(
        raw, LADDER_ACQ.bit_depth, resample_curve=np.asarray(cv.resample_curve),
        interpolation="cubic", window=np.asarray(cv.window), phase=np.asarray(cv.phase),
        fpn_lines=LADDER_ACQ.ascans_per_bscan * 2 if fpn_on else 0,
        log_scaling=True, gmin=cfg.grayscale_min, gmax=cfg.grayscale_max,
        addend=cfg.addend, coeff=cfg.multiplicator)
    ref = np.clip(np.asarray(want, np.float64), 0, 1)
    out = {}
    for rung in rungs:
        m = FdOctModel(LADDER_ACQ, bench.at_rung(cfg, rung), **LADDER_KW, device="cpu")
        g = np.clip(m.fetch(m.process_buffer(raw)).astype(np.float64), 0, 1)
        out[rung] = 10 * np.log10(1.0 / max(float(np.mean((g - ref) ** 2)), 1e-30))
    return out


def test_precision_ladder_vs_float64_oracle():
    """FPN off.  On the CPU the default rung is true float32; the split
    rungs keep their budgets: high in the 50.6 dB acquisition bound,
    highest at float32 grade and clearly above high."""
    p = _ladder(fpn_on=False)
    assert p["default"] >= bench.ORACLE_GATE_DB["default"], p
    assert p["high"] >= bench.IN_BOUND_SNR_DB, p
    assert p["highest"] > p["high"] + 10.0, p
    assert p["highest"] > 85.0, p


def test_precision_ladder_fpn_on():
    """With the tie-banded FPN the rungs keep their grade end to end."""
    p = _ladder(fpn_on=True)
    assert p["high"] > 55.0, p
    assert p["highest"] > 80.0, p


@pytest.mark.parametrize("path", [{}, dict(fold_concat=True), FFT_PREP,
                                  dict(fft_via_matmul=False)],
                         ids=["fold", "concat", "fft-prep", "fft-matmul"])
def test_bf16_rung_vs_float64_oracle(path):
    """compute_dtype="bfloat16" clears the default rung's 20 dB gate and
    sits at least 20 dB below float32 compute on every path: a bf16 run
    that took a float32-grade route would read as float32 (FPN off)."""
    p = _ladder(False, rungs=("default", "bfloat16"), **path)
    assert p["bfloat16"] >= bench.ORACLE_GATE_DB["bfloat16"], p
    assert p["bfloat16"] <= p["default"] - 20.0, p


@pytest.mark.parametrize("fpn_on", [False, True])
def test_precision_ladder_fft_path(fpn_on):
    """The FFT path through the prep kernels: the same gates as the fold
    path (FPN off: default, high in the 50.6 dB bound, highest clearly
    above high and above 85 dB; FPN on: high > 55, highest > 80).  The
    float32 FFT adds rounding of its own, below the highest rung's here
    (CPU: about 144 dB against 109 dB at 128 samples)."""
    p = _ladder(fpn_on, **FFT_PREP)
    if fpn_on:
        assert p["high"] > 55.0 and p["highest"] > 80.0, p
        return
    assert p["default"] >= bench.ORACLE_GATE_DB["default"], p
    assert p["high"] >= bench.IN_BOUND_SNR_DB, p
    assert p["highest"] > p["high"] + 10.0, p
    assert p["highest"] > 85.0, p


def test_interop_round_trip():
    """JAX curves and FPN state carried into the port: the curves are the
    port's own to the byte, and the port continues the JAX model's stream."""
    tm, jm = _models()
    raws = _buffers(2, seed=3)
    jm.process_buffer(raws[0])
    jc = jm.curves
    fields = {f.name: (None if getattr(jc, f.name) is None else np.asarray(getattr(jc, f.name)))
              for f in dataclasses.fields(jcurves.Curves)}
    carried = interop.curves_from_numpy(fields, "cpu")
    own = tm.curves
    assert torch.equal(carried.depth_op_re, own.depth_op_re)
    assert torch.equal(carried.depth_op_im, own.depth_op_im)
    state = interop.fpn_state_from_numpy(np.asarray(jm.fpn_state.mean_line),
                                         bool(jm.fpn_state.determined), "cpu")
    got, state2 = tpipeline.process_buffer(torch.from_numpy(raws[1]), carried, state,
                                           tm.acq, tm.cfg)
    assert state2 is state  # steady state: the mean line is an input
    _close(got, np.asarray(jm.process_buffer(raws[1]), np.float32))
    back = interop.to_numpy(carried)
    for name, arr in fields.items():
        assert (arr is None) == (back[name] is None)
        if arr is not None:
            np.testing.assert_array_equal(back[name], arr)
    mean, determined = interop.to_numpy(state)
    assert determined and np.array_equal(mean, np.asarray(jm.fpn_state.mean_line))
    with pytest.raises(ValueError):
        interop.curves_from_numpy({"not_a_field": None}, "cpu")
    with pytest.raises(ValueError):
        interop.fpn_state_from_numpy(np.zeros(4), False, "cpu")


def test_jax_step_functions_agree():
    """make_step / make_scan_step / initial_fpn_state: the functional API."""
    tm, _ = _models()
    jacq = jparams.AcqParams(samples_per_line=N, ascans_per_bscan=ASCANS,
                             bscans_per_buffer=BSCANS)
    jcfg = dataclasses.replace(jparams.default_full_config(), bitshift=True,
                               bscans_for_noise=2)
    jcv = jcurves.make_curves(jacq, jcfg, **JKW)
    raws = _buffers(2, seed=11)
    st = tpipeline.initial_fpn_state(tm.acq, device="cpu")
    assert tuple(st.mean_line.shape) == (2, N // 2) and not st.determined
    step = tpipeline.make_step(tm.acq, tm.cfg)
    jstep = jpipeline.make_step(jacq, jcfg)
    jst = jpipeline.initial_fpn_state(jacq)
    for raw in raws:
        got, st = step(torch.from_numpy(raw), tm.curves, st)
        want, jst = jstep(jnp.asarray(raw), jcv, jst)
        _close(got, np.asarray(want))


@pytest.mark.parametrize("make", ["initial_fpn_state", "FpnState.initial"])
def test_fpn_state_needs_a_device(make):
    """The FPN state's device is a required keyword, as for make_curves and
    FdOctModel: a call without it raises instead of landing on the CPU."""
    from octproz_tpu_torch.params import FpnState

    acq = AcqParams(samples_per_line=N, ascans_per_bscan=ASCANS, bscans_per_buffer=BSCANS)
    fn = {"initial_fpn_state": lambda **kw: tpipeline.initial_fpn_state(acq, **kw),
          "FpnState.initial": lambda **kw: FpnState.initial(N // 2, **kw)}[make]
    with pytest.raises(TypeError):
        fn()
    assert fn(device="cpu").mean_line.device.type == "cpu"


PRESET_CASES =[("benchmark", False), ("minimal", False), ("handheld", False),
                ("handheld", True)]


@pytest.mark.parametrize("name,tpu", PRESET_CASES)
def test_presets_match_jax(name, tpu):
    """Every preset on the FFT path (tpu=False) and the handheld preset on
    the fold path: the same configuration and geometry as the JAX
    package's, and the same output at a small geometry, buffer by buffer
    and by chunk."""
    import octproz_tpu.models.presets as jpresets
    from octproz_tpu_torch.models import presets as tpresets

    fns = {"benchmark": "benchmark_config", "minimal": "minimal_config",
           "handheld": "handheld_sinusoidal_config"}
    cfg = getattr(tpresets, fns[name])(tpu=tpu)
    assert _jax_cfg(cfg) == getattr(jpresets, fns[name])(tpu=tpu)
    assert dataclasses.asdict(tpresets.figshare_test_volume()) == \
        dataclasses.asdict(jpresets.figshare_test_volume())
    assert set(tpresets.PRESETS) == set(jpresets.PRESETS)
    assert cfg.fft_via_matmul == tpu
    tm, jm = _models(cfg)
    raws = _buffers(4, seed=21)
    for raw in raws[:2]:
        _close(tm.process_buffer(raw), np.asarray(jm.process_buffer(raw), np.float32))
        _same_fpn(tm, jm)
    assert tm._batch_ready() == jm._batch_ready() == tpu
    _close(tm.process_chunk(np.stack(raws[2:])),
           np.asarray(jm.process_chunk(np.stack(raws[2:])), np.float32))


@pytest.mark.parametrize("name", ["once-default", "fft-prep-default"])
def test_process_volume_matches_jax(name):
    """A (buffers, bscans, ascans, samples) volume -> (buffers * bscans,
    ascans, samples // 2), the FPN state carried from buffer to buffer; a
    single buffer is processed as one."""
    tm, jm = _models(**SLICE_CONFIGS[name])
    vol = np.stack(_buffers(3, seed=8))
    got = tm.process_volume(vol)
    assert tuple(got.shape) == (3 * BSCANS, ASCANS, N // 2)
    _close(got, np.asarray(jm.process_volume(vol), np.float32))
    _same_fpn(tm, jm)
    one = tm.process_volume(vol[0])
    _close(one, np.asarray(jm.process_volume(vol[0]), np.float32))


def test_interop_round_trip_fft_path():
    """The JAX model's prep operator and phasor carried into the port on
    the FFT path: equal to the port's own, and the port continues the JAX
    model's stream with them (split per call: carried curves have no
    prep_parts)."""
    tm, jm = _models(**FFT_PREP)
    raws = _buffers(2, seed=4)
    jm.process_buffer(raws[0])
    jc = jm.curves
    fields = {f.name: (None if getattr(jc, f.name) is None else np.asarray(getattr(jc, f.name)))
              for f in dataclasses.fields(jcurves.Curves)}
    carried = interop.curves_from_numpy(fields, "cpu")
    assert carried.prep_parts is None and tm.curves.prep_parts is not None
    assert torch.equal(carried.prep_operator, tm.curves.prep_operator)
    assert torch.equal(carried.phase, tm.curves.phase)
    state = interop.fpn_state_from_numpy(np.asarray(jm.fpn_state.mean_line),
                                         bool(jm.fpn_state.determined), "cpu")
    got, _ = tpipeline.process_buffer(torch.from_numpy(raws[1]), carried, state,
                                      tm.acq, tm.cfg)
    _close(got, np.asarray(jm.process_buffer(raws[1]), np.float32))
    back = interop.to_numpy(tm.curves)
    assert "prep_parts" not in back and "depth_parts" not in back
    np.testing.assert_array_equal(back["prep_operator"], fields["prep_operator"])
    np.testing.assert_array_equal(back["phase"], fields["phase"])


def test_interop_round_trip_fold_concat():
    """Curves carried in from the JAX package hold no split parts: the
    wrapper concatenates the float32 operators and splits them per call, and
    the port continues the JAX model's stream through the concat kernels."""
    tm, jm = _models(fold_concat=True, matmul_precision="high")
    raws = _buffers(2, seed=6)
    jm.process_buffer(raws[0])
    jc = jm.curves
    fields = {f.name: (None if getattr(jc, f.name) is None else np.asarray(getattr(jc, f.name)))
              for f in dataclasses.fields(jcurves.Curves)}
    carried = interop.curves_from_numpy(fields, "cpu")
    assert carried.depth_parts is None and len(tm.curves.depth_parts[0]) == 2
    state = interop.fpn_state_from_numpy(np.asarray(jm.fpn_state.mean_line),
                                         bool(jm.fpn_state.determined), "cpu")
    got, _ = tpipeline.process_buffer(torch.from_numpy(raws[1]), carried, state,
                                      tm.acq, tm.cfg)
    _close(got, np.asarray(jm.process_buffer(raws[1]), np.float32))
    assert "depth_parts" not in interop.to_numpy(tm.curves)
