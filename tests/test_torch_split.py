"""The kernels on bf16 tensor cores (``csrc/fold_split.cuh``,
``csrc/prep_split.cu``) -- the split rungs (the concat kernels' as two views
of each wide part), and the one-pass rung of every family on three bf16
parts of its float32 operator -- and the bench's kernel yardsticks.

The CUDA kernel cannot run here, so its arithmetic is emulated in torch
(:func:`staged`): per stage of 64 samples, the pass terms go low-order first
-- x_lo w_(P-2), ..., x_lo w_0, then x_hi w_(P-1), ..., x_hi w_0 -- into
one float32 partial sum per axis, which is then added to the running sum;
a 64-line group skips a stage's x_lo terms when its x_lo tile is zero.  That
order is held against the plain versions (``depth_plain`` /
``depth_scale_plain`` / ``prep_phase_plain`` / ``prep_real_plain``, one
float32 product per term over the whole contraction, summed low-order
first) within the kernels' own bounds (``fused_prep.PLANAR_REL_L2``,
``SCALE_RMS``, ``SCALE_MAX``, ``PREP_REL_L2``, reasons stated there), and
the two controls -- the "highest" parts through the 3-pass
math, the 3-pass math without x_lo -- still fail them.  The kernel itself
is held to the same bounds on the card (``tests/test_torch_kernels.py``,
``chip_smoke.py``).

At the default rung the plain version is the semantics, one float32 product
per axis, and not a replay of the kernel's terms: the staged three-part terms
are held against it for integer samples of up to 16 bits, its own controls
(two of the three parts; no x_lo) fail, and float32 lines above 16 bits miss
the bound through the two-part split of x.  The same holds for the concat
kernel (two views of the wide operator's three parts) and the prep kernels
at one pass.  Float32 lines of every one-pass family -- the planar kernel
(B1), the scaled kernels (B2, and B5 on the two views of the wide
operator's parts) and the prep kernels (B7, B8) -- split x into three parts
at one pass (:func:`staged3`: x_lo w_0, x_mid w_1, x_mid w_0, x_hi w_2, x_hi
w_1, x_hi w_0 per stage, the x_lo group skipped where a tile is exact in 16
bits and the x_mid group too where it is exact in bf16), held against the
plain versions and the JAX package at ``bit_depth=24``; without x_lo w_0
(five terms) they fail.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from octproz_tpu_torch import bench
from octproz_tpu_torch import curves as tcurves
from octproz_tpu_torch.kernels import fused_prep as tfp
from octproz_tpu_torch.params import AcqParams, default_full_config
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

STAGE = 64   # samples per pipeline stage (split.DEPTH)
GROUP = 64   # lines per consumer warpgroup


def _operators(n):
    acq = AcqParams(samples_per_line=n, ascans_per_bscan=8, bscans_per_buffer=1)
    cfg = dataclasses.replace(default_full_config(), bitshift=True)
    cv = tcurves.make_curves(acq, cfg, resample_coeffs=(0.0, n - 1.0, 10.0, -4.0),
                             dispersion_coeffs=(0.0, 0.0, 8.0, 0.0), device="cpu")
    return cv.depth_op_re, cv.depth_op_im


#: Float32 lines by the bits of their samples: 24 ("f32") and 32 ("f32w")
#: bits, and 16-bit values as float32 ("f16": x_lo zero).
FLOAT_BITS = {"f32": 24, "f32w": 32, "f16": 16}


def _input(kind, lines, n, seed=11):
    """(raw, bitshift): shifted 12-bit samples (x_lo zero, as on the main
    path), unshifted 12-bit, full 16-bit ("u16f"), uint8, or float input
    decoded before the kernel (:data:`FLOAT_BITS`)."""
    rng = np.random.default_rng(seed)
    if kind in FLOAT_BITS:
        vals = rng.integers(0, 1 << FLOAT_BITS[kind], size=(lines, n), dtype=np.int64)
        return torch.from_numpy(vals.astype(np.float32)), False
    if kind == "u8":
        return torch.from_numpy(rng.integers(0, 256, size=(lines, n)).astype(np.uint8)), False
    if kind == "u16f":
        return torch.from_numpy(rng.integers(0, 1 << 16, size=(lines, n)).astype(np.uint16)), False
    raw = torch.from_numpy(rng.integers(0, 4096, size=(lines, n)).astype(np.uint16))
    return raw, kind == "u16s"


def staged(x, parts, vote=True):
    """The kernel's sum of the pass terms of ``x @ w`` (w in bf16 ``parts``)."""
    hi = tfp._bf16_trunc(x)
    lo = (x - hi).to(torch.bfloat16).to(torch.float32)
    w = [p.to(torch.float32) for p in parts]
    acc = torch.zeros((x.shape[0], w[0].shape[1]))
    for k0 in range(0, x.shape[1], STAGE):
        ks = slice(k0, k0 + STAGE)
        for m0 in range(0, x.shape[0], GROUP):
            ms = slice(m0, m0 + GROUP)
            has_lo = not vote or bool(lo[ms, ks].ne(0).any())
            terms = ([lo[ms, ks] @ w[j][ks] for j in range(len(w) - 2, -1, -1)]
                     if has_lo else []) + [hi[ms, ks] @ w[j][ks]
                                           for j in range(len(w) - 1, -1, -1)]
            part = terms[0]
            for t in terms[1:]:
                part = part + t
            acc[ms] = acc[ms] + part
    return acc


def x_split3(x):
    """x as three bf16-exact parts, each the mask truncation of what the
    parts above leave (``pack3`` in ``csrc/fold_split.cuh``): x_hi + x_mid +
    x_lo == x for any float32 x."""
    hi = tfp._bf16_trunc(x)
    mid = tfp._bf16_trunc(x - hi)
    return hi, mid, x - hi - mid


def staged3(x, parts, vote=True, x_lo_terms=True):
    """The three-x-part kernel's sum (float32 lines at one pass, against the
    float32 operator's three bf16 ``parts``): per 64-sample stage and
    64-line group, x_lo w_0, then x_mid w_1, x_mid w_0, then x_hi w_2, x_hi
    w_1, x_hi w_0 into one float32 partial sum, added to the running sum.
    The vote skips the x_lo group where the tile's x_lo is zero, the x_mid
    group too where its x_mid is.  ``x_lo_terms=False`` drops x_lo w_0 (the
    five-term control)."""
    hi, mid, lo = x_split3(x)
    w = [p.to(torch.float32) for p in parts]
    acc = torch.zeros((x.shape[0], w[0].shape[1]))
    for k0 in range(0, x.shape[1], STAGE):
        ks = slice(k0, k0 + STAGE)
        for m0 in range(0, x.shape[0], GROUP):
            ms = slice(m0, m0 + GROUP)
            has_mid = not vote or bool(mid[ms, ks].ne(0).any())
            has_lo = has_mid and (not vote or bool(lo[ms, ks].ne(0).any())) and x_lo_terms
            terms = ([lo[ms, ks] @ w[0][ks]] if has_lo else []) \
                + ([mid[ms, ks] @ w[j][ks] for j in (1, 0)] if has_mid else []) \
                + [hi[ms, ks] @ w[j][ks] for j in (2, 1, 0)]
            part = terms[0]
            for t in terms[1:]:
                part = part + t
            acc[ms] = acc[ms] + part
    return acc


def kernel_sums(raw, x, parts, family):
    """The sums of the kernel of ``family`` that a launch on (raw, parts)
    runs: the staged terms of the bf16 parts -- at one pass the float32
    operator's three (the wrapper's operands, ``fused_prep._kernel_operands``),
    with three x parts on float32 lines."""
    if isinstance(parts, tfp.OnePass):
        assert tfp._kernel_operands(raw, (parts,), family)[3] == "tensor_core"
        return (staged3 if raw.dtype == torch.float32 else staged)(x, parts.split)
    return staged(x, parts)


def _staged_scale(x, wre, wim, mean2, a, b, raw=None, fast_log=False, family="depth_scale"):
    raw = x if raw is None else raw
    re = kernel_sums(raw, x, wre, family) - mean2[0:1]
    im = kernel_sums(raw, x, wim, family) - mean2[1:2]
    return tfp._scale_epilogue(re * re + im * im, log_scaling=True, a=a, b=b,
                               fast_log=fast_log)


def _scale_args(half, seed=5):
    mean2 = torch.from_numpy(np.random.default_rng(seed).normal(0, 50.0, size=(2, half))
                             .astype(np.float32))
    a, b = tfp._scale_affine(True, half, 0.0, 60.0, 0.0, 1.0)
    return mean2, a, b


@pytest.mark.parametrize("precision", ["default", "high", "highest"])
@pytest.mark.parametrize("kind", ["u16s", "u16", "u16f", "u8", "f32"])
@pytest.mark.parametrize("n,lines", [(256, 200), (320, 130)])
def test_staged_order_within_the_planar_bound(precision, kind, n, lines):
    """The staged order against depth_plain: n = 320 ends on a partial
    stage, 130 and 200 lines on a partial 64-line group.  At "default" the
    reference is the float32 product and the kernel's sums are the three-part
    terms (with three x parts on float32 lines)."""
    wre, wim = (tfp._operator_parts(w, precision) for w in _operators(n))
    raw, bitshift = _input(kind, lines, n)
    x = tfp._decode_block(raw, bitshift)
    err = tfp.planar_error([kernel_sums(raw, x, w, "depth") for w in (wre, wim)],
                           tfp.depth_plain(raw, wre, wim, bitshift=bitshift))
    assert err <= tfp.PLANAR_REL_L2, err


@pytest.mark.parametrize("precision", ["default", "high", "highest"])
@pytest.mark.parametrize("kind", ["u16s", "u16", "u16f", "u8", "f32"])
def test_staged_order_within_the_scale_bounds(precision, kind):
    wre, wim = (tfp._operator_parts(w, precision) for w in _operators(256))
    raw, bitshift = _input(kind, 200, 256)
    mean2, a, b = _scale_args(128)
    got = _staged_scale(tfp._decode_block(raw, bitshift), wre, wim, mean2, a, b, raw=raw)
    want = tfp.depth_scale_plain(raw, wre, wim, mean2, bitshift=bitshift, log_scaling=True,
                                 a=a, b=b)
    rms, worst, ok = tfp.scale_error(got, want)
    assert ok, (rms, worst)


@pytest.mark.parametrize("kind", ["u16s", "u16f"])
def test_staged_order_within_the_scale_bounds_with_fast_log(kind):
    """The default rung is the only one the wrapper passes ``fast_log`` to:
    the three-part terms through the polynomial log2 against the plain
    version's."""
    wre, wim = (tfp._operator_parts(w, "default") for w in _operators(256))
    raw, bitshift = _input(kind, 200, 256)
    mean2, a, b = _scale_args(128)
    got = _staged_scale(tfp._decode_block(raw, bitshift), wre, wim, mean2, a, b, raw=raw,
                        fast_log=True)
    want = tfp.depth_scale_plain(raw, wre, wim, mean2, bitshift=bitshift, log_scaling=True,
                                 a=a, b=b, fast_log=True)
    rms, worst, ok = tfp.scale_error(got, want)
    assert ok, (rms, worst)


@pytest.mark.parametrize("epi", ["planar", "scale", "concat"])
@pytest.mark.parametrize("control", ["two of the three parts", "no x_lo"])
def test_default_rung_controls_fail_under_the_staged_order(epi, control):
    """The one-pass rung's neighbours -- the "high" parts, or the three-part
    math without x_lo on unshifted samples -- fail the bounds against the
    float32 product; for the concat kernel on the two views of the wide
    operator's parts."""
    ops = [tfp._operator_parts(w, "default") for w in _operators(256)]
    raw, _ = _input("u16", 200, 256)
    x = raw.to(torch.float32)
    split = [w.split for w in ops]
    if epi == "concat":
        wide = tfp.concat_operator(*ops, "default")
        split = concat_views(wide.split)
    if control == "no x_lo":
        kernel_x, kernel_parts = tfp._bf16_trunc(x), split
    else:
        kernel_x, kernel_parts = x, [w[:2] for w in split]
    if epi == "concat":
        mean2, a, b = _scale_args(128)
        rms, _, ok = tfp.scale_error(
            _staged_scale(kernel_x, *kernel_parts, mean2, a, b),
            tfp.depth_scale_concat_plain(x, wide, mean2, bitshift=False, log_scaling=True,
                                         a=a, b=b))
        assert not ok and rms > 2 * tfp.SCALE_RMS, rms
    elif epi == "planar":
        err = tfp.planar_error([staged(kernel_x, p) for p in kernel_parts],
                               tfp.depth_plain(x, *ops, bitshift=False))
        assert err > 2 * tfp.PLANAR_REL_L2, err
    else:
        mean2, a, b = _scale_args(128)
        rms, _, ok = tfp.scale_error(_staged_scale(kernel_x, *kernel_parts, mean2, a, b),
                                     tfp.depth_scale_plain(x, *ops, mean2, bitshift=False,
                                                           log_scaling=True, a=a, b=b))
        assert not ok and rms > 2 * tfp.SCALE_RMS, rms


@pytest.mark.parametrize("epi", ["planar", "scale", "concat"])
def test_float_lines_above_16_bits_miss_the_bound_through_the_split(epi):
    """x_hi + x_lo keeps 16 bits of a sample: 24-bit float32 lines through
    the two-x-part terms miss the one-pass rung's bounds, which is why the
    kernels split x in three at one pass on float32 lines
    (:func:`staged3`), which holds them; for the concat kernel the terms of
    the two views of the wide operator's three parts, with two x parts and
    with three."""
    ops = [tfp._operator_parts(w, "default") for w in _operators(256)]
    raw, _ = _input("f32", 200, 256)
    if epi == "concat":
        wide = tfp.concat_operator(*ops, "default")
        mean2, a, b = _scale_args(128)
        want = tfp.depth_scale_concat_plain(raw, wide, mean2, bitshift=False, log_scaling=True,
                                            a=a, b=b)
        rms, _, ok = tfp.scale_error(_staged_scale(raw, *concat_views(wide.split), mean2, a, b),
                                     want)
        assert not ok and rms > 2 * tfp.SCALE_RMS, rms
        assert tfp._kernel_operands(raw, (wide,), "depth_scale_concat")[3] == "tensor_core"
        re, im = (staged3(raw, view) - mean2[i:i + 1]
                  for i, view in enumerate(concat_views(wide.split)))
        got = tfp._scale_epilogue(re * re + im * im, log_scaling=True, a=a, b=b)
        assert tfp.scale_error(got, want)[2]
    elif epi == "planar":
        want = tfp.depth_plain(raw, *ops, bitshift=False)
        assert tfp.planar_error([staged(raw, w.split) for w in ops], want) > 2 * tfp.PLANAR_REL_L2
        assert tfp._kernel_operands(raw, ops, "depth")[3] == "tensor_core"
        assert tfp.planar_error([staged3(raw, w.split) for w in ops], want) <= tfp.PLANAR_REL_L2
    else:
        mean2, a, b = _scale_args(128)
        want = tfp.depth_scale_plain(raw, *ops, mean2, bitshift=False, log_scaling=True, a=a, b=b)
        rms, _, ok = tfp.scale_error(_staged_scale(raw, *[w.split for w in ops], mean2, a, b), want)
        assert not ok and rms > 2 * tfp.SCALE_RMS, rms
        assert tfp.scale_error(_staged_scale(raw, *ops, mean2, a, b), want)[2]


def _scale_f64(x, ops, mean2, a, b):
    """The scaled image of the float32 operators' product in float64,
    rounded once to float32 before the log."""
    m = mean2.double()
    re = x.double() @ ops[0][0].double() - m[0:1]
    im = x.double() @ ops[1][0].double() - m[1:2]
    return tfp._scale_epilogue((re * re + im * im).float(), log_scaling=True, a=a, b=b)


@pytest.mark.parametrize("kind", ["f32", "f32w", "f16"])
@pytest.mark.parametrize("n,lines", [(256, 200), (320, 130), (1024, 130)])
def test_three_x_parts_within_the_scale_bounds(kind, n, lines):
    """The scaled kernel's one pass on float32 lines (B2): the six terms of
    three x parts (five where a stage's samples are exact in 16 bits, as
    "f16" is) against depth_scale_plain within the scale bounds, on 24- and
    32-bit samples; n = 320 ends on a partial stage, 130 and 200 lines on a
    partial 64-line group.  The route is the wrapper's, and the staged sum
    stands at least as close to the float64 product as the plain version
    does."""
    ops = [tfp._operator_parts(w, "default") for w in _operators(n)]
    raw, _ = _input(kind, lines, n)
    assert tfp._kernel_operands(raw, ops, "depth_scale")[3] == "tensor_core"
    mean2, a, b = _scale_args(n // 2)
    got = _staged_scale(raw, *ops, mean2, a, b)
    want = tfp.depth_scale_plain(raw, *ops, mean2, bitshift=False, log_scaling=True, a=a, b=b)
    rms, worst, ok = tfp.scale_error(got, want)
    assert ok, (rms, worst)
    exact = _scale_f64(raw, ops, mean2, a, b)
    assert tfp.scale_error(got, exact)[0] <= tfp.scale_error(want, exact)[0] + tfp.SCALE_RMS / 10


@pytest.mark.parametrize("epi", ["scale", "phase", "concat", "real", "planar"])
@pytest.mark.parametrize("kind", ["f32", "f32w"])
def test_three_x_parts_five_term_control_fails(epi, kind):
    """Control: the three-x-part kernel without x_lo w_0 (five terms) fails
    the bounds against the float32 product on 24- and 32-bit lines, planar
    (B1), scaled (B2, and B5 on the two views of the wide operator's
    parts), phase (B7) and real (B8), both with background removal."""
    raw, _ = _input(kind, 200, 256)
    if epi == "planar":
        ops = [tfp._operator_parts(w, "default") for w in _operators(256)]
        err = tfp.planar_error([staged3(raw, w.split, x_lo_terms=False) for w in ops],
                               tfp.depth_plain(raw, *ops, bitshift=False))
        assert err > 2 * tfp.PLANAR_REL_L2, err
    elif epi in ("scale", "concat"):
        ops = [tfp._operator_parts(w, "default") for w in _operators(256)]
        mean2, a, b = _scale_args(128)
        kw = dict(bitshift=False, log_scaling=True, a=a, b=b)
        if epi == "scale":
            views = [w.split for w in ops]
            want = tfp.depth_scale_plain(raw, *ops, mean2, **kw)
        else:
            wide = tfp.concat_operator(*ops, "default")
            views = concat_views(wide.split)
            want = tfp.depth_scale_concat_plain(raw, wide, mean2, **kw)
        re, im = (staged3(raw, view, x_lo_terms=False) - mean2[i:i + 1]
                  for i, view in enumerate(views))
        got = tfp._scale_epilogue(re * re + im * im, log_scaling=True, a=a, b=b)
        rms, _, ok = tfp.scale_error(got, want)
        assert not ok and rms > 2 * tfp.SCALE_RMS, rms
    else:
        op, rows = _prep_operator(256, True)
        rows = rows if epi == "phase" else None
        one = tfp._operator_parts(op, "default")
        err = tfp.prep_error(_staged3_prep(raw, one, rows, x_lo_terms=False),
                             _prep_plain(raw, one, rows, False))
        assert err > 2 * tfp.PREP_REL_L2, err


@pytest.mark.parametrize("kind", ["f16", "u16f"])
def test_three_x_parts_vote_changes_no_bit(kind):
    """16-bit values as float32 lines have no x_lo, 8-bit ones no x_mid
    either: the votes skip those groups and the sums are bit for bit those
    of all six terms (adding exact zeros changes no sum)."""
    wre, _ = _operators(256)
    parts = tfp._operator_parts(wre, "default").split
    raw, _ = _input(kind, 200, 256)
    x = raw.to(torch.float32)
    _, mid, lo = x_split3(x)
    assert not bool(lo.ne(0).any()) and bool(mid.ne(0).any())
    assert torch.equal(staged3(x, parts), staged3(x, parts, vote=False))
    x8 = (x / 256).floor()
    assert not bool(x_split3(x8)[1].ne(0).any())
    assert torch.equal(staged3(x8, parts), staged3(x8, parts, vote=False))
    assert tfp.x_parts(x8) == 1 and tfp.x_parts(x) == 2


def test_x_parts_of_float_lines():
    """x_hi + x_mid + x_lo is x exactly for any float32, so 24- and 32-bit
    samples need three parts, which the vote keeps."""
    for kind in ("f32", "f32w"):
        x, _ = _input(kind, 64, 256)
        hi, mid, lo = x_split3(x)
        assert all(torch.equal(p, tfp._bf16_trunc(p)) for p in (hi, mid, lo))
        assert torch.equal(hi + mid + lo, x) and tfp.x_parts(x) == 3


def test_one_pass_operator_carries_its_parts_once():
    """An OnePass is the 1-tuple of the float32 operator the plain versions
    read; its three bf16 parts are made at first use and kept, pass through
    ``_operator_parts`` unchanged, and sum to the operator to ~2^-24."""
    w = _operators(256)[0]
    op = tfp._operator_parts(w, "default")
    assert isinstance(op, tfp.OnePass) and len(op) == 1 and torch.equal(op[0], w)
    assert "split" not in vars(op)
    parts = op.split
    assert op.split is parts and tfp._operator_parts(op, "default") is op
    assert len(parts) == 3 and all(q.dtype == torch.bfloat16 for q in parts)
    assert all(torch.equal(q, r) for q, r in zip(parts, tfp._operator_parts(w, "highest")))
    total = sum(q.double() for q in parts)
    assert float((total - w.double()).abs().max()) <= 2.0 ** -22 * float(w.abs().max())
    given = tfp.OnePass(w, split=parts[:2])
    assert given.split == tuple(parts[:2])


@pytest.mark.parametrize("epi", ["planar", "scale"])
@pytest.mark.parametrize("control", ["3-pass math on the highest parts", "no x_lo"])
def test_controls_still_fail_under_the_staged_order(epi, control):
    """A kernel computing a neighbouring rung in the staged order fails the
    bounds against the plain version of the right rung."""
    wre, wim = _operators(256)
    raw, _ = _input("u16", 200, 256)
    x = raw.to(torch.float32)
    if control == "no x_lo":
        parts = [tfp._operator_parts(w, "high") for w in (wre, wim)]
        kernel_x, kernel_parts = tfp._bf16_trunc(x), parts
    else:
        parts = [tfp._operator_parts(w, "highest") for w in (wre, wim)]
        kernel_x, kernel_parts = x, [p[:2] for p in parts]
    if epi == "planar":
        err = tfp.planar_error([staged(kernel_x, p) for p in kernel_parts],
                               tfp.depth_plain(x, *parts, bitshift=False))
        assert err > 2 * tfp.PLANAR_REL_L2, err
    else:
        mean2, a, b = _scale_args(128)
        rms, _, ok = tfp.scale_error(_staged_scale(kernel_x, *kernel_parts, mean2, a, b),
                                     tfp.depth_scale_plain(x, *parts, mean2, bitshift=False,
                                                           log_scaling=True, a=a, b=b))
        assert not ok and rms > 2 * tfp.SCALE_RMS, rms


@pytest.mark.parametrize("precision", ["high", "highest"])
def test_skipping_zero_x_lo_changes_no_bit(precision):
    """Shifted 12-bit samples are exact in bf16, so every x_lo tile is zero:
    the vote skips those terms and the sums are bit for bit those with
    them."""
    wre, _ = _operators(256)
    parts = tfp._operator_parts(wre, precision)
    raw, bitshift = _input("u16s", 200, 256)
    x = tfp._decode_block(raw, bitshift)
    assert torch.equal(x, tfp._bf16_trunc(x))
    assert torch.equal(staged(x, parts, vote=True), staged(x, parts, vote=False))


# ---------------------------------------------------------------------------
# The split-rung prep kernels (csrc/prep_split.cu): the same pipeline with
# one operator, the prep operator P, against prep_phase_plain /
# prep_real_plain within PREP_REL_L2
# ---------------------------------------------------------------------------

def _prep_operator(n, background_removal):
    """The FFT path's prep operator (n, n) and phasor rows at n samples."""
    acq = AcqParams(samples_per_line=n, ascans_per_bscan=8, bscans_per_buffer=1)
    cfg = bench.fft_config(background_removal=background_removal)
    cv = tcurves.make_curves(acq, cfg, resample_coeffs=(0.0, n - 1.0, 10.0, -4.0),
                             dispersion_coeffs=(0.0, 0.0, 8.0, 0.0), device="cpu")
    return cv.prep_operator, (cv.phase.real.contiguous(), cv.phase.imag.contiguous())


def _staged_prep(x, parts, rows):
    y = staged(x, parts)
    return y if rows is None else torch.complex(y * rows[0], y * rows[1])


def _prep_plain(raw, parts, rows, bitshift):
    if rows is None:
        return tfp.prep_real_plain(raw, parts, bitshift=bitshift)
    return tfp.prep_phase_plain(raw, parts, *rows, bitshift=bitshift)


@pytest.mark.parametrize("epi", ["phase", "real"])
@pytest.mark.parametrize("background_removal", [False, True])
@pytest.mark.parametrize("precision", ["high", "highest"])
@pytest.mark.parametrize("kind", ["u16s", "u16", "f32"])
@pytest.mark.parametrize("n,lines", [(256, 200), (300, 130)])
def test_prep_staged_order_within_the_prep_bound(epi, background_removal, precision, kind,
                                                 n, lines):
    """The staged order on the prep operator against the plain versions:
    n = 300 ends on a partial stage and its n_out on a partial 128-column
    tile, 130 and 200 lines on a partial 64-line group.  With background
    removal the operator is dense within its band and the output cancels
    the DC level: the hardest case for the bound."""
    op, rows = _prep_operator(n, background_removal)
    parts = tfp._operator_parts(op, precision)
    raw, bitshift = _input(kind, lines, n)
    rows = rows if epi == "phase" else None
    err = tfp.prep_error(_staged_prep(tfp._decode_block(raw, bitshift), parts, rows),
                         _prep_plain(raw, parts, rows, bitshift))
    assert err <= tfp.PREP_REL_L2, err


@pytest.mark.parametrize("epi", ["phase", "real"])
@pytest.mark.parametrize("background_removal", [False, True])
@pytest.mark.parametrize("control", ["3-pass math on the highest parts", "no x_lo"])
def test_prep_controls_still_fail_under_the_staged_order(epi, background_removal, control):
    """A prep kernel computing a neighbouring rung in the staged order fails
    the bound against the plain version of the right rung."""
    op, rows = _prep_operator(256, background_removal)
    rows = rows if epi == "phase" else None
    raw, _ = _input("u16", 200, 256)
    x = raw.to(torch.float32)
    if control == "no x_lo":
        parts = tfp._operator_parts(op, "high")
        kernel_x, kernel_parts = tfp._bf16_trunc(x), parts
    else:
        parts = tfp._operator_parts(op, "highest")
        kernel_x, kernel_parts = x, parts[:2]
    err = tfp.prep_error(_staged_prep(kernel_x, kernel_parts, rows),
                         _prep_plain(x, parts, rows, False))
    assert err > 2 * tfp.PREP_REL_L2, err


# ---------------------------------------------------------------------------
# The prep kernels' one pass (B7 phase, B8 real) on the three parts of their
# float32 operator, against the float32 product prep_phase_plain /
# prep_real_plain within PREP_REL_L2
# ---------------------------------------------------------------------------

def _kernel_prep(raw, x, parts, rows):
    """The prep kernel's output on (raw, parts): :func:`kernel_sums`, through
    the phasor epilogue for the phase kernel (``rows`` given)."""
    y = kernel_sums(raw, x, parts, "prep_real" if rows is None else "prep_phase")
    return y if rows is None else torch.complex(y * rows[0], y * rows[1])


def _staged3_prep(x, one, rows, x_lo_terms=True):
    """The three-x-part prep kernel's output on float32 lines x against the
    float32 operator's three parts (``one.split``): :func:`staged3`,
    through the phasor epilogue for the phase kernel (``rows`` given)."""
    y = staged3(x, one.split, x_lo_terms=x_lo_terms)
    return y if rows is None else torch.complex(y * rows[0], y * rows[1])


def _one_pass_prep_error(epi, background_removal, kind, n, lines):
    """The staged terms of the one-pass prep kernel ``epi`` on integer lines
    (the float32 operator's three parts, five terms where a stage has x_lo)
    against the float32 product: relative L2."""
    op, rows = _prep_operator(n, background_removal)
    rows = rows if epi == "phase" else None
    one = tfp._operator_parts(op, "default")
    raw, bitshift = _input(kind, lines, n)
    x = tfp._decode_block(raw, bitshift)
    return tfp.prep_error(_kernel_prep(raw, x, one, rows), _prep_plain(raw, one, rows, bitshift))


@pytest.mark.parametrize("background_removal", [False, True])
@pytest.mark.parametrize("kind", ["u16s", "u16", "u16f", "u8"])
@pytest.mark.parametrize("n,lines", [(256, 200), (300, 130)])
def test_prep_phase_one_pass_staged_within_the_prep_bound(background_removal, kind, n, lines):
    """The one-pass phase kernel on integer lines runs the staged terms of
    the float32 operator's three parts (five where a stage has x_lo): within
    the prep bound of the float32 product, with and without background
    removal, on a partial stage (n = 300) and partial 64-line groups."""
    err = _one_pass_prep_error("phase", background_removal, kind, n, lines)
    assert err <= tfp.PREP_REL_L2, err


@pytest.mark.parametrize("background_removal", [False, True])
@pytest.mark.parametrize("kind", ["u16s", "u16", "u16f", "u8"])
@pytest.mark.parametrize("n,lines", [(256, 200), (300, 130)])
def test_prep_real_one_pass_staged_within_the_prep_bound(background_removal, kind, n, lines):
    """The one-pass real kernel (B8) as the phase kernel: the staged terms of
    the three parts within the prep bound of the float32 product."""
    err = _one_pass_prep_error("real", background_removal, kind, n, lines)
    assert err <= tfp.PREP_REL_L2, err


@pytest.mark.parametrize("epi,background_removal", [
    pytest.param("phase", False, id="False"), pytest.param("phase", True, id="True"),
    pytest.param("real", False, id="real-False"), pytest.param("real", True, id="real-True")])
def test_prep_float_lines_above_16_bits_miss_the_bound_through_the_split(epi, background_removal):
    """24-bit float32 lines through the two-x-part terms miss the prep bound
    (x_hi + x_lo keeps 16 bits of a sample), so both prep kernels' one
    pass splits x in three for them, which holds it."""
    op, rows = _prep_operator(256, background_removal)
    rows = rows if epi == "phase" else None
    one = tfp._operator_parts(op, "default")
    raw, _ = _input("f32", 200, 256)
    want = _prep_plain(raw, one, rows, False)
    assert tfp.prep_error(_staged_prep(raw, one.split, rows), want) > 2 * tfp.PREP_REL_L2
    assert tfp.prep_error(_kernel_prep(raw, raw, one, rows), want) <= tfp.PREP_REL_L2


@pytest.mark.parametrize("epi,background_removal", [
    pytest.param("phase", False, id="False"), pytest.param("phase", True, id="True"),
    pytest.param("real", False, id="real-False"), pytest.param("real", True, id="real-True")])
@pytest.mark.parametrize("kind", ["f32", "f32w", "f16"])
@pytest.mark.parametrize("n,lines", [(256, 200), (320, 130), (1024, 130)])
def test_prep_phase_three_x_parts_within_the_prep_bound(epi, background_removal, kind, n,
                                                        lines):
    """The prep kernels' one pass on float32 lines, phase (B7) and real
    (B8): the six terms of three x parts (five on 16-bit values) against
    prep_phase_plain / prep_real_plain within the prep bound, with and
    without background removal, on 24- and 32-bit samples, a partial stage
    (n = 320) and partial 64-line groups; both on the tensor-core route."""
    op, rows = _prep_operator(n, background_removal)
    rows = rows if epi == "phase" else None
    one = tfp._operator_parts(op, "default")
    raw, _ = _input(kind, lines, n)
    assert tfp._kernel_operands(raw, (one,), "prep_phase")[3] == "tensor_core"
    assert tfp._kernel_operands(raw, (one,), "prep_real")[3] == "tensor_core"
    got = _kernel_prep(raw, raw, one, rows)
    assert torch.equal(got, _staged3_prep(raw, one, rows))
    err = tfp.prep_error(got, _prep_plain(raw, one, rows, False))
    assert err <= tfp.PREP_REL_L2, err


@pytest.mark.parametrize("family", ["depth", "depth_scale", "depth_scale_concat", "prep_phase",
                                    "prep_real"])
def test_three_x_parts_match_the_jax_package_at_24_bits(family):
    """The JAX package's fused_depth_transform (the planar kernel) /
    fused_depth_scale (with ``fold_concat`` for the concat kernel) /
    fused_prep (without dispersion for the real kernel) at ``bit_depth=24``
    (Pallas in interpret mode, as its own CPU tests run it) against the
    port's emulated six-term sums on the same uint32 buffer, decoded to
    float32 lines as the port's wrapper decodes them -- the concat kernel's
    over the two views of the wide operator's three parts: within the
    planar bound (relative L2 3e-6), the scale bounds (RMS 1e-6, max 1e-4
    display units above the display floor) or the prep bound (relative L2
    1e-6), with the floor of 24-bit samples."""
    import importlib

    import jax.numpy as jnp
    import octproz_tpu.params as jparams

    jfp = importlib.import_module("octproz_tpu.pallas.fused_prep")
    n = 256
    geometry = dict(samples_per_line=n, ascans_per_bscan=32, bscans_per_buffer=4, bit_depth=24)
    changes = dict(bitshift=False, grayscale_min=96.0, grayscale_max=156.0)
    if family.startswith("prep"):
        changes.update(fft_via_matmul=False, use_pallas_prep=True,
                       dispersion=family == "prep_phase")
    if family == "depth_scale_concat":
        changes.update(fold_concat=True)
    acq = AcqParams(**geometry)
    cfg = dataclasses.replace(default_full_config(), **changes)
    jacq = jparams.AcqParams(**geometry)
    jcfg = dataclasses.replace(jparams.default_full_config(), **changes)
    cv = tcurves.make_curves(acq, cfg, resample_coeffs=(0.0, n - 1.0, 10.0, -4.0),
                             dispersion_coeffs=(0.0, 0.0, 8.0, 0.0), device="cpu")
    raw = np.random.default_rng(24).integers(0, 1 << 24, size=acq.buffer_shape,
                                             dtype=np.int64).astype(np.uint32)
    x = tfp._predecode(torch.from_numpy(raw).reshape(-1, n), 24, False)
    assert x.dtype == torch.float32 and tfp.x_parts(x) == 3
    if family == "depth":
        ops = [tfp._operator_parts(w, "default") for w in (cv.depth_op_re, cv.depth_op_im)]
        got = [kernel_sums(x, x, w, family) for w in ops]
        want = jfp.fused_depth_transform(jnp.asarray(raw), jnp.asarray(cv.depth_op_re.numpy()),
                                         jnp.asarray(cv.depth_op_im.numpy()), jacq, jcfg,
                                         interpret=True)
        want = [torch.from_numpy(np.array(w, np.float32)).reshape(g.shape)
                for w, g in zip(want, got)]
        err = tfp.planar_error(got, want)
        assert err <= tfp.PLANAR_REL_L2, err
    elif family.startswith("depth"):
        ops = [tfp._operator_parts(w, "default") for w in (cv.depth_op_re, cv.depth_op_im)]
        mean2 = torch.from_numpy(np.random.default_rng(5).normal(0, 50.0, size=(2, n // 2))
                                 .astype(np.float32))
        a, b = tfp._scale_affine(True, n // 2, cfg.grayscale_min, cfg.grayscale_max,
                                 cfg.addend, cfg.multiplicator)
        if family == "depth_scale":
            got = _staged_scale(x, *ops, mean2, a, b)
        else:
            wide = tfp.concat_operator(*ops, "default")
            assert tfp._kernel_operands(x, (wide,), family)[3] == "tensor_core"
            re, im = (staged3(x, view) - mean2[i:i + 1]
                      for i, view in enumerate(concat_views(wide.split)))
            got = tfp._scale_epilogue(re * re + im * im, log_scaling=True, a=a, b=b)
        want = jfp.fused_depth_scale(jnp.asarray(raw), jnp.asarray(cv.depth_op_re.numpy()),
                                     jnp.asarray(cv.depth_op_im.numpy()),
                                     jnp.asarray(mean2.numpy()), jacq, jcfg, interpret=True)
        want = torch.from_numpy(np.array(want, np.float32)).reshape(got.shape)
        rms, worst, ok = tfp.scale_error(got, want)
        assert ok, (rms, worst)
    else:
        one = tfp._operator_parts(cv.prep_operator, "default")
        phase = family == "prep_phase"
        rows = (cv.phase.real.contiguous(), cv.phase.imag.contiguous()) if phase else None
        assert tfp._kernel_operands(x, (one,), family)[3] == "tensor_core"
        got = _kernel_prep(x, x, one, rows)
        want = jfp.fused_prep(jnp.asarray(raw), jnp.asarray(cv.prep_operator.numpy()),
                              jnp.asarray(cv.phase.numpy()) if phase else None, jacq, jcfg,
                              interpret=True)
        want = torch.from_numpy(np.array(want)).reshape(got.shape)
        assert got.dtype == want.dtype
        err = tfp.prep_error(got, want)
        assert err <= tfp.PREP_REL_L2, err


def _one_pass_prep_control_error(epi, background_removal, control):
    """A one-pass prep kernel's neighbour -- the "high" parts (two of the
    three), or the three-part math without x_lo on unshifted samples --
    against the float32 product: relative L2."""
    op, rows = _prep_operator(256, background_removal)
    rows = rows if epi == "phase" else None
    one = tfp._operator_parts(op, "default")
    raw, _ = _input("u16", 200, 256)
    x = raw.to(torch.float32)
    if control == "no x_lo":
        got = _staged_prep(tfp._bf16_trunc(x), one.split, rows)
    else:
        got = _staged_prep(x, one.split[:2], rows)
    return tfp.prep_error(got, _prep_plain(x, one, rows, False))


@pytest.mark.parametrize("background_removal", [False, True])
@pytest.mark.parametrize("control", ["two of the three parts", "no x_lo"])
def test_prep_phase_one_pass_controls_fail(background_removal, control):
    """The one-pass phase kernel's neighbours fail the prep bound against
    the float32 product."""
    err = _one_pass_prep_control_error("phase", background_removal, control)
    assert err > 2 * tfp.PREP_REL_L2, err


@pytest.mark.parametrize("background_removal", [False, True])
@pytest.mark.parametrize("control", ["two of the three parts", "no x_lo"])
def test_prep_real_one_pass_controls_fail(background_removal, control):
    """The one-pass real kernel's neighbours fail the prep bound against the
    float32 product."""
    err = _one_pass_prep_control_error("real", background_removal, control)
    assert err > 2 * tfp.PREP_REL_L2, err


ROUTES = [
    # (family, input dtype, precision, passes, LAUNCHES key, route)
    ("prep_phase", torch.uint16, "default", 1, "prep_phase", "tensor_core"),
    ("prep_phase", torch.uint8, "default", 1, "prep_phase", "tensor_core"),
    ("prep_phase", torch.float32, "default", 1, "prep_phase", "tensor_core"),
    ("prep_real", torch.uint16, "default", 1, "prep_real", "tensor_core"),
    ("prep_real", torch.float32, "default", 1, "prep_real", "tensor_core"),
    ("prep_phase", torch.uint16, "high", 3, "prep_phase_split", None),
    ("prep_real", torch.uint16, "highest", 5, "prep_real_split", None),
    ("depth_scale_concat", torch.uint16, "default", 1, "depth_scale_concat", "tensor_core"),
    ("depth_scale_concat", torch.uint16, "high", 3, "depth_scale_concat_split", None),
    ("prep_real", torch.uint8, "default", 1, "prep_real", "tensor_core"),
    ("depth_scale_concat", torch.uint8, "default", 1, "depth_scale_concat", "tensor_core"),
    ("depth_scale_concat", torch.float32, "default", 1, "depth_scale_concat", "tensor_core"),
    ("depth_scale", torch.float32, "default", 1, "depth_scale", "tensor_core"),
    ("depth_scale", torch.uint16, "default", 1, "depth_scale", "tensor_core"),
    ("depth", torch.float32, "default", 1, "depth", "tensor_core"),
    ("depth", torch.uint8, "default", 1, "depth", "tensor_core"),
    ("depth_scale", torch.float32, "high", 3, "depth_scale_split", None),
]


@pytest.mark.parametrize("family,dtype,precision,passes,key,route", ROUTES)
def test_route_helper_follows_the_family_and_the_input_type(family, dtype, precision, passes,
                                                            key, route):
    """``_kernel_operands`` for the one-operator kernels (the prep kernels
    on P, the concat kernels on [W_re | W_im]) and the two-operator fold
    kernels (W_re, W_im): the one pass goes to the tensor cores on every
    input type (the operator's three bf16 parts, made once and kept); the
    split rungs pass their parts as they are."""
    if family.startswith("prep"):
        op, _ = _prep_operator(256, False)
        axes, ops = (tfp._operator_parts(op, precision),), (op,)
    elif family == "depth_scale_concat":
        wre, wim = _operators(256)
        ops = (torch.cat([wre, wim], dim=1),)
        axes = (tfp.concat_operator(wre, wim, precision),)
    else:
        ops = _operators(256)
        axes = tuple(tfp._operator_parts(w, precision) for w in ops)
    raw = torch.zeros((8, 256), dtype=dtype)
    got_passes, got, got_key, got_route = tfp._kernel_operands(raw, axes, family)
    assert (got_passes, got_key, got_route) == (passes, key, route)
    assert all(g is (p.split if route == "tensor_core" else p) for g, p in zip(got, axes))
    if route == "tensor_core":  # a float32 operator without its parts is split per call
        again = tfp._kernel_operands(raw, tuple((w,) for w in ops), family)[1]
        assert all(torch.equal(a, b) for g, p in zip(again, axes) for a, b in zip(g, p.split))


# ---------------------------------------------------------------------------
# The concat kernel's split rung (B6) on the split pipeline: two views of each
# wide part [W_re | W_im] at row pitch 2 * half
# ---------------------------------------------------------------------------

def concat_views(wide, im_offset=None):
    """The two operator halves the concat kernel reads from each wide
    (n_in, 2 * half) part: views at column 0 and at ``im_offset`` (default
    half), ``half`` columns wide, with the wide part's row pitch -- the
    kernel's (pointer, row pitch) pairs."""
    n_in, width = wide[0].shape
    half = width // 2
    off = half if im_offset is None else im_offset
    return tuple(tuple(torch.as_strided(w, (n_in, half), (width, 1), w.storage_offset() + o)
                       for w in wide) for o in (0, off))


@pytest.mark.parametrize("precision", ["high", "highest"])
@pytest.mark.parametrize("kind", ["u16s", "u16"])
@pytest.mark.parametrize("n", [256, 1088])
def test_concat_views_staged_within_the_scale_bounds(precision, kind, n):
    """The staged terms of the two views of each wide part against
    depth_scale_concat_plain within the scale bounds, on shifted (x_lo zero)
    and unshifted 12-bit samples; n = 1088 gives half = 544, not a multiple
    of the 64-bin tile.  The views are the per-axis parts exactly: the split
    commutes with the concatenation."""
    wre, wim = _operators(n)
    wide = tfp.concat_operator(wre, wim, precision)
    views = concat_views(wide)
    for view, w in zip(views, (wre, wim)):
        assert all(torch.equal(v, q) for v, q in zip(view, tfp._operator_parts(w, precision)))
    raw, bitshift = _input(kind, 200, n)
    mean2, a, b = _scale_args(n // 2)
    got = _staged_scale(tfp._decode_block(raw, bitshift), *views, mean2, a, b, raw=raw)
    want = tfp.depth_scale_concat_plain(raw, wide, mean2, bitshift=bitshift, log_scaling=True,
                                        a=a, b=b)
    rms, worst, ok = tfp.scale_error(got, want)
    assert ok, (rms, worst)


@pytest.mark.parametrize("kind", ["u16s", "u16", "u16f", "u8"])
@pytest.mark.parametrize("n", [256, 1088])
def test_concat_one_pass_views_staged_within_the_scale_bounds(kind, n):
    """The concat kernel's one pass (B5) on integer lines: the staged terms
    of the two views of the wide float32 operator's three bf16 parts (five
    where a stage has x_lo) against the float32 product
    depth_scale_concat_plain, within the scale bounds over the display
    range B2's one-pass cases use; n = 1088 gives half = 544, not a multiple
    of the 64-bin tile.  The views are the per-axis parts exactly."""
    wre, wim = _operators(n)
    wide = tfp.concat_operator(wre, wim, "default")
    views = concat_views(wide.split)
    for view, w in zip(views, (wre, wim)):
        assert all(torch.equal(v, q) for v, q in zip(view, tfp._operator_parts(w, "default").split))
    raw, bitshift = _input(kind, 200, n)
    mean2, a, b = _scale_args(n // 2)
    got = _staged_scale(tfp._decode_block(raw, bitshift), *views, mean2, a, b, raw=raw)
    want = tfp.depth_scale_concat_plain(raw, wide, mean2, bitshift=bitshift, log_scaling=True,
                                        a=a, b=b)
    rms, worst, ok = tfp.scale_error(got, want)
    assert ok, (rms, worst)


@pytest.mark.parametrize("kind", ["f32", "f32w"])
@pytest.mark.parametrize("n,lines", [(256, 200), (320, 130), (1000, 130)])
def test_concat_three_x_parts_views_within_the_scale_bounds(kind, n, lines):
    """The concat kernel's one pass on float32 lines (B5): the six terms of
    three x parts against the two views of the wide float32 operator's
    three bf16 parts, against depth_scale_concat_plain within the scale
    bounds on 24- and 32-bit samples (display floor 96 / 144 dB, as the
    card's cases use); n = 320 ends on a partial stage and n = 1000 gives
    half = 500, half % 8 != 0: the im views are not 16-byte aligned, which
    on the card takes the element-wise producer.  The route is the
    wrapper's, and the staged sum stands at least as close to the float64
    product as the plain version does."""
    wre, wim = _operators(n)
    wide = tfp.concat_operator(wre, wim, "default")
    raw, _ = _input(kind, lines, n)
    assert tfp._kernel_operands(raw, (wide,), "depth_scale_concat")[3] == "tensor_core"
    half = n // 2
    mean2 = torch.from_numpy(np.random.default_rng(5).normal(0, 50.0, size=(2, half))
                             .astype(np.float32))
    floor = {"f32": 96.0, "f32w": 144.0}[kind]
    a, b = tfp._scale_affine(True, half, floor, floor + 60.0, 0.0, 1.0)
    re, im = (staged3(raw, view) - mean2[i:i + 1]
              for i, view in enumerate(concat_views(wide.split)))
    got = tfp._scale_epilogue(re * re + im * im, log_scaling=True, a=a, b=b)
    want = tfp.depth_scale_concat_plain(raw, wide, mean2, bitshift=False, log_scaling=True,
                                        a=a, b=b)
    rms, worst, ok = tfp.scale_error(got, want)
    assert ok, (rms, worst)
    ops = [tfp._operator_parts(w, "default") for w in (wre, wim)]
    exact = _scale_f64(raw, ops, mean2, a, b)
    assert tfp.scale_error(got, exact)[0] <= tfp.scale_error(want, exact)[0] + tfp.SCALE_RMS / 10


def test_concat_one_pass_views_one_column_early_fail():
    """Control: at one pass, the im views of the three parts one column
    early (bin j's im read at half - 1 + j) fail the scale bounds."""
    wide = tfp.concat_operator(*_operators(256), "default")
    raw, _ = _input("u16", 200, 256)
    x = raw.to(torch.float32)
    mean2, a, b = _scale_args(128)
    rms, _, ok = tfp.scale_error(
        _staged_scale(x, *concat_views(wide.split, im_offset=127), mean2, a, b),
        tfp.depth_scale_concat_plain(x, wide, mean2, bitshift=False, log_scaling=True, a=a, b=b))
    assert not ok and rms > 2 * tfp.SCALE_RMS, rms


@pytest.mark.parametrize("given", ["float32 operators", "per-axis parts"])
def test_concat_operator_at_default_is_one_pass(given):
    """At the default rung the concatenated operator is a OnePass of the
    wide float32 operator, from the float32 operators or from their
    per-axis OnePass parts alike, so its three bf16 parts ride with it (made
    once where it is held); they equal the per-axis parts concatenated."""
    wre, wim = _operators(256)
    args = (wre, wim) if given == "float32 operators" else \
        tuple(tfp._operator_parts(w, "default") for w in (wre, wim))
    wide = tfp.concat_operator(*args, "default")
    assert isinstance(wide, tfp.OnePass) and len(wide) == 1
    assert torch.equal(wide[0], torch.cat([wre, wim], dim=1))
    per_axis = [tfp._operator_parts(w, "default").split for w in (wre, wim)]
    assert len(wide.split) == 3
    assert all(torch.equal(q, torch.cat([r, i], dim=1))
               for q, r, i in zip(wide.split, *per_axis))


def test_concat_views_one_column_early_fail():
    """Control: the im view one column early (bin j's im read at half - 1 + j)
    fails the scale bounds at 3 passes."""
    wide = tfp.concat_operator(*_operators(256), "high")
    raw, _ = _input("u16", 200, 256)
    x = raw.to(torch.float32)
    mean2, a, b = _scale_args(128)
    rms, _, ok = tfp.scale_error(
        _staged_scale(x, *concat_views(wide, im_offset=127), mean2, a, b),
        tfp.depth_scale_concat_plain(x, wide, mean2, bitshift=False, log_scaling=True, a=a, b=b))
    assert not ok and rms > 2 * tfp.SCALE_RMS, rms


# ---------------------------------------------------------------------------
# The bound and the library call of each kernel family (bench.py)
# ---------------------------------------------------------------------------

MAIN = dict(lines=131072, n_in=1024)
BOUNDS = [
    # (family, n_out, parts, x_lo zero, terms, bound ms) at the main path's shapes
    ("depth", 512, 1, True, 3, 0.8338),
    ("depth_split", 512, 2, True, 2, 0.5559),
    ("depth_scale", 512, 1, True, 3, 0.8338),
    ("depth_scale_split", 512, 2, True, 2, 0.5559),
    ("depth_scale_concat", 512, 1, True, 3, 0.8338),
    ("depth_scale_concat_split", 512, 2, True, 2, 0.5559),
    ("prep_phase", 1024, 1, True, 3, 0.8338),
    ("prep_phase_split", 1024, 2, True, 2, 0.5559),
    ("prep_real", 1024, 1, True, 3, 0.8338),
    ("prep_real_split", 1024, 2, True, 2, 0.5559),
    # x_lo nonzero: five terms on the one-pass tensor-core route
    ("depth", 512, 1, False, 5, 1.3897),
    ("depth_scale", 512, 1, False, 5, 1.3897),
    ("depth_scale_concat", 512, 1, False, 5, 1.3897),
    ("prep_phase", 1024, 1, False, 5, 1.3897),
    ("prep_real", 1024, 1, False, 5, 1.3897),
]


@pytest.mark.parametrize("name,n_out,parts,x_lo_zero,terms,ms", BOUNDS)
def test_kernel_bound_hand_values(name, n_out, parts, x_lo_zero, terms, ms):
    """0.556 ms for the split rungs at "high" (two bf16 terms of 275 GFLOP
    at 989 TFLOP/s, x_lo being zero); 0.834 ms for every family at one pass
    on integer samples (three bf16 terms; 1.390 ms for the five that samples
    with x_lo need): every family is bound by its operations."""
    got = bench.kernel_bound(name, n_out=n_out, parts=parts, x_parts=1 if x_lo_zero else 2,
                             **MAIN)
    assert got["bound_ms"] == pytest.approx(ms, abs=1e-4)
    assert got["bound_by"] == "operations"
    assert got["flops"] == terms * 4 * 131072 * 1024 * 512  # 2.75e11 per term


@pytest.mark.parametrize("name", ["depth", "depth_scale", "depth_scale_concat"])
def test_kernel_bound_of_the_one_pass_routes(name):
    """uint8/uint16 lines run the tensor-core route (three bf16 parts per
    axis to read, bf16 peak); float32 lines of 24 bits (three x parts) run
    it too for the planar and the scaled kernels, two-operator and concat,
    six bf16 terms against the same three parts per axis."""
    u16 = bench.kernel_bound(name, n_out=512, **MAIN)
    u8 = bench.kernel_bound(name, n_out=512, in_itemsize=1, **MAIN)
    f32 = bench.kernel_bound(name, n_out=512, in_itemsize=4, x_parts=3, **MAIN)
    assert u16["bound_ms"] == u8["bound_ms"] == pytest.approx(0.8338, abs=1e-4)
    assert u16["bytes"] - u8["bytes"] == 131072 * 1024
    out = 131072 * 512 * 4 * (2 if name == "depth" else 1) + (2 * 512 * 4 if name != "depth" else 0)
    assert u16["bytes"] == 131072 * 1024 * 2 + 2 * 3 * 1024 * 512 * 2 + out
    assert f32["bound_ms"] == pytest.approx(1.6676, abs=1e-4)
    assert f32["flops"] == 6 * 4 * 131072 * 1024 * 512
    assert f32["bytes"] == u16["bytes"] + 131072 * 1024 * 2


@pytest.mark.parametrize("itemsize,ms", [(2, 0.8338), (1, 0.8338), (4, 1.6676)])
def test_kernel_bound_of_the_prep_one_pass_routes(itemsize, ms):
    """The prep kernels at one pass: the real kernel's bound ``ms`` -- three
    bf16 terms on uint8/uint16 lines, six on float32 lines of 24 bits (three
    x parts) -- each against the float32 operator's three bf16 parts; the
    phase kernel runs the same terms, plus the phasor rows and twice the
    store."""
    xp = 3 if itemsize == 4 else 1
    phase = bench.kernel_bound("prep_phase", n_out=1024, in_itemsize=itemsize, x_parts=xp,
                               **MAIN)
    real = bench.kernel_bound("prep_real", n_out=1024, in_itemsize=itemsize, x_parts=xp,
                              **MAIN)
    assert real["bound_ms"] == pytest.approx(ms, abs=1e-4)
    assert phase["bound_ms"] == pytest.approx(ms, abs=1e-4)
    terms = 6 if itemsize == 4 else 3
    assert real["flops"] == phase["flops"] == terms * 2 * 131072 * 1024 * 1024
    op = 3 * 1024 * 1024 * 2
    assert real["bytes"] == 131072 * 1024 * (itemsize + 4) + op
    assert phase["bytes"] == 131072 * 1024 * (itemsize + 8) + op + 2 * 1024 * 4


@pytest.mark.parametrize("name,n_out", [("depth_scale", 512), ("prep_phase", 1024),
                                        ("depth_scale_f32lines", 512),
                                        ("prep_phase_f32lines", 1024),
                                        ("depth_scale_concat_f32lines", 512),
                                        ("prep_real_f32lines", 1024), ("depth", 512),
                                        ("depth_f32lines", 512)])
@pytest.mark.parametrize("x_parts,terms,ms", [(3, 6, 1.6676), (2, 5, 1.3897), (1, 3, 0.8338)])
def test_kernel_bound_counts_the_x_parts_of_float_lines(name, n_out, x_parts, terms, ms):
    """On float32 lines the planar, the scaled, the concat and the prep
    kernels' one pass runs sum_i (3 - i) terms over the x parts the data
    needs: six for samples above 16 bits (1.668 ms at the main geometry),
    five for 16-bit values, three for values exact in bf16; the planar
    family's bound equals the scaled one's (its planes' bytes stay under
    its operations)."""
    got = bench.kernel_bound(name, n_out=n_out, in_itemsize=4, x_parts=x_parts, **MAIN)
    gemms = 1 if name.startswith("prep") else 2
    assert got["flops"] == terms * gemms * 2 * 131072 * 1024 * n_out
    assert got["bound_ms"] == pytest.approx(ms, abs=1e-4) and got["bound_by"] == "operations"
    if name.startswith("depth"):
        scaled = name.replace("depth", "depth_scale", 1) if not name.startswith("depth_scale") \
            else name
        assert bench.kernel_bound(scaled, n_out=n_out, in_itemsize=4, x_parts=x_parts,
                                  **MAIN)["bound_ms"] == got["bound_ms"]


@pytest.mark.parametrize("name,n_out,ms,by", [
    ("depth", 512, 0.2779, "operations"), ("depth_scale", 512, 0.2779, "operations"),
    ("depth_scale_concat", 512, 0.2779, "operations"), ("prep_phase", 1024, 0.4013, "bytes"),
    ("prep_real", 1024, 0.2779, "operations")])
def test_kernel_bound_of_the_bf16_route(name, n_out, ms, by):
    """compute_dtype="bfloat16": one bf16 term of 275 GFLOP (0.278 ms at
    989 TFLOP/s) against one bf16 part, on every input type; the phase
    kernel's 1.07 GB of complex64 makes it bound by its bytes (0.401 ms at
    3.35 TB/s)."""
    for itemsize in (1, 2, 4):
        got = bench.kernel_bound(name, n_out=n_out, in_itemsize=itemsize, bf16=True, **MAIN)
        assert got["flops"] == 2 * 131072 * 1024 * 1024
        if itemsize == 2:
            assert got["bound_ms"] == pytest.approx(ms, abs=1e-4) and got["bound_by"] == by
    gemms = 1 if name.startswith("prep") else 2
    one_pass = bench.kernel_bound(name, n_out=n_out, **MAIN)
    bf16 = bench.kernel_bound(name, n_out=n_out, bf16=True, **MAIN)
    assert one_pass["bytes"] - bf16["bytes"] == gemms * 2 * 1024 * n_out * 2  # 3 parts -> 1
    assert one_pass["flops"] == 3 * bf16["flops"]


def test_library_operands_of_the_bf16_route():
    """The bf16 route's yardstick: cuBLAS's bf16 product of x rounded to
    nearest and the rounded parts; the split rungs' x_hi stays the mask
    truncation."""
    x = torch.tensor([[257.0, 259.0, 3.0]])
    w = torch.ones((3, 2))
    a, b = bench.library_operands(x, [tfp._operator_parts(w, tfp.BF16)] * 2)
    assert a.dtype == b.dtype == torch.bfloat16 and tuple(b.shape) == (3, 4)
    assert a.float().tolist() == [[256.0, 260.0, 3.0]]
    a_hi, _ = bench.library_operands(x, [tfp._operator_parts(w, "high")])
    assert a_hi.float().tolist() == [[256.0, 258.0, 3.0]]


def test_kernel_bound_counts_terms_and_bytes():
    """With x_lo nonzero all three "high" terms count (0.834 ms); B4 moves
    the raw buffer, four bf16 parts, the mean line and the float32 image
    (0.54 GB), B3 two float32 planes (0.81 GB); a contraction of 16 samples
    is bound by its bytes."""
    full = bench.kernel_bound("depth_split", n_out=512, parts=2, x_parts=2, **MAIN)
    assert full["bound_ms"] == pytest.approx(0.8338, abs=1e-4)
    b4 = bench.kernel_bound("depth_scale_split", n_out=512, parts=2, **MAIN)
    assert b4["bytes"] == 131072 * 1024 * 2 + 4 * 1024 * 512 * 2 + 2 * 512 * 4 + 131072 * 512 * 4
    b3 = bench.kernel_bound("depth_split", n_out=512, parts=2, **MAIN)
    assert b3["bytes"] == 131072 * 1024 * 2 + 4 * 1024 * 512 * 2 + 2 * 131072 * 512 * 4
    bf16_out = bench.kernel_bound("depth_scale_split", n_out=512, parts=2, out_itemsize=2,
                                  **MAIN)
    assert b4["bytes"] - bf16_out["bytes"] == 131072 * 512 * 2
    short = bench.kernel_bound("depth_scale", lines=131072, n_in=16, n_out=512)
    assert short["bound_by"] == "bytes"
    assert short["bound_ms"] == pytest.approx(short["bytes"] / 3.35e12 * 1e3)


@pytest.mark.parametrize("precision", ["default", "high", "highest"])
def test_library_operands_compute_the_kernels_product(precision):
    """The yardstick's matmul: float32 x by [W_re | W_im] at one part, bf16
    x_hi by every bf16 part of both axes at the split rungs; its FLOPs are
    the bound's (at one part a third of them: the one float32 product the
    kernel's three bf16 terms stand for), and its column blocks summed per
    axis are x_hi @ W."""
    wre, wim = (tfp._operator_parts(w, precision) for w in _operators(256))
    raw, bitshift = _input("u16s", 64, 256)
    x = tfp._decode_block(raw, bitshift)
    a, b = bench.library_operands(x, [wre, wim])
    parts = len(wre)
    assert a.dtype == b.dtype == (torch.float32 if parts == 1 else torch.bfloat16)
    assert tuple(b.shape) == (256, 2 * parts * 128)
    bound = bench.kernel_bound("depth_split" if parts > 1 else "depth", lines=64, n_in=256,
                               n_out=128, parts=parts)
    terms_per_product = 3 if parts == 1 else 1
    assert terms_per_product * 2 * a.shape[0] * a.shape[1] * b.shape[1] == bound["flops"]
    y = a.to(torch.float32) @ b.to(torch.float32)
    for axis, w in enumerate((wre, wim)):
        blocks = y[:, axis * parts * 128:(axis + 1) * parts * 128].reshape(64, parts, 128)
        want = tfp._bf16_trunc(x) @ sum(p.to(torch.float32) for p in w)
        assert tfp.planar_error([blocks.sum(1)], [want]) <= 1e-6


@pytest.mark.parametrize("module", ["octproz_tpu_torch.ab", "octproz_tpu_torch.kernels.diagnose"])
def test_measurement_scripts_need_a_gpu(module):
    """The A/B timing and the split kernels' diagnostics measure the card
    only: without CUDA they exit nonzero before they build or time
    anything."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-m", module, root], cwd=root,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and '"turns"' not in proc.stdout
    assert '"ms"' not in proc.stdout


def test_diagnostic_variants_build_apart():
    """A diagnostic variant (-DFOLD_SPLIT_VARIANT) builds into a library of
    its own, and the kernels' own build never sets it."""
    from octproz_tpu_torch.kernels import build

    flags = build.NVCC_FLAGS
    base = build.library_path()
    try:
        build.NVCC_FLAGS = flags + ("-DFOLD_SPLIT_VARIANT=2",)
        assert build.library_path() != base
    finally:
        build.NVCC_FLAGS = flags
    assert build.library_path() == base
    assert not any("FOLD_SPLIT_VARIANT" in f for f in flags)
