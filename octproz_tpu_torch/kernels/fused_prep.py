"""The GEMM kernels of both pipeline branches.

Every pre-FFT stage is linear in the A-scan with coefficients that depend
only on the intra-line index, so background removal, k-linearization and
the window fold into one (n_in, n_out) prep operator P
(:func:`build_prep_operator`); with the dispersion phasor, the inverse DFT
and the mirror truncation as well, into one complex depth operator
``W = W_re + i W_im`` (:func:`build_depth_operator`).  Both are built once
per curve update on the host.  At run time one kernel per call does

    fold path:  decode raw integers -> x @ W_re, x @ W_im  (planar depth
                profiles), or in the steady state the same GEMMs plus FPN
                mean subtraction and ``A*log10(re^2+im^2)+B``, so only raw
                integers are read and only the magnitude image is written;
    FFT path:   decode raw integers -> y = x @ P -> (y cos, y sin) as
                complex64 spectra (or y alone without dispersion), which
                the FFT stage then transforms.

With ``fold_concat`` the steady-state kernel runs one GEMM against the
concatenated operator ``[W_re | W_im]`` (n_in, 2*half) and slices re and im
from it in the epilogue.

This module holds, for each of the ten kernel families:

* the CUDA kernel (the C entry points of ``csrc/fold_gemm.cu``,
  ``csrc/fold_concat.cu`` and ``csrc/prep_gemm.cu``; every rung on
  uint8/uint16 lines runs the bf16 tensor-core kernels of
  ``csrc/fold_split.cu`` and ``csrc/prep_split.cu`` -- the one-pass rung as
  three bf16 parts of the float32 operator (:class:`OnePass`) -- and the
  one-pass rung on float32 lines the float32-FMA template on the CUDA
  cores; ``compute_dtype="bfloat16"`` runs the same tensor-core kernels
  with x rounded to nearest and one bf16 operator part, on every input
  type; the route is counted in :data:`ONE_PASS_ROUTES`; built by
  :mod:`.build`), which a wrapper launches for CUDA tensors;
* its plain PyTorch version (``*_plain``), which the wrapper uses for CPU
  tensors and which the tests and ``chip_smoke.py`` hold the kernel to;
* a launch count in :data:`LAUNCHES`, raised only where the kernel is
  launched.

==========================  ===========================================
family (LAUNCHES key)       replaces (octproz_tpu/pallas/fused_prep.py)
==========================  ===========================================
``depth``                   ``_kernel_depth``
``depth_split``             ``_kernel_depth_split``
``depth_scale``             ``_kernel_depth_scale``
``depth_scale_split``       ``_kernel_depth_scale_split``
``depth_scale_concat``      ``_kernel_depth_scale_concat``
``depth_scale_concat_split``  ``_kernel_depth_scale_concat_split``
``prep_phase``              ``_kernel_phase``
``prep_phase_split``        ``_kernel_phase_split``
``prep_real``               ``_kernel_real``
``prep_real_split``         ``_kernel_real_split``
==========================  ===========================================
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.background import rolling_average_indices
from ..params import AcqParams, ProcConfig

#: Operator split widths of the multi-pass rungs: "high" -> 2 bf16 parts
#: (3 passes), "highest" -> 3 parts (5 passes).
_SPLIT_PARTS = {"high": 2, "highest": 3}

#: bf16 parts of the float32 operator that the one-pass rung's tensor-core
#: kernels read: ~24 mantissa bits, the "highest" split.
_ONE_PASS_PARTS = 3

#: The rung of ``compute_dtype="bfloat16"`` (:func:`operator_rung`): the
#: operator rounded to one bf16 part, x rounded to bf16, one product.
BF16 = "bfloat16"

#: The ``passes`` argument of the C entry points for the bf16 route.
_BF16_PASS = 0

#: Kernel launches per family since the last :func:`reset_launch_counts`.
#: The key follows the rung, not the kernel's pass terms: a one-pass launch
#: counts as its family (``depth``, ``prep_real``, ...) on either route.
LAUNCHES = {"depth": 0, "depth_split": 0, "depth_scale": 0,
            "depth_scale_split": 0, "depth_scale_concat": 0,
            "depth_scale_concat_split": 0, "prep_phase": 0, "prep_phase_split": 0,
            "prep_real": 0, "prep_real_split": 0}

#: The one-pass launches of every family by route: ``tensor_core``
#: (uint8/uint16 lines: bf16 wgmma on the float32 operator's three parts),
#: ``simt`` (float32 lines: the float32-FMA kernel) -- at float32 compute
#: the input type alone picks between those two -- or ``tensor_core_bf16``
#: (``compute_dtype="bfloat16"``, any input type: x rounded to bf16, one
#: wgmma term against the one rounded bf16 operator part).
ONE_PASS_ROUTES = {key: {"tensor_core": 0, "simt": 0, "tensor_core_bf16": 0}
                   for key in LAUNCHES if not key.endswith("_split")}


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0
    for routes in ONE_PASS_ROUTES.values():
        for key in routes:
            routes[key] = 0


# ---------------------------------------------------------------------------
# Host operators (numpy)
# ---------------------------------------------------------------------------

def build_prep_operator(
    acq: AcqParams,
    cfg: ProcConfig,
    resample_matrix: Optional[np.ndarray],
    window: Optional[np.ndarray],
) -> np.ndarray:
    """Fold background removal, k-linearization and windowing into one
    (n_in, n_out) operator applied as ``lines @ op`` (stage order of
    cuda_code.cu:1422-1511)."""
    n = acq.samples_per_line
    op = np.eye(n, dtype=np.float64)
    if cfg.background_removal:
        start, end, count = rolling_average_indices(n, cfg.rolling_average_window)
        m = np.zeros((n, n), dtype=np.float64)
        for i in range(n):
            m[i, start[i]:end[i] + 1] = 1.0 / count[i]
        op = op - m  # (I - M)
    if cfg.resampling:
        if resample_matrix is None:
            raise ValueError("resampling enabled but no resample matrix given")
        op = np.asarray(resample_matrix, np.float64) @ op
    if cfg.windowing:
        if window is None:
            raise ValueError("windowing enabled but no window curve given")
        op = np.asarray(window, np.float64)[:, None] * op
    return np.ascontiguousarray(op.T, dtype=np.float32)  # (n_in, n_out)


def build_depth_operator(
    acq: AcqParams,
    cfg: ProcConfig,
    resample_matrix: Optional[np.ndarray],
    window: Optional[np.ndarray],
    phase: Optional[np.ndarray],
) -> Tuple[np.ndarray, np.ndarray]:
    """Fold the whole pre-FPN chain -- background, k-linearization, window,
    dispersion phasor, unnormalised inverse DFT, mirror truncation -- into
    one complex (n_in, half) operator applied as ``lines @ (re + i im)``.

    With F[k, j] = exp(+2i pi k j / n), the inverse-DFT rows of the kept
    half (cufftExecC2C(CUFFT_INVERSE), cuda_code.cu:1513-1515):

        z_half = F_half . diag(phasor) . diag(win) . R . (I - M) . decode(raw)
    """
    n = acq.samples_per_line
    half = acq.output_ascan_length
    op = build_prep_operator(acq, cfg, resample_matrix, window)  # (n_in, n_out)
    opd = op.astype(np.float64).T  # (n_out, n_in)
    if cfg.dispersion:
        if phase is None:
            raise ValueError("dispersion enabled but no phasor given")
        opd = np.asarray(phase, np.complex128)[:, None] * opd
    j = np.arange(n, dtype=np.float64)
    k = np.arange(half, dtype=np.float64)
    f_half = np.exp(2j * np.pi * np.outer(k, j) / n)  # (half, n_out)
    total = f_half @ opd                               # (half, n_in) complex
    total_t = np.ascontiguousarray(total.T)            # (n_in, half)
    return (total_t.real.astype(np.float32), total_t.imag.astype(np.float32))


@functools.lru_cache(maxsize=64)  # host float64 math, once per setting
def _scale_affine(log_scaling: bool, half: int, gmin: float, gmax: float,
                  addend: float, coeff: float) -> Tuple[float, float]:
    """Fold the dynamic-range scaling into two constants:

      log: coeff*((10*log10(p/half) - gmin)/(gmax-gmin) + addend) = A*log10(p) + B
      lin: coeff*((sqrt(p)/half   - gmin)/(gmax-gmin) + addend) = A*sqrt(p)  + B

    in float64 (a zero range gives inf, as the unfolded expression does)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        s = np.float64(coeff) / (np.float64(gmax) - np.float64(gmin))
        base = np.float64(coeff) * addend - s * gmin
        if log_scaling:
            a = 10.0 * s
            b = base - s * 10.0 * np.log10(np.float64(half))
        else:
            a = s / np.float64(half)
            b = base
    return float(a), float(b)


# ---------------------------------------------------------------------------
# Shared numerics (torch)
# ---------------------------------------------------------------------------

def _bf16_trunc(v: torch.Tensor) -> torch.Tensor:
    """The bf16-representable truncation of float32 v, by masking the low 16
    mantissa bits.  A mask, not a bf16 cast round trip: the cast rounds to
    nearest and would change the split's parts."""
    i = v.to(torch.float32).contiguous().view(torch.int32)
    return (i & -65536).view(torch.float32)


def _split_bf16(w: torch.Tensor, parts: int = 2) -> Tuple[torch.Tensor, ...]:
    """Decompose float32 w into ``parts`` bf16 terms whose sum equals w to
    ~8*parts mantissa bits.  All but the last are mask truncations (exact in
    bf16); the last is a round-to-nearest cast of the remainder."""
    out = []
    rem = w
    for k in range(parts):
        p = _bf16_trunc(rem) if k < parts - 1 else rem
        out.append(p.to(torch.bfloat16))
        rem = rem - p
    return tuple(out)


class OnePass(tuple):
    """The one-pass rung's operator as the wrappers take it: a 1-tuple of
    the float32 operator -- what the plain versions and the SIMT kernels
    read -- that also carries ``split``, its three bf16 parts
    (:func:`_split_bf16`), which the tensor-core kernels read for integer
    lines.  ``split`` is computed at first use and kept, so an operator held
    in ``Curves.depth_parts``, ``Curves.depth_concat_parts`` or
    ``Curves.prep_parts`` is split once per curve build; one made per call
    is split per call."""

    def __new__(cls, w: torch.Tensor, split=None):
        self = super().__new__(cls, (w.to(torch.float32).contiguous(),))
        if split is not None:
            self.split = tuple(split)
        return self

    @functools.cached_property
    def split(self) -> Tuple[torch.Tensor, ...]:
        return _split_bf16(self[0], _ONE_PASS_PARTS)


def _dot_split(x: torch.Tensor, w_parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """float32-grade GEMM from bf16 operand splits:

        x @ w ~= sum_j x_hi @ w_j  +  sum_{j<last} x_lo @ w_j

    one float32 product per term, summed smallest terms first.  Each
    product of two bf16 values is exact in float32, so the terms are
    computed as float32 matmuls of the bf16-exact values."""
    x_hi_f = _bf16_trunc(x)
    x_hi = x_hi_f.to(torch.bfloat16)
    x_lo = (x - x_hi_f).to(torch.bfloat16)
    terms = [(x_hi, w) for w in w_parts] + [(x_lo, w) for w in w_parts[:-1]]
    acc = None
    for xa, wa in reversed(terms):  # low-order products first
        t = xa.to(torch.float32) @ wa.to(torch.float32)
        acc = t if acc is None else acc + t
    return acc


#: log2(m) for m in [1, 2): degree-5 least-squares fit, max |err| 3.2e-5.
_LOG2_POLY = (-2.786805564, 5.046852936, -3.492466043, 1.593884548,
              -4.048623094e-01, 4.342836333e-02)

_LOG10_2 = 0.30102999566398120


def _f32(v: float) -> float:
    """v rounded to float32, so a Python scalar enters float32 arithmetic
    with exactly the value the CUDA kernel receives."""
    return float(np.float32(v))


def _fast_log2(p: torch.Tensor) -> torch.Tensor:
    """Exponent-extraction log2: integer ops plus a degree-5 polynomial.
    p is a non-negative float32; p == 0 gives about -127 (finite)."""
    i = p.contiguous().view(torch.int32)
    e = ((i >> 23) & 0x1FF) - 127  # logical shift of the sign-free bits
    m = ((i & 0x007FFFFF) | 0x3F800000).view(torch.float32)
    r = torch.full_like(m, _f32(_LOG2_POLY[-1]))
    for c in _LOG2_POLY[-2::-1]:
        r = r * m + _f32(c)
    return e.to(torch.float32) + r


def _scale_epilogue(p: torch.Tensor, *, log_scaling: bool, a: float, b: float,
                    fast_log: bool = False) -> torch.Tensor:
    if log_scaling and fast_log:
        # a*log10(p) + b == (a*log10(2))*log2(p) + b
        return _f32(a * _LOG10_2) * _fast_log2(p) + _f32(b)
    v = torch.log10(p) if log_scaling else torch.sqrt(p)
    return _f32(a) * v + _f32(b)


def _decode_block(x: torch.Tensor, bitshift: bool) -> torch.Tensor:
    """In-kernel decode: uint8/uint16 -> int32 -> (>> 4) -> float32.
    float32 input was decoded before the kernel (see :func:`_predecode`)."""
    if x.dtype == torch.float32:
        return x
    xi = x.to(torch.int32)
    if bitshift:
        xi = xi >> 4
    return xi.to(torch.float32)


def _predecode(raw2d: torch.Tensor, bit_depth: int, bitshift: bool) -> torch.Tensor:
    """Decode >16-bit containers before the kernel, which takes 8/16-bit
    integers or float32."""
    if bit_depth > 16:
        from ..ops.convert import decode
        return decode(raw2d, bit_depth, bitshift)
    return raw2d


def _dot_bf16(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The product of ``compute_dtype="bfloat16"``: x and w rounded to bf16
    (to nearest even, as the JAX package's ``astype``), then ONE float32
    product, as ``jnp.dot(..., preferred_element_type=float32)`` keeps it.
    Each product of two bf16 values is exact in float32.  Not a matmul of
    the bf16 tensors themselves: PyTorch returns that in bf16, rounding
    the sum."""
    return x.to(torch.bfloat16).to(torch.float32) @ w.to(torch.bfloat16).to(torch.float32)


# ---------------------------------------------------------------------------
# Plain versions of the kernels
# ---------------------------------------------------------------------------

def _gemm(x: torch.Tensor, w_parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """x @ w for the operator form of every rung: 2 or 3 bf16 parts (the
    split rungs), one bf16 part (``compute_dtype="bfloat16"``) or the
    float32 operator (the one-pass rung)."""
    if len(w_parts) > 1:
        return _dot_split(x, w_parts)
    if w_parts[0].dtype == torch.bfloat16:
        return _dot_bf16(x, w_parts[0])
    return x @ w_parts[0]


def depth_plain(raw2d, w_re_parts, w_im_parts, *, bitshift: bool):
    """``_kernel_depth`` (one float32 operator per axis, or at
    ``compute_dtype="bfloat16"`` one bf16 part) and ``_kernel_depth_split``
    (2 or 3 bf16 parts per axis): decode, then the two GEMMs (:func:`_gemm`).
    Returns planar (re, im) float32 (lines, half)."""
    x = _decode_block(raw2d, bitshift)
    return _gemm(x, w_re_parts), _gemm(x, w_im_parts)


def depth_scale_plain(raw2d, w_re_parts, w_im_parts, mean2, *, bitshift: bool,
                      log_scaling: bool, a: float, b: float,
                      fast_log: bool = False,
                      out_dtype: torch.dtype = torch.float32):
    """``_kernel_depth_scale`` / ``_kernel_depth_scale_split``: decode, the
    two GEMMs, FPN mean subtraction, p = re^2+im^2, the scale epilogue and
    the store in ``out_dtype``."""
    x = _decode_block(raw2d, bitshift)
    re = _gemm(x, w_re_parts) - mean2[0:1, :]
    im = _gemm(x, w_im_parts) - mean2[1:2, :]
    p = re * re + im * im
    out = _scale_epilogue(p, log_scaling=log_scaling, a=a, b=b,
                          fast_log=fast_log)
    return out.to(out_dtype)


def depth_scale_concat_plain(raw2d, w_parts, mean2, *, bitshift: bool,
                             log_scaling: bool, a: float, b: float,
                             out_dtype: torch.dtype = torch.float32):
    """``_kernel_depth_scale_concat`` (one float32 (n_in, 2*half) operator
    [W_re | W_im]) and ``_kernel_depth_scale_concat_split`` (2 or 3 bf16
    parts of it): decode, ONE GEMM against the wide operator, re and im
    sliced from it, FPN mean subtraction, the scale epilogue and the store
    in ``out_dtype``."""
    x = _decode_block(raw2d, bitshift)
    y = _gemm(x, w_parts)
    half = y.shape[-1] // 2
    re = y[:, :half] - mean2[0:1, :]
    im = y[:, half:] - mean2[1:2, :]
    p = re * re + im * im
    return _scale_epilogue(p, log_scaling=log_scaling, a=a, b=b).to(out_dtype)


def prep_phase_plain(raw2d, op_parts, cos_row, sin_row, *, bitshift: bool):
    """``_kernel_phase`` (one float32 operator) and ``_kernel_phase_split``
    (2 or 3 bf16 parts): decode, y = x @ P, then (y cos, y sin).  Returns
    complex64 (lines, n_out)."""
    y = _gemm(_decode_block(raw2d, bitshift), op_parts)
    return torch.complex(y * cos_row, y * sin_row)


def prep_real_plain(raw2d, op_parts, *, bitshift: bool):
    """``_kernel_real`` / ``_kernel_real_split``: decode, y = x @ P.
    Returns float32 (lines, n_out)."""
    return _gemm(_decode_block(raw2d, bitshift), op_parts)


# ---------------------------------------------------------------------------
# Agreement of a kernel with its plain version
# ---------------------------------------------------------------------------
#
# Both sides are float32; the bounds, and why (n_in = 1024 and 1664, 12-bit
# and float inputs):
# * planar (re, im): ||kernel - plain||_2 <= 3e-6 ||plain||_2.  Summing the
#   contraction in another order costs at most 7e-7 (float32 against a
#   float64 evaluation of the same pass terms); the nearest wrong rung --
#   the "highest" parts through the 3-pass math -- is 1.3e-5 or more off.
# * scaled image, float32 store: equal finite masks; over the voxels at or
#   above the display floor (plain >= 0) an RMS error <= 1e-6 and a max
#   error <= 1e-4 display units.  Reordering costs at most 1.3e-7 RMS; the
#   wrong rung above is 3.4e-6 RMS or more off.  Below the floor p -> 0 and
#   log10 amplifies rounding without bound; those voxels display black.
# * bfloat16 store: the max bound plus one bf16 step (2^-7 |plain|), as a
#   value near a bf16 boundary may round either way.  This checks the
#   store; the float32 cases check the rung.
# * prep spectra (complex64 as (re, im), or float32): relative L2 <= 1e-6.
#   Measured on the CPU at n = 1024 and 1664, 12-bit (shifted and not) and
#   float inputs, with and without background removal in the operator: a
#   sequential float32 sum over n_in differs from the plain version by at
#   most 1.44e-7, and each from a float64 evaluation of the same pass terms
#   by at most 2.8e-7; the nearest wrong rung -- the "highest" parts through
#   the 3-pass math -- is 8.5e-6 or more off, and the 3-pass math without
#   x_lo 2.7e-3 or more.  On an H100 the split prep kernel (bf16 wgmma, a
#   float32 fold every 64 samples) reads 5.9e-8 to 1.7e-7, the highest with
#   background removal; summed over n_in in one wgmma chain it read up to
#   1.8e-6 there.

PLANAR_REL_L2 = 3e-6
PREP_REL_L2 = 1e-6
SCALE_RMS = 1e-6
SCALE_MAX = 1e-4
BF16_STEP = 2.0 ** -7


def planar_error(got: Sequence[torch.Tensor], ref: Sequence[torch.Tensor]) -> float:
    """||got - ref||_2 / ||ref||_2 over the planar pair (re, im)."""
    num = sum(float((g.double() - r.double()).square().sum()) for g, r in zip(got, ref))
    den = sum(float(r.double().square().sum()) for r in ref)
    return (num / den) ** 0.5


def prep_error(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Relative L2 error of prep spectra, complex (over re and im) or real."""
    split = lambda t: (t.real, t.imag) if t.is_complex() else (t,)
    return planar_error(split(got), split(ref))


def scale_error(got: torch.Tensor, ref: torch.Tensor) -> Tuple[float, float, bool]:
    """(RMS, max |got - ref|, within the bounds) over the voxels of ``ref``
    at or above the display floor; raises if the finite masks differ or the
    floor hides most of the image."""
    g, r = got.double(), ref.double()
    if not torch.equal(torch.isfinite(g), torch.isfinite(r)):
        raise AssertionError("kernel and plain version differ in finite mask")
    shown = torch.isfinite(r) & (r >= 0)
    if float(shown.double().mean()) <= 0.5:
        raise AssertionError("most voxels lie below the display floor")
    err = (g - r)[shown].abs()
    rms, worst = float(err.square().mean().sqrt()), float(err.max())
    if got.dtype == torch.bfloat16:
        return rms, worst, bool((err <= SCALE_MAX + BF16_STEP * r[shown].abs()).all())
    return rms, worst, rms <= SCALE_RMS and worst <= SCALE_MAX


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------

_IN_KIND = {torch.uint8: 0, torch.uint16: 1, torch.float32: 2}
_MODE_LOG, _MODE_LIN, _MODE_FAST_LOG = 0, 1, 2


def _check_raw(raw2d, family: str):
    if raw2d.dtype not in _IN_KIND:
        raise TypeError(f"{family} kernel takes uint8, uint16 or float32 lines, "
                        f"got {raw2d.dtype}")
    if raw2d.dim() != 2 or not raw2d.is_contiguous():
        raise ValueError(f"{family} kernel needs contiguous (lines, n_in) input")
    return raw2d.shape


def _check_parts(parts, n_in: int, dev, family: str, split: bool) -> int:
    """Every operator part a contiguous (n_in, n_out) tensor on ``dev``,
    bf16 for a split and float32 for an unsplit operator, or bf16 for the
    one part of ``compute_dtype="bfloat16"``; returns n_out."""
    want = torch.bfloat16 if split or parts[0].dtype == torch.bfloat16 else torch.float32
    n_out = parts[0].shape[-1]
    for w in parts:
        if w.device != dev or w.dtype != want or tuple(w.shape) != (n_in, n_out) \
                or not w.is_contiguous():
            raise ValueError(
                f"{family} operator part must be a contiguous {want} "
                f"({n_in}, {n_out}) tensor on {dev}, got {w.dtype} "
                f"{tuple(w.shape)} on {w.device}")
    return n_out


def _check_row(t, shape, dev, name: str) -> None:
    if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 {shape} tensor on {dev}")


def _check_launch(raw2d, w_re_parts, w_im_parts, mean2=None):
    """Validate what a fold kernel reads; returns (lines, n_in, half)."""
    lines, n_in = _check_raw(raw2d, "fold")
    if len(w_re_parts) not in (1, 2, 3) or len(w_im_parts) != len(w_re_parts):
        raise ValueError(f"fold kernel takes 1, 2 or 3 operator parts per "
                         f"axis, got {len(w_re_parts)}/{len(w_im_parts)}")
    half = _check_parts((*w_re_parts, *w_im_parts), n_in, raw2d.device, "fold",
                        split=len(w_re_parts) > 1)
    if mean2 is not None:
        _check_row(mean2, (2, half), raw2d.device, "mean2")
    return lines, n_in, half


def _check_concat_launch(raw2d, w_parts, mean2):
    """Validate what a concat fold kernel reads; returns (lines, n_in, half)."""
    lines, n_in = _check_raw(raw2d, "fold")
    if len(w_parts) not in (1, 2, 3):
        raise ValueError(f"concat fold kernel takes 1, 2 or 3 operator parts, "
                         f"got {len(w_parts)}")
    width = _check_parts(w_parts, n_in, raw2d.device, "concat fold",
                         split=len(w_parts) > 1)
    if width % 2:
        raise ValueError(f"the concatenated operator [W_re | W_im] has an even "
                         f"width, got {width}")
    _check_row(mean2, (2, width // 2), raw2d.device, "mean2")
    return lines, n_in, width // 2


def _check_prep_launch(raw2d, op_parts, cos_row=None, sin_row=None):
    """Validate what a prep kernel reads; returns (lines, n_in, n_out)."""
    lines, n_in = _check_raw(raw2d, "prep")
    if len(op_parts) not in (1, 2, 3):
        raise ValueError(f"prep kernel takes 1, 2 or 3 operator parts, got {len(op_parts)}")
    n_out = _check_parts(op_parts, n_in, raw2d.device, "prep", split=len(op_parts) > 1)
    for name, row in (("cos_row", cos_row), ("sin_row", sin_row)):
        if row is not None:
            _check_row(row, (n_out,), raw2d.device, name)
    return lines, n_in, n_out


def _ptrs(parts):
    """The operator parts as three pointer arguments (unused ones NULL)."""
    p = [t.data_ptr() for t in parts]
    return p + [None] * (3 - len(p))


def _raise_on(rc: int, lib, what: str) -> None:
    if rc != 0:
        msg = lib.fold_gemm_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} ({msg})")


def _kernel_operands(raw2d, axes, family: str):
    """What a kernel of ``family`` (a one-pass LAUNCHES key) reads for the
    operator parts of each of its ``axes`` -- (re, im) for the two-operator
    fold kernels, ([W_re | W_im],) for the concat kernels, (P,) for the prep
    kernels -- that the launch checks passed: (passes,
    parts per axis, LAUNCHES key, route or None).  One bf16 part per axis is
    ``compute_dtype="bfloat16"`` (:func:`operator_rung` made that form): the
    tensor cores, x rounded to bf16 and one term, for every input type.  The
    one-pass rung runs on the tensor cores against the float32 operator's
    three bf16 parts for uint8/uint16 lines, and on the float32-FMA kernel
    for float32 lines (samples above 16 bits, which x_hi + x_lo cannot
    carry): the input type alone decides, never a failed build or launch."""
    passes = 2 * len(axes[0]) - 1
    if passes > 1:
        return passes, axes, family + "_split", None
    if axes[0][0].dtype == torch.bfloat16:
        return _BF16_PASS, axes, family, "tensor_core_bf16"
    if raw2d.dtype == torch.float32:
        return 1, axes, family, "simt"
    split = [w.split if isinstance(w, OnePass) else _split_bf16(w[0], _ONE_PASS_PARTS)
             for w in axes]
    _check_parts([p for parts in split for p in parts], raw2d.shape[1], raw2d.device, family,
                 split=True)
    return 1, split, family, "tensor_core"


def _count_launch(key: str, route) -> None:
    LAUNCHES[key] += 1
    if route is not None:
        ONE_PASS_ROUTES[key][route] += 1


def _launch_depth(raw2d, w_re_parts, w_im_parts, *, bitshift: bool):
    from . import build

    lines, n_in, half = _check_launch(raw2d, w_re_parts, w_im_parts)
    re = torch.empty((lines, half), dtype=torch.float32, device=raw2d.device)
    im = torch.empty_like(re)
    if lines == 0:
        return re, im
    lib = build.load()
    passes, (w_re, w_im), key, route = _kernel_operands(raw2d, (w_re_parts, w_im_parts),
                                                        "depth")
    with torch.cuda.device(raw2d.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.fold_gemm_planar(
            raw2d.data_ptr(), _IN_KIND[raw2d.dtype], int(bitshift), passes,
            *_ptrs(w_re), *_ptrs(w_im),
            re.data_ptr(), im.data_ptr(), lines, n_in, half, stream)
    _raise_on(rc, lib, "fold_gemm_planar")
    _count_launch(key, route)
    return re, im


def _launch_depth_scale(raw2d, w_re_parts, w_im_parts, mean2, *, bitshift,
                        log_scaling, a, b, fast_log, out_dtype):
    from . import build

    lines, n_in, half = _check_launch(raw2d, w_re_parts, w_im_parts, mean2)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fold kernel stores float32 or bfloat16, got {out_dtype}")
    out = torch.empty((lines, half), dtype=out_dtype, device=raw2d.device)
    if lines == 0:
        return out
    if not log_scaling:
        mode, a_k = _MODE_LIN, a
    elif fast_log:
        mode, a_k = _MODE_FAST_LOG, a * _LOG10_2
    else:
        mode, a_k = _MODE_LOG, a
    lib = build.load()
    passes, (w_re, w_im), key, route = _kernel_operands(raw2d, (w_re_parts, w_im_parts),
                                                        "depth_scale")
    with torch.cuda.device(raw2d.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.fold_gemm_scale(
            raw2d.data_ptr(), _IN_KIND[raw2d.dtype], int(bitshift), passes,
            *_ptrs(w_re), *_ptrs(w_im), mean2.data_ptr(),
            out.data_ptr(), int(out_dtype == torch.bfloat16), mode,
            ctypes.c_float(a_k), ctypes.c_float(b), lines, n_in, half, stream)
    _raise_on(rc, lib, "fold_gemm_scale")
    _count_launch(key, route)
    return out


def _launch_depth_scale_concat(raw2d, w_parts, mean2, *, bitshift, log_scaling,
                               a, b, out_dtype):
    from . import build

    lines, n_in, half = _check_concat_launch(raw2d, w_parts, mean2)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fold kernel stores float32 or bfloat16, got {out_dtype}")
    out = torch.empty((lines, half), dtype=out_dtype, device=raw2d.device)
    if lines == 0:
        return out
    lib = build.load()
    passes, (parts,), key, route = _kernel_operands(raw2d, (w_parts,), "depth_scale_concat")
    with torch.cuda.device(raw2d.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.fold_gemm_scale_concat(
            raw2d.data_ptr(), _IN_KIND[raw2d.dtype], int(bitshift), passes,
            *_ptrs(parts), mean2.data_ptr(), out.data_ptr(),
            int(out_dtype == torch.bfloat16), _MODE_LOG if log_scaling else _MODE_LIN,
            ctypes.c_float(a), ctypes.c_float(b), lines, n_in, half, stream)
    _raise_on(rc, lib, "fold_gemm_scale_concat")
    _count_launch(key, route)
    return out


def _launch_prep(raw2d, op_parts, cos_row, sin_row, *, bitshift: bool):
    """The phase kernel (cos_row and sin_row given; complex64 out) or the
    real kernel (both None; float32 out)."""
    from . import build

    phase = cos_row is not None
    if phase != (sin_row is not None):
        raise ValueError("the phase kernel takes both cos_row and sin_row")
    lines, n_in, n_out = _check_prep_launch(raw2d, op_parts, cos_row, sin_row)
    out = torch.empty((lines, n_out), device=raw2d.device,
                      dtype=torch.complex64 if phase else torch.float32)
    if lines == 0:
        return out
    lib = build.load()
    family = "prep_phase" if phase else "prep_real"
    passes, (parts,), key, route = _kernel_operands(raw2d, (op_parts,), family)
    args = (raw2d.data_ptr(), _IN_KIND[raw2d.dtype], int(bitshift), passes, *_ptrs(parts))
    with torch.cuda.device(raw2d.device):
        stream = torch.cuda.current_stream().cuda_stream
        if phase:  # interleaved (re, im) straight into the complex64 tensor
            rc = lib.prep_gemm_phase(*args, cos_row.data_ptr(), sin_row.data_ptr(),
                                     out.data_ptr(), lines, n_in, n_out, stream)
        else:
            rc = lib.prep_gemm_real(*args, out.data_ptr(), lines, n_in, n_out, stream)
    _raise_on(rc, lib, family)
    _count_launch(key, route)
    return out


def _on_cuda(t: torch.Tensor, family: str = "fold") -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (the plain version); any other device has no kernel."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise RuntimeError(f"no {family} kernel for device {t.device}")


def fold_depth(raw2d, w_re_parts, w_im_parts, *, bitshift: bool):
    """Planar depth profiles of (lines, n_in) input: the CUDA kernel for a
    CUDA tensor, the plain version for a CPU tensor."""
    if _on_cuda(raw2d):
        return _launch_depth(raw2d, w_re_parts, w_im_parts, bitshift=bitshift)
    return depth_plain(raw2d, w_re_parts, w_im_parts, bitshift=bitshift)


def fold_depth_scale(raw2d, w_re_parts, w_im_parts, mean2, *, bitshift: bool,
                     log_scaling: bool, a: float, b: float,
                     fast_log: bool = False,
                     out_dtype: torch.dtype = torch.float32):
    """Scaled magnitude of (lines, n_in) input: the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    kw = dict(bitshift=bitshift, log_scaling=log_scaling, a=a, b=b,
              fast_log=fast_log, out_dtype=out_dtype)
    if _on_cuda(raw2d):
        return _launch_depth_scale(raw2d, w_re_parts, w_im_parts, mean2, **kw)
    return depth_scale_plain(raw2d, w_re_parts, w_im_parts, mean2, **kw)


def fold_depth_scale_concat(raw2d, w_parts, mean2, *, bitshift: bool,
                            log_scaling: bool, a: float, b: float,
                            out_dtype: torch.dtype = torch.float32):
    """Scaled magnitude of (lines, n_in) input through the concatenated
    operator parts: the CUDA kernel for a CUDA tensor, the plain version
    for a CPU tensor."""
    kw = dict(bitshift=bitshift, log_scaling=log_scaling, a=a, b=b, out_dtype=out_dtype)
    if _on_cuda(raw2d):
        return _launch_depth_scale_concat(raw2d, w_parts, mean2, **kw)
    return depth_scale_concat_plain(raw2d, w_parts, mean2, **kw)


def prep_phase(raw2d, op_parts, cos_row, sin_row, *, bitshift: bool):
    """Phasor-multiplied prep spectra, complex64 (lines, n_out), of
    (lines, n_in) input: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    if _on_cuda(raw2d, "prep"):
        return _launch_prep(raw2d, op_parts, cos_row, sin_row, bitshift=bitshift)
    return prep_phase_plain(raw2d, op_parts, cos_row, sin_row, bitshift=bitshift)


def prep_real(raw2d, op_parts, *, bitshift: bool):
    """Real prep spectra, float32 (lines, n_out): the CUDA kernel for a
    CUDA tensor, the plain version for a CPU tensor."""
    if _on_cuda(raw2d, "prep"):
        return _launch_prep(raw2d, op_parts, None, None, bitshift=bitshift)
    return prep_real_plain(raw2d, op_parts, bitshift=bitshift)


# ---------------------------------------------------------------------------
# Public wrappers (same signatures as the JAX package, minus ``interpret``)
# ---------------------------------------------------------------------------

def operator_rung(cfg: ProcConfig) -> str:
    """The operator form of ``cfg``'s kernels: ``cfg.matmul_precision`` at
    float32 compute, :data:`BF16` at ``compute_dtype="bfloat16"``, where
    ``matmul_precision`` is ignored (the JAX package's
    ``_effective_precision``)."""
    return BF16 if cfg.compute_dtype == "bfloat16" else cfg.matmul_precision


def _operator_parts(w, rung: str) -> Tuple[torch.Tensor, ...]:
    """The operator as the wrappers take it at ``rung`` (a matmul precision,
    or :data:`BF16`): one float32 part (an :class:`OnePass`), 2/3 bf16
    parts, or at :data:`BF16` one bf16 part, the operator rounded to
    nearest.  ``w`` is the float32 operator (split or rounded here) or a
    tuple of parts already made for ``rung`` (as ``Curves.depth_parts`` and
    ``Curves.prep_parts`` hold them), which is returned as is."""
    parts = _SPLIT_PARTS.get(rung, 1)
    if isinstance(w, (tuple, list)):
        if len(w) != parts or (parts == 1 and (w[0].dtype == torch.bfloat16) != (rung == BF16)):
            raise ValueError(f"rung {rung!r} takes {parts} operator part(s)"
                             f"{' of bf16' if rung == BF16 else ''}, got {len(w)} "
                             f"of {w[0].dtype}")
        return w if isinstance(w, OnePass) else tuple(w)
    if rung == BF16:
        return (w.to(torch.bfloat16).contiguous(),)
    return _split_bf16(w, parts) if parts > 1 else OnePass(w)


def concat_operator(w_re, w_im, rung: str) -> Tuple[torch.Tensor, ...]:
    """The concatenated operator [W_re | W_im] (n_in, 2*half) as the concat
    kernels take it at ``rung``: at the default rung an :class:`OnePass` of
    the wide float32 operator, whose three bf16 parts the tensor-core route
    reads.  From the float32 operators it is concatenated, then split or
    rounded, as the JAX package does; from parts already made per axis
    (``Curves.depth_parts``) each part pair is concatenated, which gives the
    same parts: the split and the rounding are elementwise."""
    if isinstance(w_re, (tuple, list)):
        re, im = _operator_parts(w_re, rung), _operator_parts(w_im, rung)
        wide = tuple(torch.cat([r, i], dim=1) for r, i in zip(re, im))
        return OnePass(wide[0]) if isinstance(re, OnePass) else wide
    return _operator_parts(torch.cat([w_re, w_im], dim=1), rung)


def _check_fold_config(depth_op_re, depth_op_im) -> None:
    if depth_op_re is None or depth_op_im is None:
        raise ValueError(
            "cfg.fft_via_matmul is set but curves.depth_op_* is None -- "
            "build the curves with the same config (make_curves(acq, cfg, ...))")


def fused_depth_scale(
    raw: torch.Tensor,
    depth_op_re: torch.Tensor,
    depth_op_im: torch.Tensor,
    mean2: torch.Tensor,
    acq: AcqParams,
    cfg: ProcConfig,
    *,
    wide: Optional[Tuple[torch.Tensor, ...]] = None,
) -> torch.Tensor:
    """Raw uint lines (..., n_in) -> scaled magnitude (..., half) in one
    kernel: decode, folded GEMMs, FPN mean subtraction and dynamic-range
    scaling.  ``mean2`` is float32 (2, half), the (re, im) FPN mean line
    (zeros when FPN is off).  The store dtype is ``cfg.output_dtype``.
    ``depth_op_re``/``depth_op_im`` are the float32 operators or their parts
    already made for the configuration's rung (:func:`operator_rung`,
    ``Curves.depth_parts``).
    With ``cfg.fold_concat`` the concat kernels run against ``wide``, the
    concatenated operator's parts made once per curve build
    (``Curves.depth_concat_parts``), or, where it is None (curves carried in
    from the JAX package), against the operators concatenated here
    (:func:`concat_operator`): the same parts either way.
    ``cfg.fold_k_split`` and ``cfg.pallas_tile`` do not change the result."""
    _check_fold_config(depth_op_re, depth_op_im)
    lead_shape = raw.shape[:-1]
    raw2d = _predecode(raw.reshape(-1, raw.shape[-1]).contiguous(),
                       acq.bit_depth, cfg.bitshift)
    mean2 = mean2.to(torch.float32).contiguous()
    out_dtype = torch.bfloat16 if cfg.output_dtype == "bfloat16" else torch.float32
    half = mean2.shape[-1]
    a, b = _scale_affine(cfg.log_scaling, half, cfg.grayscale_min, cfg.grayscale_max,
                         cfg.addend, cfg.multiplicator)
    rung = operator_rung(cfg)
    if cfg.fold_concat:
        if wide is None:
            wide = concat_operator(depth_op_re, depth_op_im, rung)
        mag = fold_depth_scale_concat(raw2d, wide, mean2, bitshift=cfg.bitshift,
                                      log_scaling=cfg.log_scaling, a=a, b=b,
                                      out_dtype=out_dtype)
    else:
        mag = fold_depth_scale(
            raw2d, _operator_parts(depth_op_re, rung), _operator_parts(depth_op_im, rung), mean2,
            bitshift=cfg.bitshift, log_scaling=cfg.log_scaling, a=a, b=b,
            fast_log=cfg.fast_log, out_dtype=out_dtype)
    return mag.reshape(*lead_shape, mag.shape[-1])


def fused_depth_transform(
    raw: torch.Tensor,
    depth_op_re: torch.Tensor,
    depth_op_im: torch.Tensor,
    acq: AcqParams,
    cfg: ProcConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw uint lines (..., n_in) -> truncated depth profiles: planar
    (re, im) float32 (..., half).

    ``fold_backend="pallas"`` runs the kernel (CUDA tensors) or its plain
    version (CPU tensors); ``fold_backend="xla"`` is plain torch matmuls on
    any device, as the JAX package's XLA route is plain jnp matmuls.  The
    operators are taken as :func:`fused_depth_scale` takes them."""
    _check_fold_config(depth_op_re, depth_op_im)
    lead_shape = raw.shape[:-1]
    raw2d = _predecode(raw.reshape(-1, raw.shape[-1]).contiguous(),
                       acq.bit_depth, cfg.bitshift)
    w_re = _operator_parts(depth_op_re, operator_rung(cfg))
    w_im = _operator_parts(depth_op_im, operator_rung(cfg))
    if cfg.fold_backend == "xla":
        re, im = depth_plain(raw2d, w_re, w_im, bitshift=cfg.bitshift)
    else:
        re, im = fold_depth(raw2d, w_re, w_im, bitshift=cfg.bitshift)
    half = re.shape[-1]
    return re.reshape(*lead_shape, half), im.reshape(*lead_shape, half)


def fused_prep(
    raw: torch.Tensor,
    prep_operator,
    phase: Optional[torch.Tensor],
    acq: AcqParams,
    cfg: ProcConfig,
) -> torch.Tensor:
    """Stages 1-3 of the FFT path in one kernel.

    raw: uint (..., n_in); prep_operator: the float32 (n_in, n_out) operator
    of :func:`build_prep_operator` or its parts already made for the
    configuration's rung (``Curves.prep_parts``); phase: complex64
    (n_out,) phasor or None.  Returns complex64 (phase given) or float32
    (..., n_out).  ``cfg.pallas_tile`` does not change the result."""
    if prep_operator is None:
        raise ValueError(
            "cfg.use_pallas_prep is set but curves.prep_operator is None -- "
            "build the curves with the same config (make_curves(acq, cfg, ...))")
    lead_shape = raw.shape[:-1]
    raw2d = _predecode(raw.reshape(-1, raw.shape[-1]).contiguous(),
                       acq.bit_depth, cfg.bitshift)
    parts = _operator_parts(prep_operator, operator_rung(cfg))
    if phase is None:
        out = prep_real(raw2d, parts, bitshift=cfg.bitshift)
    else:
        out = prep_phase(raw2d, parts, phase.real.contiguous(), phase.imag.contiguous(),
                         bitshift=cfg.bitshift)
    return out.reshape(*lead_shape, out.shape[-1])
