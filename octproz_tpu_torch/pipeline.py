"""The per-buffer FD-OCT reconstruction step.

Counterpart of ``octproz_tpu/pipeline.py``: the reference's hot loop
``octCudaPipeline`` (cuda_code.cu:1389-1605) in one of two branches.

Fold path (``fft_via_matmul=True``):

  1-4. decode, resample, window, dispersion, inverse DFT, truncation: one
       planar GEMM (kernels/fused_prep)
  5.   fixed-pattern-noise removal with carried mean-line state
  6.   log/lin dynamic-range scaling

After FPN determination (or with FPN off) stages 1-6 run as ONE kernel
(``fused_depth_scale``; with ``fold_concat`` one GEMM against the
concatenated operator [W_re | W_im]).

FFT path (``fft_via_matmul=False``), the reference's own order:

  1-3. decode, background removal, resample x window x dispersion: one prep
       kernel (``use_pallas_prep``) or torch ops
  4.   batched unnormalised inverse FFT (``torch.fft``; cuFFT on the card),
       the half-spectrum RFFT for real spectra
  5.   truncation and FPN removal
  6.   log/lin scaling

Both branches end in the post stages (B-scan flip, sinusoidal correction,
post background removal), which run in float32; a bfloat16 store narrows
after them.  ``compute_dtype="bfloat16"`` rounds the GEMM operands (the
kernels' x and operators, the torch-ops resampler's x and R) to bf16 and
keeps every product and epilogue in float32.  The FPN-once branch reads
the host flag ``FpnState.determined``: a Python ``if``, no device-to-host
sync.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .ops import background, convert, dispersion, fft, fpn, postprocess, resample
from .params import AcqParams, Curves, FpnMode, FpnState, ProcConfig
from .utils.profiling import RECORDER


def has_post(cfg: ProcConfig) -> bool:
    """True when a post stage (flip, sinusoidal, post background) runs."""
    return cfg.bscan_flip or cfg.sinusoidal_correction or cfg.post_background_removal


def kernel_config(cfg: ProcConfig) -> ProcConfig:
    """The configuration a fused kernel stores with: float32 while a post
    stage still consumes its output (the narrowing to bfloat16 comes after
    :func:`postprocess_volume`)."""
    if has_post(cfg) and cfg.output_dtype == "bfloat16":
        return dataclasses.replace(cfg, output_dtype="float32")
    return cfg


def narrow(mag: torch.Tensor, cfg: ProcConfig) -> torch.Tensor:
    """The store dtype: arithmetic stays float32, the volume may be bf16."""
    if cfg.output_dtype == "bfloat16" and mag.dtype != torch.bfloat16:
        return mag.to(torch.bfloat16)
    return mag


def prep_spectra(raw: torch.Tensor, curves: Curves, acq: AcqParams,
                 cfg: ProcConfig) -> torch.Tensor:
    """Stages 1-3: decode -> DC removal -> resample x window x phase.
    raw uint (bscans, ascans, samples) -> float32 (real path) or complex64
    (dispersion path) of the same shape."""
    if cfg.use_pallas_prep:
        from .kernels.fused_prep import fused_prep

        op = curves.prep_parts if curves.prep_parts is not None else curves.prep_operator
        return fused_prep(raw, op, curves.phase if cfg.dispersion else None, acq, cfg)
    x = convert.decode(raw, acq.bit_depth, cfg.bitshift)
    if cfg.background_removal:
        x = background.remove_background(x, cfg.rolling_average_window)
    if cfg.resampling:
        if cfg.resample_via_matmul:
            from .kernels.fused_prep import operator_rung

            x = resample.apply_matmul(x, curves.resample_matrix, precision=operator_rung(cfg))
        else:
            x = resample.apply_gather(x, curves.resample_curve, cfg.interpolation)
    return dispersion.prep_spectra(x, curves.window if cfg.windowing else None,
                                   curves.phase if cfg.dispersion else None)


def transform_to_depth(spectra: torch.Tensor, half: int) -> torch.Tensor:
    """Stage 4 + truncation: the inverse FFT, positive-depth half only
    (the half-spectrum RFFT for real spectra).  complex64 (..., half)."""
    if spectra.is_complex():
        return postprocess.truncate_half(fft.ifft_spectra(spectra))
    return fft.ifft_spectra_real_half(spectra, half)


def apply_fpn_planar(z_re: torch.Tensor, z_im: torch.Tensor, state: FpnState,
                     acq: AcqParams, cfg: ProcConfig
                     ) -> Tuple[torch.Tensor, torch.Tensor, FpnState]:
    """Stage 5: FPN removal with carried mean-line state.  The statistics use
    the first ``bscans_for_noise * ascans_per_bscan`` A-scans of the buffer
    (cuda_code.cu:1519-1522) on the truncated half."""
    width = z_re.shape[-1]
    n_noise_lines = min(cfg.bscans_for_noise, acq.bscans_per_buffer) * acq.ascans_per_bscan
    if cfg.fpn_mode == FpnMode.CONTINUOUS or not state.determined:
        mean = FpnState.pack(*fpn.minimum_variance_mean_planar(
            z_re.reshape(-1, width)[:n_noise_lines],
            z_im.reshape(-1, width)[:n_noise_lines]))
    else:  # ONCE: reuse once determined (cuda_code.cu:1521-1524)
        mean = state.mean_line
    return z_re - mean[0], z_im - mean[1], FpnState(mean_line=mean, determined=True)


def apply_fpn(z_half: torch.Tensor, state: FpnState, acq: AcqParams,
              cfg: ProcConfig) -> Tuple[torch.Tensor, FpnState]:
    """Complex form of :func:`apply_fpn_planar`."""
    re, im, state = apply_fpn_planar(z_half.real, z_half.imag, state, acq, cfg)
    return torch.complex(re, im), state


def postprocess_volume(mag: torch.Tensor, curves: Curves, cfg: ProcConfig) -> torch.Tensor:
    """Stages 7-9 on the scaled magnitude volume (bscans, ascans, depth)."""
    if cfg.bscan_flip:
        mag = postprocess.bscan_flip(mag)
    if cfg.sinusoidal_correction:
        mag = postprocess.sinusoidal_correction(mag, curves.sinusoidal_curve)
    if cfg.post_background_removal:
        mag = postprocess.remove_post_background(
            mag, curves.post_background, cfg.post_background_weight,
            cfg.post_background_offset)
    return mag


def fused_ready(cfg: ProcConfig, fpn_state: FpnState) -> bool:
    """True when the steady-state kernel (GEMM + FPN subtraction + scaling
    in one launch) computes the buffer: the fused fold path with a constant
    FPN mean line (mode OFF, or ONCE already determined; a host flag)."""
    return (cfg.fft_via_matmul and cfg.fused_scale and cfg.fold_backend == "pallas"
            and (cfg.fpn_mode == FpnMode.OFF
                 or (cfg.fpn_mode == FpnMode.ONCE and fpn_state.determined)))


def depth_operators(curves: Curves):
    """The depth operators as the fold wrappers take them: the parts split
    once by ``make_curves`` where the curves hold them (curves carried in
    from the JAX package do not), else the float32 operators."""
    if curves.depth_parts is not None:
        return curves.depth_parts
    return curves.depth_op_re, curves.depth_op_im


def _fold_branch(raw, curves, fpn_state, acq, cfg):
    from .kernels.fused_prep import fused_depth_scale, fused_depth_transform

    op_re, op_im = depth_operators(curves)
    if fused_ready(cfg, fpn_state):
        # Steady state: GEMM + FPN subtraction + scaling in one kernel.  OFF
        # subtracts zeros, ignoring any carried state.
        mean = (torch.zeros_like(fpn_state.mean_line)
                if cfg.fpn_mode == FpnMode.OFF else fpn_state.mean_line)
        return fused_depth_scale(raw, op_re, op_im, mean, acq, kernel_config(cfg),
                                 wide=curves.depth_concat_parts), fpn_state
    z_re, z_im = fused_depth_transform(raw, op_re, op_im, acq, cfg)
    if cfg.fpn_mode != FpnMode.OFF:
        z_re, z_im, fpn_state = apply_fpn_planar(z_re, z_im, fpn_state, acq, cfg)
    scale = (postprocess.scale_log_planar if cfg.log_scaling
             else postprocess.scale_lin_planar)
    return scale(z_re, z_im, acq.output_ascan_length, cfg.grayscale_min,
                 cfg.grayscale_max, cfg.addend, cfg.multiplicator), fpn_state


def _fft_branch(raw, curves, fpn_state, acq, cfg):
    half = acq.output_ascan_length
    z_half = transform_to_depth(prep_spectra(raw, curves, acq, cfg), half)
    if cfg.fpn_mode != FpnMode.OFF:
        z_half, fpn_state = apply_fpn(z_half, fpn_state, acq, cfg)
    scale = postprocess.scale_log if cfg.log_scaling else postprocess.scale_lin
    return scale(z_half, half, cfg.grayscale_min, cfg.grayscale_max, cfg.addend,
                 cfg.multiplicator), fpn_state


def process_buffer(
    raw: torch.Tensor,
    curves: Curves,
    fpn_state: FpnState,
    acq: AcqParams,
    cfg: ProcConfig,
) -> Tuple[torch.Tensor, FpnState]:
    """raw uint (bscans, ascans, samples) -> (processed (bscans, ascans,
    samples//2) in cfg.output_dtype, new FPN state)."""
    branch = _fold_branch if cfg.fft_via_matmul else _fft_branch
    with RECORDER.span("octproz.depth", raw):
        mag, fpn_state = branch(raw, curves, fpn_state, acq, cfg)
    if has_post(cfg):
        with RECORDER.span("octproz.post", mag):
            mag = postprocess_volume(mag, curves, cfg)
    return narrow(mag, cfg), fpn_state


def make_step(acq: AcqParams, cfg: ProcConfig):
    """``step(raw, curves, fpn_state) -> (processed, fpn_state)`` for a
    fixed (acq, cfg) pair.  PyTorch runs eagerly, so there is nothing to
    compile."""

    def step(raw, curves: Curves, fpn_state: FpnState):
        return process_buffer(raw, curves, fpn_state, acq, cfg)

    return step


def make_scan_step(acq: AcqParams, cfg: ProcConfig):
    """``scan_step(raw_stack, curves, fpn_state) -> (processed_stack,
    fpn_state)`` for ``raw_stack`` (k, bscans, ascans, samples): the FPN
    state threads buffer to buffer exactly like repeated :func:`make_step`
    calls."""
    step = make_step(acq, cfg)

    def scan_step(raw_stack, curves: Curves, fpn_state: FpnState):
        outs = []
        for raw in raw_stack:
            out, fpn_state = step(raw, curves, fpn_state)
            outs.append(out)
        return torch.stack(outs), fpn_state

    return scan_step


def initial_fpn_state(acq: AcqParams, *, device) -> FpnState:
    """FPN state sized for the truncated (positive-depth) half, on
    ``device`` (required: the state lives where the buffers run)."""
    return FpnState.initial(acq.output_ascan_length, device=device)
