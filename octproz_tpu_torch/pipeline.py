"""The per-buffer FD-OCT reconstruction step, folded-GEMM branch.

Counterpart of ``octproz_tpu/pipeline.py`` for ``fft_via_matmul=True``, the
reference's hot loop ``octCudaPipeline`` (cuda_code.cu:1389-1605) as

  1-4. decode, resample, window, dispersion, inverse DFT, truncation: one
       planar GEMM (kernels/fused_prep)
  5.   fixed-pattern-noise removal with carried mean-line state
  6.   log/lin dynamic-range scaling

After FPN determination (or with FPN off) stages 1-6 run as ONE kernel
(``fused_depth_scale``).  The FPN-once branch reads the host flag
``FpnState.determined``: a Python ``if``, no device-to-host sync.

Configurations outside this slice raise ``NotImplementedError`` naming
their ROADMAP.md item (:func:`check_supported`); nothing is routed to
another path quietly.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .ops import fpn, postprocess
from .params import AcqParams, Curves, FpnMode, FpnState, ProcConfig


def check_supported(cfg: ProcConfig) -> None:
    """Raise NotImplementedError for configurations this package does not
    run yet, naming the ROADMAP.md item that ports them."""
    if not cfg.fft_via_matmul:
        raise NotImplementedError(
            "fft_via_matmul=False (the FFT path) is not ported yet "
            "(ROADMAP.md Queue 1, A8)")
    if cfg.use_pallas_prep:
        raise NotImplementedError(
            "use_pallas_prep is not ported yet (ROADMAP.md Queue 2, B7-B10)")
    if cfg.fold_concat:
        raise NotImplementedError(
            "fold_concat is not ported yet (ROADMAP.md Queue 2, B5/B6)")
    if cfg.compute_dtype != "float32":
        raise NotImplementedError(
            "compute_dtype='bfloat16' is not ported yet (ROADMAP.md Queue 1, A14)")
    post = [name for name in ("bscan_flip", "sinusoidal_correction",
                              "post_background_removal") if getattr(cfg, name)]
    if post:
        raise NotImplementedError(
            f"post stages {post} are not ported yet (ROADMAP.md Queue 1, A8/A9)")


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


def depth_operators(curves: Curves):
    """The depth operators as the fold wrappers take them: the parts split
    once by ``make_curves`` where the curves hold them (curves carried in
    from the JAX package do not), else the float32 operators."""
    if curves.depth_parts is not None:
        return curves.depth_parts
    return curves.depth_op_re, curves.depth_op_im


def process_buffer(
    raw: torch.Tensor,
    curves: Curves,
    fpn_state: FpnState,
    acq: AcqParams,
    cfg: ProcConfig,
) -> Tuple[torch.Tensor, FpnState]:
    """raw uint (bscans, ascans, samples) -> (processed (bscans, ascans,
    samples//2) in cfg.output_dtype, new FPN state)."""
    from .kernels.fused_prep import fused_depth_scale, fused_depth_transform

    check_supported(cfg)
    half = acq.output_ascan_length
    op_re, op_im = depth_operators(curves)
    fusable = (cfg.fused_scale and cfg.fold_backend == "pallas"
               and (cfg.fpn_mode == FpnMode.OFF
                    or (cfg.fpn_mode == FpnMode.ONCE and fpn_state.determined)))
    if fusable:
        # Steady state: GEMM + FPN subtraction + scaling in one kernel.  OFF
        # subtracts zeros, ignoring any carried state.
        mean = (torch.zeros_like(fpn_state.mean_line)
                if cfg.fpn_mode == FpnMode.OFF else fpn_state.mean_line)
        return fused_depth_scale(raw, op_re, op_im, mean, acq, cfg), fpn_state

    z_re, z_im = fused_depth_transform(raw, op_re, op_im, acq, cfg)
    if cfg.fpn_mode != FpnMode.OFF:
        z_re, z_im, fpn_state = apply_fpn_planar(z_re, z_im, fpn_state, acq, cfg)
    scale = (postprocess.scale_log_planar if cfg.log_scaling
             else postprocess.scale_lin_planar)
    mag = scale(z_re, z_im, half, cfg.grayscale_min, cfg.grayscale_max,
                cfg.addend, cfg.multiplicator)
    if cfg.output_dtype == "bfloat16":
        mag = mag.to(torch.bfloat16)
    return mag, fpn_state


def make_step(acq: AcqParams, cfg: ProcConfig):
    """``step(raw, curves, fpn_state) -> (processed, fpn_state)`` for a
    fixed (acq, cfg) pair.  PyTorch runs eagerly, so there is nothing to
    compile; the configuration is checked once here."""
    check_supported(cfg)

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


def initial_fpn_state(acq: AcqParams, device=None) -> FpnState:
    """FPN state sized for the truncated (positive-depth) half."""
    return FpnState.initial(acq.output_ascan_length, device=device)
