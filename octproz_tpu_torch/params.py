"""Processing parameters for the PyTorch/CUDA FD-OCT pipeline.

Field-for-field counterpart of ``octproz_tpu/params.py``: the same enums,
the same :class:`AcqParams` / :class:`ProcConfig` fields and validation, so
settings written for one package mean the same in the other.  What differs:

* :attr:`AcqParams.raw_dtype` returns torch dtypes.
* :class:`Curves` and :class:`FpnState` are plain dataclasses of tensors.
  ``FpnState.determined`` is a host ``bool``, so the FPN-once branch of the
  pipeline is a Python ``if`` with no device-to-host synchronisation.
* ``compute_dtype="bfloat16"`` runs the same bf16 operand rule on the
  tensor cores (``kernels/fused_prep``: x and the operator rounded to
  bf16, one float32-accumulated product).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import torch


class Interpolation(enum.Enum):
    """k-linearization interpolators (octalgorithmparameters.h:55-59)."""

    LINEAR = "linear"
    CUBIC = "cubic"
    LANCZOS = "lanczos"
    QUADRATIC = "quadratic"


class WindowType(enum.Enum):
    """Spectral window families (windowfunction.cpp:96-119)."""

    HANNING = "hanning"
    GAUSS = "gauss"
    SINE = "sine"
    LANCZOS = "lanczos"
    RECTANGULAR = "rectangular"
    FLATTOP = "flattop"
    TAYLOR = "taylor"


class FpnMode(enum.Enum):
    """Fixed-pattern-noise determination policy (cuda_code.cu:1517-1527)."""

    OFF = "off"
    ONCE = "once"            # determine on first buffer, then reuse
    CONTINUOUS = "continuous"  # redetermine every buffer


class DisplayFunction(enum.IntEnum):
    """Frame compositing mode for display slices (octalgorithmparameters.h:176-179)."""

    AVERAGING = 0
    MIP = 1


# Number of segments of the minimum-variance FPN estimator
# (octalgorithmparameters.h:35).
FPN_SEGMENTS = 9

# Relative tie band of the minimum-variance segment selection: every segment
# whose variance lies within FPN_TIE_EPS * (per-depth mean power) of the
# minimum is a tie and the LOWEST segment index wins (ops/fpn.py).
FPN_TIE_EPS = 1e-3


@dataclasses.dataclass(frozen=True)
class AcqParams:
    """Acquisition geometry (octalgorithmparameters.h:109-113).

    A raw *buffer* is ``bscans_per_buffer`` B-scans of ``ascans_per_bscan``
    A-scans of ``samples_per_line`` raw spectral samples each; a *volume* is
    ``buffers_per_volume`` buffers.
    """

    samples_per_line: int = 1024
    ascans_per_bscan: int = 512
    bscans_per_buffer: int = 256
    buffers_per_volume: int = 1
    bit_depth: int = 12

    def __post_init__(self):
        if self.samples_per_line < 4:
            raise ValueError("samples_per_line must be >= 4")
        if self.bit_depth < 1 or self.bit_depth > 32:
            raise ValueError("bit_depth must be in [1, 32]")

    @property
    def bytes_per_sample(self) -> int:
        # ceil(bitDepth / 8), octalgorithmparameters.cpp:137
        return (self.bit_depth + 7) // 8

    @property
    def raw_dtype(self) -> torch.dtype:
        if self.bit_depth <= 8:
            return torch.uint8
        if self.bit_depth <= 16:
            return torch.uint16
        return torch.uint32

    @property
    def ascans_per_buffer(self) -> int:
        return self.ascans_per_bscan * self.bscans_per_buffer

    @property
    def samples_per_buffer(self) -> int:
        return self.samples_per_line * self.ascans_per_buffer

    @property
    def buffer_shape(self):
        """(bscans, ascans, samples) layout of one raw buffer."""
        return (self.bscans_per_buffer, self.ascans_per_bscan, self.samples_per_line)

    @property
    def output_ascan_length(self) -> int:
        """Depth samples kept after mirror-artifact truncation (cuda_code.cu:709)."""
        return self.samples_per_line // 2

    @property
    def processed_buffer_shape(self):
        return (self.bscans_per_buffer, self.ascans_per_bscan, self.output_ascan_length)

    @property
    def bytes_per_buffer(self) -> int:
        return self.samples_per_buffer * self.bytes_per_sample


@dataclasses.dataclass(frozen=True)
class ProcConfig:
    """Static pipeline configuration: one field per enable-flag or scalar of
    the reference's parameter singleton (octalgorithmparameters.h:117-166),
    plus the build knobs of the folded-GEMM formulation."""

    # --- input conversion (cuda_code.cu:109-147) ---
    bitshift: bool = False

    # --- rolling-average DC background removal (cuda_code.cu:165-211) ---
    background_removal: bool = False
    rolling_average_window: int = 64

    # --- k-linearization (cuda_code.cu:213-326) ---
    resampling: bool = False
    interpolation: Interpolation = Interpolation.CUBIC

    # --- spectral windowing (cuda_code.cu:328-339) ---
    windowing: bool = False

    # --- numerical dispersion compensation (cuda_code.cu:586-634) ---
    dispersion: bool = False

    # --- fixed-pattern-noise removal (cuda_code.cu:523-584, 1517-1527) ---
    fpn_mode: FpnMode = FpnMode.OFF
    bscans_for_noise: int = 1

    # --- dynamic-range scaling (cuda_code.cu:699-741) ---
    log_scaling: bool = True
    grayscale_min: float = 0.0
    grayscale_max: float = 60.0
    multiplicator: float = 1.0
    addend: float = 0.0

    # --- geometric post-processing ---
    bscan_flip: bool = False          # cuda_code.cu:787-807
    sinusoidal_correction: bool = False  # cuda_code.cu:491-521

    # --- post-process background removal (cuda_code.cu:743-767) ---
    post_background_removal: bool = False
    post_background_weight: float = 1.0
    post_background_offset: float = 0.0

    # --- build knobs (no reference equivalent) ---
    # Resample by a dense operator product instead of per-sample gathers.
    resample_via_matmul: bool = True
    # Compute dtype of the spectral chain: "float32" or "bfloat16" (x and
    # the operators rounded to bf16, one product accumulated in float32; the
    # epilogues stay float32).
    compute_dtype: str = "float32"
    # Error budget of the folded GEMM, float32 compute:
    #   "default": one pass; on the CUDA kernel a float32-FMA GEMM
    #              (well inside the ~2^-8 relative budget of this rung)
    #   "high":    3 passes of bf16 operand splits, ~2^-16 relative
    #   "highest": 5 passes of bf16 operand splits, ~2^-24 relative
    # Ignored when compute_dtype="bfloat16".
    matmul_precision: str = "default"
    # Stages 1-3 as one fused kernel (decode + folded operator + phasor).
    use_pallas_prep: bool = False
    # Fold the inverse DFT and the mirror truncation into the operator as
    # well: the whole pre-FPN chain is one planar (n_in, half) GEMM per line.
    fft_via_matmul: bool = False
    # Backend of the folded GEMM: "pallas" (the hand-written kernel; the
    # name is kept from the JAX package so settings carry over) or "xla"
    # (plain framework matmuls, no custom kernel).
    fold_backend: str = "pallas"
    # One GEMM against the concatenated [W_re | W_im] operator.
    fold_concat: bool = False
    # Contraction split of the JAX kernel, which let the TPU overlap decode
    # and GEMM.  The CUDA kernel stages the decode in its own K loop, so the
    # value is accepted, validated and leaves the output unchanged.
    fold_k_split: int = 1
    # Exponent-extraction polynomial log2 in the scale epilogue instead of
    # log10 (the analog of the reference's --use_fast_math).  p == 0 maps to
    # a finite value where the exact epilogue gives -inf.
    fast_log: bool = False
    # Lines per tile cap of the JAX kernels.  Unused by the CUDA kernel,
    # whose tile is a compile-time choice; kept so settings carry over.
    pallas_tile: int = 0
    # Fuse FPN mean subtraction + dynamic-range scaling into the GEMM
    # epilogue (fold_backend="pallas", FPN off/once).
    fused_scale: bool = True
    # Storage dtype of the processed magnitude volume; arithmetic stays
    # float32.
    output_dtype: str = "float32"

    def __post_init__(self):
        if self.rolling_average_window < 1:
            raise ValueError("rolling_average_window must be >= 1")
        if self.bscans_for_noise < 1:
            raise ValueError("bscans_for_noise must be >= 1")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError("compute_dtype must be 'float32' or 'bfloat16'")
        if self.matmul_precision not in ("default", "high", "highest"):
            raise ValueError(
                "matmul_precision must be 'default', 'high' or 'highest'")
        if self.fold_backend not in ("pallas", "xla"):
            raise ValueError("fold_backend must be 'pallas' or 'xla'")
        if self.output_dtype not in ("float32", "bfloat16"):
            raise ValueError("output_dtype must be 'float32' or 'bfloat16'")
        if self.fold_k_split < 1:
            raise ValueError("fold_k_split must be >= 1")
        if self.fold_concat and (self.fast_log or self.fold_k_split > 1):
            raise ValueError(
                "fast_log / fold_k_split are not implemented for the "
                "concat fold kernel; disable fold_concat to use them")
        if (self.compute_dtype == "float32"
                and self.matmul_precision in ("high", "highest")
                and (self.fast_log or self.fold_k_split > 1)):
            raise ValueError(
                "fast_log / fold_k_split are not implemented for the "
                "manual matmul_precision='high'/'highest' split kernels; "
                "use matmul_precision='default'")
        if self.pallas_tile != 0 and self.pallas_tile < 8:
            raise ValueError(
                "pallas_tile must be 0 (auto) or >= 8 (the smallest kernel "
                "tile; a cap below every candidate would silently fall back "
                "to one whole-buffer tile)")


def default_full_config() -> ProcConfig:
    """The benchmark configuration of the reference: cubic k-linearization,
    dispersion, windowing, FPN once, log scaling
    (performance/v180/performance_v180.md:20-52), on the folded GEMM."""
    return ProcConfig(
        resampling=True,
        interpolation=Interpolation.CUBIC,
        windowing=True,
        dispersion=True,
        fpn_mode=FpnMode.ONCE,
        log_scaling=True,
        fft_via_matmul=True,
    )


@dataclasses.dataclass(frozen=True)
class Curves:
    """LUTs consumed by the pipeline.  Fields the configuration consumes
    (curves.consumed_fields) are tensors on the model's device; the others
    stay host numpy arrays or None."""

    resample_curve: Optional[object] = None     # float32[n]
    resample_matrix: Optional[object] = None    # float32[n, n] (row j = weights)
    prep_operator: Optional[object] = None      # float32[n_in, n_out] folded
    depth_op_re: Optional[object] = None        # float32[n_in, half] full fold
    depth_op_im: Optional[object] = None        # float32[n_in, half]
    window: Optional[object] = None             # float32[n]
    phase: Optional[object] = None              # complex64[n] = exp(+i*phi)
    sinusoidal_curve: Optional[object] = None   # float32[ascans_per_bscan]
    post_background: Optional[object] = None    # float32[n//2]
    # (re parts, im parts): depth_op_* split (or at compute_dtype="bfloat16"
    # rounded to bf16) once for the configuration's rung
    # (fused_prep.operator_rung), so the hot path launches without
    # re-splitting.  None: split per call.
    depth_parts: Optional[object] = None
    # prep_operator in the same form, made once (the FFT path's counterpart
    # of depth_parts).  None: made per call.
    prep_parts: Optional[object] = None
    # With fold_concat: the parts of [depth_op_re | depth_op_im] for the
    # configuration's rung, concatenated once.  None: concatenated per call.
    depth_concat_parts: Optional[object] = None


@dataclasses.dataclass(frozen=True)
class FpnState:
    """Carried fixed-pattern-noise state: the planar (re, im) mean line on
    the device and a host flag (the reference's
    ``fixedPatternNoiseDetermined``, cuda_code.cu:105, 1521-1524)."""

    mean_line: torch.Tensor  # float32[2, width] -- [0]=re, [1]=im
    determined: bool = False

    @staticmethod
    def initial(samples_per_line: int, *, device) -> "FpnState":
        return FpnState(
            mean_line=torch.zeros((2, samples_per_line), dtype=torch.float32,
                                  device=device),
            determined=False)

    @staticmethod
    def pack(mean_re: torch.Tensor, mean_im: torch.Tensor) -> torch.Tensor:
        return torch.stack([mean_re, mean_im])
