"""octproz_tpu_torch -- the FD-OCT framework on PyTorch and CUDA.

The port of ``octproz_tpu`` (JAX, TPU) to one NVIDIA Hopper GPU.  Plain
tensor code is PyTorch (the FFT is ``torch.fft``); the GEMM kernels of both
pipeline branches -- the folded GEMM and the FFT path's prep GEMM -- are
hand-written CUDA C++ for ``sm_90a`` (kernels/csrc), each with a plain
PyTorch version beside it that runs on the CPU and that the kernel is held
to.  The JAX package stays the reference and is never imported here.
"""

from .params import (  # noqa: F401
    AcqParams,
    Curves,
    DisplayFunction,
    FpnMode,
    FpnState,
    Interpolation,
    ProcConfig,
    WindowType,
    default_full_config,
)
from . import curves, ops, pipeline  # noqa: F401
from .pipeline import initial_fpn_state, make_scan_step, make_step, process_buffer  # noqa: F401

__version__ = "0.1.0"
