"""Build and load the CUDA kernels of ``csrc/``.

The sources are compiled at first use with ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface, which is
loaded with :mod:`ctypes`.  No PyTorch header is included, so a build takes
seconds rather than minutes; each source compiles in its own ``nvcc``
process, all started together, and one more links them.  The library lands
in ``_build/<hash>/`` next to this file, keyed by a hash of the sources,
headers and flags, so an edited source is rebuilt and an unchanged one is
reused.

Nothing here runs at import time: the CPU tests import every module of the
package on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("fold_gemm.cu", "fold_split.cu", "fold_bf16.cu", "fold_concat.cu", "prep_gemm.cu",
           "prep_split.cu", "prep_bf16.cu")
HEADERS = ("gemm_common.cuh", "fold_gemm.cuh", "fold_split.cuh", "fold_bf16.cuh")
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("the CUDA toolkit (nvcc) was not found: set "
                           "CUDA_HOME or put nvcc on PATH")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libkernels.so"


def build() -> Path:
    """Compile the sources unless the library for their hash exists.  The
    compiler's output, with ptxas's register and spill report, is kept in
    ``build.log`` beside the library."""
    lib = library_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    objs = [lib.parent / f"{Path(s).stem}.{tag}.o" for s in SOURCES]
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(SOURCES, objs)]
    outputs = [p.communicate()[0] for p in procs]  # waits for every process
    log = "".join(f"== nvcc {src}\n{out}" for src, out in zip(SOURCES, outputs))
    failed = [src for src, p in zip(SOURCES, procs) if p.returncode != 0]
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
    tmp = lib.with_suffix(f".{tag}.tmp")
    link = subprocess.run([_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    log += f"== link\n{link.stdout}{link.stderr}"
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{log}")
    for obj in objs:
        obj.unlink()
    (lib.parent / "build.log").write_text(log)
    os.replace(tmp, lib)  # atomic: a concurrent process never loads a partial file
    return lib


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with its C signatures."""
    lib = ctypes.CDLL(str(build()))
    vp, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.fold_gemm_planar.argtypes = [vp, i32, i32, i32, vp, vp, vp, vp, vp, vp,
                                     vp, vp, i64, i32, i32, vp]
    lib.fold_gemm_planar.restype = i32
    lib.fold_gemm_scale.argtypes = [vp, i32, i32, i32, vp, vp, vp, vp, vp, vp,
                                    vp, vp, i32, i32, f32, f32, i64, i32, i32, vp]
    lib.fold_gemm_scale.restype = i32
    lib.fold_gemm_scale_concat.argtypes = [vp, i32, i32, i32, vp, vp, vp, vp, vp, i32,
                                           i32, f32, f32, i64, i32, i32, vp]
    lib.fold_gemm_scale_concat.restype = i32
    lib.prep_gemm_phase.argtypes = [vp, i32, i32, i32, vp, vp, vp, vp, vp, vp,
                                    i64, i32, i32, vp]
    lib.prep_gemm_phase.restype = i32
    lib.prep_gemm_real.argtypes = [vp, i32, i32, i32, vp, vp, vp, vp, i64, i32,
                                   i32, vp]
    lib.prep_gemm_real.restype = i32
    lib.fold_gemm_error_string.argtypes = [i32]
    lib.fold_gemm_error_string.restype = ctypes.c_char_p
    return lib
