// Pieces shared by the GEMM kernels of this directory (fold_gemm.cuh,
// prep_gemm.cu, fold_split.cuh): the epilogues, the input kinds, the SIMT
// tile geometry of the float32-lines kernels and the bf16 truncation of x.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// PLANAR: (re, im) float32 planes; SCALE: FPN subtraction and the
// dynamic-range scale; PHASE: (y cos, y sin) as complex64; REAL: float32 y.
enum Epi { PLANAR = 0, SCALE = 1, PHASE = 2, REAL = 3 };

// The raw lines' in_kind of every C entry point: float32 lines are input
// the wrapper decoded already (samples above 16 bits).
enum InKind { IN_U8 = 0, IN_U16 = 1, IN_FLOAT = 2 };

// The passes argument of every C entry point for compute_dtype="bfloat16":
// x rounded to nearest bf16 against one bf16 operator part, one product
// term (the tensor-core kernels of fold_split.cuh, on every input type).
constexpr int BF16_PASS = 0;

constexpr int BM = 64;       // lines per block tile
constexpr int BK = 16;       // contraction (n_in) per K step
constexpr int TM = 4;        // lines per thread
constexpr int THREADS = 256; // 16 x 16 threads
constexpr int TY = THREADS / 16;

// _dot_split's x split: x_hi = mask truncation to bf16 (x_lo = bf16_rn of
// the remainder, fold_split.cuh).
__device__ __forceinline__ float x_hi(float v) {
  return __int_as_float(__float_as_int(v) & 0xFFFF0000);
}

}  // namespace
