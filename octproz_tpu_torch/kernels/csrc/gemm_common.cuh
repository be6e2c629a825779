// Pieces shared by the GEMM kernels of this directory (fold_split.cuh,
// fold_bf16.cuh): the epilogues and the scale's modes,
// store and fast log, the input kinds and the bf16 truncation of x.

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

// The scale epilogue's modes: 0 log (a*log10(p)+b), 1 lin (a*sqrt(p)+b), 2
// fast log (a*fast_log2(p)+b, a already multiplied by log10(2)).
enum Mode { MODE_LOG = 0, MODE_LIN = 1, MODE_FAST_LOG = 2 };

template <typename OutT>
__device__ __forceinline__ OutT store_cast(float v);
template <>
__device__ __forceinline__ float store_cast<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 store_cast<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// _fast_log2: exponent extraction plus the degree-5 polynomial _LOG2_POLY.
__device__ __forceinline__ float fast_log2(float p) {
  const int i = __float_as_int(p);
  const int e = static_cast<int>(static_cast<unsigned>(i) >> 23) - 127;
  const float m = __int_as_float((i & 0x007FFFFF) | 0x3F800000);
  float r = 4.342836333e-02f;
  r = r * m + -4.048623094e-01f;
  r = r * m + 1.593884548f;
  r = r * m + -3.492466043f;
  r = r * m + 5.046852936f;
  r = r * m + -2.786805564f;
  return static_cast<float>(e) + r;
}

// _dot_split's x split: x_hi = mask truncation to bf16 (x_lo = bf16_rn of
// the remainder, fold_split.cuh).
__device__ __forceinline__ float x_hi(float v) {
  return __int_as_float(__float_as_int(v) & 0xFFFF0000);
}

}  // namespace
