// Pieces shared by the GEMM kernels of this directory (fold_gemm.cuh,
// prep_gemm.cu, fold_split.cuh): the epilogues, the SIMT tile geometry, the
// in-kernel decode, operator loads and the bf16 split of x for the
// multi-pass precision rungs.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// PLANAR: (re, im) float32 planes; SCALE: FPN subtraction and the
// dynamic-range scale; PHASE: (y cos, y sin) as complex64; REAL: float32 y.
enum Epi { PLANAR = 0, SCALE = 1, PHASE = 2, REAL = 3 };

constexpr int BM = 64;       // lines per block tile
constexpr int BK = 16;       // contraction (n_in) per K step
constexpr int TM = 4;        // lines per thread
constexpr int THREADS = 256; // 16 x 16 threads
constexpr int TY = THREADS / 16;

// _decode_block: uint -> int32 -> (>> 4) -> float.
template <typename InT>
__device__ __forceinline__ float decode(InT v, int bitshift) {
  int i = static_cast<int>(v);
  if (bitshift) i >>= 4;
  return static_cast<float>(i);
}
template <>
__device__ __forceinline__ float decode<float>(float v, int) {
  return v;
}

template <typename WT>
__device__ __forceinline__ float load_w(const void* p, long long off);
template <>
__device__ __forceinline__ float load_w<float>(const void* p, long long off) {
  return static_cast<const float*>(p)[off];
}
template <>
__device__ __forceinline__ float load_w<__nv_bfloat16>(const void* p,
                                                       long long off) {
  return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[off]);
}

// _dot_split's x split: x_hi = mask truncation to bf16, x_lo = bf16_rn of
// the remainder.
__device__ __forceinline__ float x_hi(float v) {
  return __int_as_float(__float_as_int(v) & 0xFFFF0000);
}
__device__ __forceinline__ float x_lo(float v, float hi) {
  return __bfloat162float(__float2bfloat16_rn(v - hi));
}

}  // namespace
