// The folded-GEMM SIMT kernel template for Hopper (sm_90a): x @ W_re,
// x @ W_im as one float32-FMA product each, with a planar store or a fused
// FPN-subtract + dynamic-range-scale epilogue, on the CUDA cores.  It
// serves the one-pass rung on float32 lines (input the wrapper decoded
// already, samples above 16 bits) of two families alone: the planar kernel
// with one operator per axis (B1, through fold_gemm.cu) and the scaled
// kernel of the concatenated [W_re | W_im] operator (B5, through
// fold_concat.cu).  Every rung of every fold family on uint8/uint16 lines,
// and the scaled two-operator kernel (B2) on float32 lines too, runs on the
// bf16 tensor cores (fold_split.cuh; float32 lines as three x parts).
//
// What bounds it: at the main path's geometry (131072 lines x 1024 samples
// -> 512 depth bins) one buffer is 4*131072*1024*512 = 275 GFLOP against
// ~0.8 GB of float32 lines and output, ~340 FLOP per byte: compute bound,
// 4.1 ms at one H100's float32 peak of 67 TFLOP/s (H100 80GB HBM3, 700 W).
// Each block owns a 64-line x 64-bin output tile and computes BOTH re and
// im from one x tile staged in shared memory, loops over n_in in BK steps,
// and runs the epilogue on the accumulators in registers.
//
// Operator layouts.  CONCAT=false reads one (n_in, half) row-major float32
// operator per axis.  CONCAT=true reads one (n_in, 2*half) row-major
// operator [W_re | W_im] (row stride 2*half, the im column of bin j at
// half + j): a block stages columns j and j + half of the same rows into
// its re and im tiles, so bin j's re and im still meet in registers for the
// epilogue.
//
// Launch contract: the kernel runs on the caller's stream, allocates
// nothing and does not synchronise; launch() returns cudaGetLastError().
// Ragged edges (lines, half and n_in not multiples of the tile) are masked
// inside the kernel.  Built without --use_fast_math: log10f(0) is -inf on
// the exact path, as in the JAX package.

#pragma once

#include "gemm_common.cuh"

namespace {

enum Mode { MODE_LOG = 0, MODE_LIN = 1, MODE_FAST_LOG = 2 };

struct Args {
  const float* raw;    // float32 lines (lines, n_in)
  const float* wre;    // CONCAT: the wide [W_re | W_im] operator
  const float* wim;    // unused with CONCAT
  const float* mean2;  // (2, half): FPN mean line, re then im
  float* re_out;       // PLANAR
  float* im_out;       // PLANAR
  void* out;           // SCALE
  long long lines;
  int n_in;
  int half;
  int mode;
  float a;
  float b;
};

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

constexpr int TN = 4;        // depth bins per thread
constexpr int BN = 16 * TN;  // depth bins per block

template <int EPI, typename OutT, bool CONCAT>
__global__ void __launch_bounds__(THREADS)
    fold_gemm(const Args args) {
  __shared__ float xs[BK][BM + 1];  // +1: conflict-free transposed store
  __shared__ float ws[2][BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int n_bin_tiles = (args.half + BN - 1) / BN;
  const long long m0 = static_cast<long long>(blockIdx.x / n_bin_tiles) * BM;
  const int n0 = static_cast<int>(blockIdx.x % n_bin_tiles) * BN;

  float acc[2][TM][TN];  // [axis][line][bin]
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[c][i][j] = 0.f;

  for (int k0 = 0; k0 < args.n_in; k0 += BK) {
    // Stage the x tile.
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK;
      const int c = e % BK;
      const long long line = m0 + r;
      const int k = k0 + c;
      xs[c][r] = line < args.lines && k < args.n_in ? args.raw[line * args.n_in + k] : 0.f;
    }
    // Stage the operator tiles of both axes.
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int r = e / BN;
      const int c = e % BN;
      const int k = k0 + r;
      const int n = n0 + c;
      const bool ok = k < args.n_in && n < args.half;
      if constexpr (CONCAT) {
        // bin n's re at column n, its im at column half + n of one row
        const long long off = static_cast<long long>(k) * (2LL * args.half) + n;
        ws[0][r][c] = ok ? args.wre[off] : 0.f;
        ws[1][r][c] = ok ? args.wre[off + args.half] : 0.f;
      } else {
        const long long off = static_cast<long long>(k) * args.half + n;
        ws[0][r][c] = ok ? args.wre[off] : 0.f;
        ws[1][r][c] = ok ? args.wim[off] : 0.f;
      }
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float xr[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) xr[i] = xs[kk][ty + TY * i];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float wr[TN];
#pragma unroll
        for (int j = 0; j < TN; ++j) wr[j] = ws[c][kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[c][i][j] = fmaf(xr[i], wr[j], acc[c][i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long line = m0 + ty + TY * i;
    if (line >= args.lines) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int bin = n0 + tx + 16 * j;
      if (bin >= args.half) continue;
      const long long o = line * args.half + bin;
      if constexpr (EPI == PLANAR) {
        args.re_out[o] = acc[0][i][j];
        args.im_out[o] = acc[1][i][j];
      } else {
        const float re = acc[0][i][j] - args.mean2[bin];
        const float im = acc[1][i][j] - args.mean2[args.half + bin];
        const float p = re * re + im * im;
        float v;
        if (args.mode == MODE_LOG)
          v = args.a * log10f(p) + args.b;
        else if (args.mode == MODE_LIN)
          v = args.a * sqrtf(p) + args.b;
        else
          v = args.a * fast_log2(p) + args.b;
        static_cast<OutT*>(args.out)[o] = store_cast<OutT>(v);
      }
    }
  }
}

template <int EPI, typename OutT, bool CONCAT>
int launch(const Args& args, cudaStream_t stream) {
  if (args.lines <= 0 || args.half <= 0 || args.n_in <= 0) return 0;
  const long long blocks =
      ((args.lines + BM - 1) / BM) * ((args.half + BN - 1) / BN);
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  fold_gemm<EPI, OutT, CONCAT>
      <<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
