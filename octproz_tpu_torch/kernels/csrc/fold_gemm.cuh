// The folded-GEMM SIMT kernel for Hopper (sm_90a): x @ W_re,
// x @ W_im as one float32-FMA product each, with a planar store, on the
// CUDA cores.  It serves one family alone: the planar kernel's one-pass
// rung on float32 lines (B1; input the wrapper decoded already, samples
// above 16 bits), and fold_gemm.cu alone includes it.  Every rung of every
// fold family on uint8/uint16 lines, and the scaled kernels' one pass on
// float32 lines too, runs on the bf16 tensor cores (fold_split.cuh; float32
// lines as three x parts).
//
// What bounds it: at the main path's geometry (131072 lines x 1024 samples
// -> 512 depth bins) one buffer is 4*131072*1024*512 = 275 GFLOP against
// ~0.8 GB of float32 lines and output, ~340 FLOP per byte: compute bound,
// 4.1 ms at one H100's float32 peak of 67 TFLOP/s (H100 80GB HBM3, 700 W).
// Each block owns a 64-line x 64-bin output tile and computes BOTH re and
// im from one x tile staged in shared memory, loops over n_in in BK steps,
// and stores from the accumulators in registers.  It reads one (n_in,
// half) row-major float32 operator per axis.
//
// Launch contract: the kernel runs on the caller's stream, allocates
// nothing and does not synchronise; launch() returns cudaGetLastError().
// Ragged edges (lines, half and n_in not multiples of the tile) are masked
// inside the kernel.

#pragma once

#include "gemm_common.cuh"

namespace {

// The SIMT tile geometry.
constexpr int BM = 64;       // lines per block tile
constexpr int BK = 16;       // contraction (n_in) per K step
constexpr int TM = 4;        // lines per thread
constexpr int THREADS = 256; // 16 x 16 threads
constexpr int TY = THREADS / 16;

struct Args {
  const float* raw;  // float32 lines (lines, n_in)
  const float* wre;  // (n_in, half) float32 operators
  const float* wim;
  float* re_out;     // (lines, half) float32 planes
  float* im_out;
  long long lines;
  int n_in;
  int half;
};

constexpr int TN = 4;        // depth bins per thread
constexpr int BN = 16 * TN;  // depth bins per block

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
      const long long off = static_cast<long long>(k) * args.half + n;
      ws[0][r][c] = ok ? args.wre[off] : 0.f;
      ws[1][r][c] = ok ? args.wim[off] : 0.f;
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
      args.re_out[o] = acc[0][i][j];
      args.im_out[o] = acc[1][i][j];
    }
  }
}

inline int launch(const Args& args, cudaStream_t stream) {
  if (args.lines <= 0 || args.half <= 0 || args.n_in <= 0) return 0;
  const long long blocks =
      ((args.lines + BM - 1) / BM) * ((args.half + BN - 1) / BN);
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  fold_gemm<<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
