// Prep GEMM kernels for Hopper (sm_90a): stages 1-3 of the FFT path --
// decode, then y = x @ P with P the (n_in, n_out) operator that folds
// background removal, k-linearization and the window -- with a phasor
// epilogue (re = y*cos, im = y*sin, stored as complex64) or a plain float32
// store.
//
// The C entry points prep_gemm_phase and prep_gemm_real take every rung.
// This file runs the one-pass rung on the CUDA cores where the bf16
// tensor-core kernel of prep_split.cu does not take it; the split rungs (3
// and 5 passes), and the phase kernel's one pass on uint8/uint16 lines
// (against three bf16 parts of its float32 operator), go there:
//
//   prep_split<EPI=PHASE, 3 parts> | prep_gemm<EPI=PHASE>  _kernel_phase  (octproz_tpu/pallas/fused_prep.py:228-235)
//   prep_split<EPI=PHASE> (3|5)    _kernel_phase_split  (:245-251)
//   prep_gemm<EPI=REAL>            _kernel_real         (:238-242)
//   prep_split<EPI=REAL>  (3|5)    _kernel_real_split   (:254-258)
//
// with InT in {uint8, uint16, float} (raw samples; float is input the
// wrapper decoded already, samples above 16 bits, which the x_hi + x_lo
// split cannot carry: the phase kernel's one pass keeps this file's kernel
// for them, and the input type alone picks the route).
//
// What bounds it: at the FFT path's geometry (131072 lines x 1024 samples
// -> 1024) one buffer is 2*131072*1024*1024 = 275 GFLOP against ~1.3 GB
// moved (0.27 GB of uint16 in, 1.07 GB of complex64 out), ~200 FLOP per
// byte: compute bound in float32 FMA.  The design follows fold_gemm.cuh
// with one operator axis: each block owns a 64-line x 128-column output
// tile, stages one decoded x tile and the operator tile in shared memory
// per K step, keeps the float32 accumulators in registers, and runs the
// epilogue there.  The phase epilogue writes (re, im) as one 8-byte store
// into the interleaved complex64 tensor that the FFT reads, so no separate
// pass packs the complex spectra.  The operator is dense; most of it is
// zero without background removal, and a banded or gather formulation is
// later work.
//
// Launch contract: the kernel runs on the caller's stream, allocates
// nothing and does not synchronise; the C entry points return
// cudaGetLastError().  Ragged edges (lines, n_out and n_in not multiples of
// the tile) are masked inside the kernel.

#include "gemm_common.cuh"

extern "C" {
int prep_split_phase(const void* raw, int in_kind, int bitshift, int passes,
                     const void* const w[3], const float* cos_row, const float* sin_row,
                     void* out, long long lines, int n_in, int n_out, void* stream);
int prep_split_real(const void* raw, int in_kind, int bitshift, int passes,
                    const void* const w[3], void* out, long long lines, int n_in, int n_out,
                    void* stream);
}

namespace {

struct PrepArgs {
  const void* raw;
  const float* w;
  const float* cos_row;  // PHASE: (n_out,)
  const float* sin_row;  // PHASE: (n_out,)
  float* out;            // PHASE: interleaved (re, im) (lines, n_out); REAL: (lines, n_out)
  long long lines;
  int n_in;
  int n_out;
  int bitshift;
};

constexpr int TN = 8;        // output columns per thread
constexpr int BN = 16 * TN;  // output columns per block

template <typename InT, int EPI>
__global__ void __launch_bounds__(THREADS)
    prep_gemm(const PrepArgs args) {
  __shared__ float xs[BK][BM + 1];  // +1: conflict-free transposed store
  __shared__ float ws[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int n_col_tiles = (args.n_out + BN - 1) / BN;
  const long long m0 = static_cast<long long>(blockIdx.x / n_col_tiles) * BM;
  const int n0 = static_cast<int>(blockIdx.x % n_col_tiles) * BN;
  const InT* raw = static_cast<const InT*>(args.raw);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < args.n_in; k0 += BK) {
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK;
      const int c = e % BK;
      const long long line = m0 + r;
      const int k = k0 + c;
      float v = 0.f;
      if (line < args.lines && k < args.n_in)
        v = decode<InT>(raw[line * args.n_in + k], args.bitshift);
      xs[c][r] = v;
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int r = e / BN;
      const int c = e % BN;
      const int k = k0 + r;
      const int n = n0 + c;
      const bool ok = k < args.n_in && n < args.n_out;
      ws[r][c] = ok ? args.w[static_cast<long long>(k) * args.n_out + n] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float xr[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) xr[i] = xs[kk][ty + TY * i];
      float wr[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) wr[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(xr[i], wr[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long line = m0 + ty + TY * i;
    if (line >= args.lines) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col >= args.n_out) continue;
      const float y = acc[i][j];
      const long long o = line * args.n_out + col;
      if constexpr (EPI == PHASE) {
        reinterpret_cast<float2*>(args.out)[o] =
            make_float2(y * args.cos_row[col], y * args.sin_row[col]);
      } else {
        args.out[o] = y;
      }
    }
  }
}

template <typename InT, int EPI>
int launch(const PrepArgs& args, cudaStream_t stream) {
  if (args.lines <= 0 || args.n_out <= 0 || args.n_in <= 0) return 0;
  const long long blocks =
      ((args.lines + BM - 1) / BM) * ((args.n_out + BN - 1) / BN);
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  prep_gemm<InT, EPI><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

int one_pass_real(int in_kind, const PrepArgs& args, cudaStream_t stream) {
  switch (in_kind) {
    case IN_U8: return launch<uint8_t, REAL>(args, stream);
    case IN_U16: return launch<uint16_t, REAL>(args, stream);
    case IN_FLOAT: return launch<float, REAL>(args, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

PrepArgs make_args(const void* raw, int bitshift, const void* w0, void* out, long long lines,
                   int n_in, int n_out) {
  PrepArgs args = {};
  args.raw = raw;
  args.w = static_cast<const float*>(w0);
  args.out = static_cast<float*>(out);
  args.lines = lines;
  args.n_in = n_in;
  args.n_out = n_out;
  args.bitshift = bitshift;
  return args;
}

}  // namespace

extern "C" {

// in_kind: 0 uint8, 1 uint16, 2 float32.  passes: 3 or 5 with 2 or 3 bf16
// operator parts; 1 with the float32 operator in w0 for float32 lines, and
// with its three bf16 parts for uint8/uint16 lines.  Unused part pointers
// may be NULL.  out: complex64 (lines, n_out), written as interleaved float
// pairs.
int prep_gemm_phase(const void* raw, int in_kind, int bitshift, int passes,
                    const void* w0, const void* w1, const void* w2,
                    const float* cos_row, const float* sin_row, void* out,
                    long long lines, int n_in, int n_out, void* stream) {
  if (passes != 1 || in_kind != IN_FLOAT) {
    const void* const w[3] = {w0, w1, w2};
    return prep_split_phase(raw, in_kind, bitshift, passes, w, cos_row, sin_row, out, lines,
                            n_in, n_out, stream);
  }
  PrepArgs args = make_args(raw, bitshift, w0, out, lines, n_in, n_out);
  args.cos_row = cos_row;
  args.sin_row = sin_row;
  return launch<float, PHASE>(args, static_cast<cudaStream_t>(stream));
}

// As prep_gemm_phase without the phasor; out: float32 (lines, n_out).  Its
// one pass takes the float32 operator in w0 for every input type.
int prep_gemm_real(const void* raw, int in_kind, int bitshift, int passes,
                   const void* w0, const void* w1, const void* w2, void* out,
                   long long lines, int n_in, int n_out, void* stream) {
  if (passes != 1) {
    const void* const w[3] = {w0, w1, w2};
    return prep_split_real(raw, in_kind, bitshift, passes, w, out, lines, n_in, n_out, stream);
  }
  PrepArgs args = make_args(raw, bitshift, w0, out, lines, n_in, n_out);
  return one_pass_real(in_kind, args, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
