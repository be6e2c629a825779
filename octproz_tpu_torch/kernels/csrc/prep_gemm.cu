// Prep GEMM kernels for Hopper (sm_90a): stages 1-3 of the FFT path --
// y = x @ P with P the (n_in, n_out) operator that folds background
// removal, k-linearization and the window -- with a phasor epilogue (re =
// y*cos, im = y*sin, stored as complex64) or a plain float32 store.
//
// The C entry points prep_gemm_phase and prep_gemm_real take every rung and
// every input type.  Every rung on uint8/uint16 lines runs on the bf16
// tensor cores (prep_split.cu): the split rungs (3 and 5 passes) against the
// operator's 2/3 bf16 parts, and the one-pass rung of both families against
// the three bf16 parts of its float32 operator.  This file keeps the one
// pass on float32 lines -- input the wrapper decoded already, samples above
// 16 bits, which the x_hi + x_lo split cannot carry -- on the CUDA cores, in
// float32 FMA.  The input type alone picks the route:
//
//   prep_split<EPI=PHASE, 3 parts> | prep_gemm<EPI=PHASE>  _kernel_phase  (octproz_tpu/pallas/fused_prep.py:228-235)
//   prep_split<EPI=REAL, 3 parts>  | prep_gemm<EPI=REAL>   _kernel_real   (:238-242)
//   prep_split<EPI=PHASE> (3|5)    _kernel_phase_split  (:245-251)
//   prep_split<EPI=REAL>  (3|5)    _kernel_real_split   (:254-258)
//
// What bounds it: at the FFT path's geometry (131072 lines x 1024 samples
// -> 1024) one buffer is 2*131072*1024*1024 = 275 GFLOP against 1.1-1.6 GB
// moved (0.54 GB of float32 lines in, 0.54 GB of float32 or 1.07 GB of
// complex64 out), 170-250 FLOP per byte: compute bound, 4.1 ms at one H100's float32
// peak of 67 TFLOP/s (H100 80GB HBM3, 700 W), where the tensor-core route
// on integer lines is bound to 0.83 ms (three bf16 terms at 989 TFLOP/s).
// Each block owns a 64-line x 128-column output tile, stages one x tile and
// the operator tile in shared memory per K step, keeps the float32
// accumulators in registers, and runs the epilogue there.  The phase
// epilogue writes (re, im) as one 8-byte store into the interleaved
// complex64 tensor that the FFT reads.
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
  const float* raw;      // float32 lines (lines, n_in)
  const float* w;
  const float* cos_row;  // PHASE: (n_out,)
  const float* sin_row;  // PHASE: (n_out,)
  float* out;            // PHASE: interleaved (re, im) (lines, n_out); REAL: (lines, n_out)
  long long lines;
  int n_in;
  int n_out;
};

constexpr int TN = 8;        // output columns per thread
constexpr int BN = 16 * TN;  // output columns per block

template <int EPI>
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
      xs[c][r] = line < args.lines && k < args.n_in ? args.raw[line * args.n_in + k] : 0.f;
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

// The one-pass launch on float32 lines, with the float32 operator in w0.
template <int EPI>
int launch(const void* raw, const void* w0, const float* cos_row, const float* sin_row,
           void* out, long long lines, int n_in, int n_out, void* stream) {
  if (lines <= 0 || n_out <= 0 || n_in <= 0) return 0;
  const long long blocks = ((lines + BM - 1) / BM) * ((n_out + BN - 1) / BN);
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  PrepArgs args = {};
  args.raw = static_cast<const float*>(raw);
  args.w = static_cast<const float*>(w0);
  args.cos_row = cos_row;
  args.sin_row = sin_row;
  args.out = static_cast<float*>(out);
  args.lines = lines;
  args.n_in = n_in;
  args.n_out = n_out;
  prep_gemm<EPI><<<static_cast<unsigned>(blocks), THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// in_kind: 0 uint8, 1 uint16, 2 float32.  passes: 3 or 5 with 2 or 3 bf16
// operator parts; 1 with the float32 operator in w0 for float32 lines, and
// with its three bf16 parts for uint8/uint16 lines; BF16_PASS
// (compute_dtype="bfloat16") with its one rounded bf16 part for any lines.
// Unused part pointers may be NULL.  out: complex64 (lines, n_out), written as interleaved float
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
  return launch<PHASE>(raw, w0, cos_row, sin_row, out, lines, n_in, n_out, stream);
}

// As prep_gemm_phase without the phasor; out: float32 (lines, n_out).
int prep_gemm_real(const void* raw, int in_kind, int bitshift, int passes,
                   const void* w0, const void* w1, const void* w2, void* out,
                   long long lines, int n_in, int n_out, void* stream) {
  if (passes != 1 || in_kind != IN_FLOAT) {
    const void* const w[3] = {w0, w1, w2};
    return prep_split_real(raw, in_kind, bitshift, passes, w, out, lines, n_in, n_out, stream);
  }
  return launch<REAL>(raw, w0, nullptr, nullptr, out, lines, n_in, n_out, stream);
}

}  // extern "C"
