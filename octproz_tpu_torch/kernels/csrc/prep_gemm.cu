// Prep GEMM kernels for Hopper (sm_90a): stages 1-3 of the FFT path --
// decode, then y = x @ P with P the (n_in, n_out) operator that folds
// background removal, k-linearization and the window -- with a phasor
// epilogue (re = y*cos, im = y*sin, stored as complex64) or a plain float32
// store.
//
// One template, four instantiation families, each the counterpart of a
// Pallas kernel in octproz_tpu/pallas/fused_prep.py:
//
//   prep_gemm<EPI=PHASE, PASSES=1>    _kernel_phase        (:228-235)
//   prep_gemm<EPI=PHASE, PASSES=3|5>  _kernel_phase_split  (:245-251)
//   prep_gemm<EPI=REAL,  PASSES=1>    _kernel_real         (:238-242)
//   prep_gemm<EPI=REAL,  PASSES=3|5>  _kernel_real_split   (:254-258)
//
// with InT in {uint8, uint16, float} (raw samples; float is input the
// wrapper decoded already).
//
// What bounds it: at the FFT path's geometry (131072 lines x 1024 samples
// -> 1024) one buffer is 2*131072*1024*1024 = 275 GFLOP per pass against
// ~1.3 GB moved (0.27 GB of uint16 in, 1.07 GB of complex64 out), ~200 FLOP
// per byte: compute bound in float32 FMA.  The design follows fold_gemm.cu
// with one operator axis: each block owns a 64-line x BN-column output tile,
// stages one decoded (and, for the split rungs, split) x tile and every
// operator part in shared memory per K step, keeps one float32 accumulator
// per pass term in registers, and runs the epilogue there.  The phase
// epilogue writes (re, im) as one 8-byte store into the interleaved
// complex64 tensor that the FFT reads, so no separate pass packs the
// complex spectra.  The operator is dense; most of it is zero without
// background removal, and a banded or gather formulation is later work.
//
// Precision rungs: PASSES=1 is a float32-FMA GEMM.  PASSES=3/5 mirror
// _dot_split: the operator arrives as 2/3 bf16 parts (mask truncation, on
// the host), x is split here into x_hi and x_lo, each pass term has its own
// float32 accumulator, and the terms are summed low-order first before the
// phasor multiply -- the Pallas body's order.
//
// Launch contract: the kernel runs on the caller's stream, allocates
// nothing and does not synchronise; the C entry points return
// cudaGetLastError().  Ragged edges (lines, n_out and n_in not multiples of
// the tile) are masked inside the kernel.

#include <type_traits>

#include "gemm_common.cuh"

namespace {

enum Epi { PHASE = 0, REAL = 1 };

struct PrepArgs {
  const void* raw;
  const void* w[3];
  const float* cos_row;  // PHASE: (n_out,)
  const float* sin_row;  // PHASE: (n_out,)
  float* out;            // PHASE: interleaved (re, im) (lines, n_out); REAL: (lines, n_out)
  long long lines;
  int n_in;
  int n_out;
  int bitshift;
};

// TN: output columns per thread (BN = 16 * TN).  One operator axis keeps
// half the fold kernel's accumulators, so TN=8 at 1 and 3 passes; 5 passes
// (5 accumulators per output) take TN=4 to stay clear of spills.
template <typename InT, typename WT, int PASSES, int EPI, int TN>
__global__ void __launch_bounds__(THREADS)
    prep_gemm(const PrepArgs args) {
  constexpr int PARTS = (PASSES + 1) / 2;  // operator parts
  constexpr int XT = PASSES == 1 ? 1 : 2;  // x terms: x, or x_hi and x_lo
  constexpr int BN = 16 * TN;

  __shared__ float xs[XT][BK][BM + 1];  // +1: conflict-free transposed store
  __shared__ float ws[PARTS][BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int n_col_tiles = (args.n_out + BN - 1) / BN;
  const long long m0 = static_cast<long long>(blockIdx.x / n_col_tiles) * BM;
  const int n0 = static_cast<int>(blockIdx.x % n_col_tiles) * BN;
  const InT* raw = static_cast<const InT*>(args.raw);

  // acc[term][i][j]; term t < PARTS is x_hi * w_t, t >= PARTS is
  // x_lo * w_(t-PARTS) -- the order of _dot_split's term list.
  float acc[PASSES][TM][TN];
#pragma unroll
  for (int t = 0; t < PASSES; ++t)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[t][i][j] = 0.f;

  for (int k0 = 0; k0 < args.n_in; k0 += BK) {
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK;
      const int c = e % BK;
      const long long line = m0 + r;
      const int k = k0 + c;
      float v = 0.f;
      if (line < args.lines && k < args.n_in)
        v = decode<InT>(raw[line * args.n_in + k], args.bitshift);
      if constexpr (XT == 1) {
        xs[0][c][r] = v;
      } else {
        const float hi = x_hi(v);
        xs[0][c][r] = hi;
        xs[1][c][r] = x_lo(v, hi);
      }
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int r = e / BN;
      const int c = e % BN;
      const int k = k0 + r;
      const int n = n0 + c;
      const bool ok = k < args.n_in && n < args.n_out;
      const long long off = static_cast<long long>(k) * args.n_out + n;
#pragma unroll
      for (int p = 0; p < PARTS; ++p)
        ws[p][r][c] = ok ? load_w<WT>(args.w[p], off) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float xr[XT][TM];
#pragma unroll
      for (int s = 0; s < XT; ++s)
#pragma unroll
        for (int i = 0; i < TM; ++i) xr[s][i] = xs[s][kk][ty + TY * i];
#pragma unroll
      for (int p = 0; p < PARTS; ++p) {
        float wr[TN];
#pragma unroll
        for (int j = 0; j < TN; ++j) wr[j] = ws[p][kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            acc[p][i][j] = fmaf(xr[0][i], wr[j], acc[p][i][j]);
            if constexpr (XT == 2) {
              if (p < PARTS - 1)
                acc[PARTS + p][i][j] =
                    fmaf(xr[XT - 1][i], wr[j], acc[PARTS + p][i][j]);
            }
          }
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
      const int col = n0 + tx + 16 * j;
      if (col >= args.n_out) continue;
      float y = acc[PASSES - 1][i][j];  // low-order terms first
#pragma unroll
      for (int t = PASSES - 2; t >= 0; --t) y = y + acc[t][i][j];
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

template <typename InT, int PASSES, int EPI>
int launch(const PrepArgs& args, cudaStream_t stream) {
  using WT = typename std::conditional<PASSES == 1, float, __nv_bfloat16>::type;
  constexpr int TN = PASSES == 5 ? 4 : 8;
  constexpr int BN = 16 * TN;
  if (args.lines <= 0 || args.n_out <= 0 || args.n_in <= 0) return 0;
  const long long blocks =
      ((args.lines + BM - 1) / BM) * ((args.n_out + BN - 1) / BN);
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  prep_gemm<InT, WT, PASSES, EPI, TN>
      <<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

template <int EPI, typename InT>
int by_passes(int passes, const PrepArgs& args, cudaStream_t stream) {
  switch (passes) {
    case 1: return launch<InT, 1, EPI>(args, stream);
    case 3: return launch<InT, 3, EPI>(args, stream);
    case 5: return launch<InT, 5, EPI>(args, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int EPI>
int dispatch(int in_kind, int passes, const PrepArgs& args, cudaStream_t stream) {
  switch (in_kind) {
    case 0: return by_passes<EPI, uint8_t>(passes, args, stream);
    case 1: return by_passes<EPI, uint16_t>(passes, args, stream);
    case 2: return by_passes<EPI, float>(passes, args, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

PrepArgs make_args(const void* raw, int bitshift, const void* w0,
                   const void* w1, const void* w2, void* out, long long lines,
                   int n_in, int n_out) {
  PrepArgs args = {};
  args.raw = raw;
  args.w[0] = w0; args.w[1] = w1; args.w[2] = w2;
  args.out = static_cast<float*>(out);
  args.lines = lines;
  args.n_in = n_in;
  args.n_out = n_out;
  args.bitshift = bitshift;
  return args;
}

}  // namespace

extern "C" {

// in_kind: 0 uint8, 1 uint16, 2 float32.  passes: 1, 3 or 5 (with 1, 2 or
// 3 operator parts; unused part pointers may be NULL).  out: complex64
// (lines, n_out), written as interleaved float pairs.
int prep_gemm_phase(const void* raw, int in_kind, int bitshift, int passes,
                    const void* w0, const void* w1, const void* w2,
                    const float* cos_row, const float* sin_row, void* out,
                    long long lines, int n_in, int n_out, void* stream) {
  PrepArgs args = make_args(raw, bitshift, w0, w1, w2, out, lines, n_in, n_out);
  args.cos_row = cos_row;
  args.sin_row = sin_row;
  return dispatch<PHASE>(in_kind, passes, args, static_cast<cudaStream_t>(stream));
}

// As prep_gemm_phase without the phasor; out: float32 (lines, n_out).
int prep_gemm_real(const void* raw, int in_kind, int bitshift, int passes,
                   const void* w0, const void* w1, const void* w2, void* out,
                   long long lines, int n_in, int n_out, void* stream) {
  PrepArgs args = make_args(raw, bitshift, w0, w1, w2, out, lines, n_in, n_out);
  return dispatch<REAL>(in_kind, passes, args, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
