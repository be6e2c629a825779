// Folded-GEMM kernels for Hopper (sm_90a): decode -> x @ W_re, x @ W_im
// with a planar store or a fused FPN-subtract + dynamic-range-scale
// epilogue.
//
// One template, four instantiation families, each the counterpart of a
// Pallas kernel in octproz_tpu/pallas/fused_prep.py:
//
//   fold_gemm<EPI=PLANAR, PASSES=1>    _kernel_depth              (:261-268)
//   fold_gemm<EPI=PLANAR, PASSES=3|5>  _kernel_depth_split        (:271-280)
//   fold_gemm<EPI=SCALE,  PASSES=1>    _kernel_depth_scale        (:375-419)
//   fold_gemm<EPI=SCALE,  PASSES=3|5>  _kernel_depth_scale_split  (:422-438)
//
// with InT in {uint8, uint16, float} (raw samples; float is input the
// wrapper decoded already) and OutT in {float, bf16} for SCALE.
//
// What bounds it: at the main path's geometry (131072 lines x 1024 samples
// -> 512 depth bins) one buffer is 4*131072*1024*512 = 275 GFLOP per pass
// against ~0.54 GB of raw input and output, ~500 FLOP per byte: compute
// bound.  The design keeps everything but the raw integers and the final
// image out of device memory: each block owns a 64-line x BN-bin output
// tile and computes BOTH re and im from one decoded x tile staged in shared
// memory (one decode per K step for both GEMMs), loops over n_in in BK
// steps, and runs the epilogue on the accumulators in registers.
//
// Precision rungs.  PASSES=1 is a float32-FMA GEMM.  PASSES=3/5 mirror
// _dot_split: the operator arrives split into 2/3 bf16 parts (the wrapper
// splits it by mask truncation), x is split here into x_hi (mask) and
// x_lo = bf16_rn(x - x_hi), each pass term has its own float32 accumulator,
// and the terms are summed low-order first in the epilogue.  A product of
// two bf16 values is exact in float32, so the FMAs compute the same terms
// the bf16 passes do.  Moving those products to bf16 tensor cores is
// later work.
//
// Launch contract: the kernel runs on the caller's stream, allocates
// nothing and does not synchronise; the C entry points return
// cudaGetLastError().  Ragged edges (lines, half and n_in not multiples of
// the tile) are masked inside the kernel.  Built without --use_fast_math:
// log10f(0) is -inf on the exact path, as in the JAX package.

#include <type_traits>

#include "gemm_common.cuh"

namespace {

enum Epi { PLANAR = 0, SCALE = 1 };
enum Mode { MODE_LOG = 0, MODE_LIN = 1, MODE_FAST_LOG = 2 };

struct Args {
  const void* raw;
  const void* wre[3];
  const void* wim[3];
  const float* mean2;  // (2, half): FPN mean line, re then im
  float* re_out;       // PLANAR
  float* im_out;       // PLANAR
  void* out;           // SCALE
  long long lines;
  int n_in;
  int half;
  int bitshift;
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

// TN: depth bins per thread (BN = 16 * TN).  PASSES=5 keeps 10
// accumulators per output, so it takes TN=2 to stay clear of spills.
template <typename InT, typename WT, int PASSES, int EPI, typename OutT,
          int TN>
__global__ void __launch_bounds__(THREADS)
    fold_gemm(const Args args) {
  constexpr int PARTS = (PASSES + 1) / 2;  // operator parts per axis
  constexpr int XT = PASSES == 1 ? 1 : 2;  // x terms: x, or x_hi and x_lo
  constexpr int BN = 16 * TN;

  __shared__ float xs[XT][BK][BM + 1];  // +1: conflict-free transposed store
  __shared__ float ws[2][PARTS][BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int n_bin_tiles = (args.half + BN - 1) / BN;
  const long long m0 = static_cast<long long>(blockIdx.x / n_bin_tiles) * BM;
  const int n0 = static_cast<int>(blockIdx.x % n_bin_tiles) * BN;
  const InT* raw = static_cast<const InT*>(args.raw);

  // acc[axis][term][i][j]; term t < PARTS is x_hi * w_t, t >= PARTS is
  // x_lo * w_(t-PARTS) -- the order of _dot_split's term list.
  float acc[2][PASSES][TM][TN];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int t = 0; t < PASSES; ++t)
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[c][t][i][j] = 0.f;

  for (int k0 = 0; k0 < args.n_in; k0 += BK) {
    // Stage the decoded (and, for the split rungs, split) x tile.
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
    // Stage the operator tiles, every part of both axes.
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int r = e / BN;
      const int c = e % BN;
      const int k = k0 + r;
      const int n = n0 + c;
      const bool ok = k < args.n_in && n < args.half;
      const long long off = static_cast<long long>(k) * args.half + n;
#pragma unroll
      for (int p = 0; p < PARTS; ++p) {
        ws[0][p][r][c] = ok ? load_w<WT>(args.wre[p], off) : 0.f;
        ws[1][p][r][c] = ok ? load_w<WT>(args.wim[p], off) : 0.f;
      }
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
      for (int c = 0; c < 2; ++c) {
#pragma unroll
        for (int p = 0; p < PARTS; ++p) {
          float wr[TN];
#pragma unroll
          for (int j = 0; j < TN; ++j) wr[j] = ws[c][p][kk][tx + 16 * j];
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) {
              acc[c][p][i][j] = fmaf(xr[0][i], wr[j], acc[c][p][i][j]);
              if constexpr (XT == 2) {
                if (p < PARTS - 1)
                  acc[c][PARTS + p][i][j] =
                      fmaf(xr[XT - 1][i], wr[j], acc[c][PARTS + p][i][j]);
              }
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
      const int bin = n0 + tx + 16 * j;
      if (bin >= args.half) continue;
      float z[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float s = acc[c][PASSES - 1][i][j];  // low-order terms first
#pragma unroll
        for (int t = PASSES - 2; t >= 0; --t) s = s + acc[c][t][i][j];
        z[c] = s;
      }
      const long long o = line * args.half + bin;
      if constexpr (EPI == PLANAR) {
        args.re_out[o] = z[0];
        args.im_out[o] = z[1];
      } else {
        const float re = z[0] - args.mean2[bin];
        const float im = z[1] - args.mean2[args.half + bin];
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

template <typename InT, int PASSES, int EPI, typename OutT>
int launch(const Args& args, cudaStream_t stream) {
  using WT = typename std::conditional<PASSES == 1, float, __nv_bfloat16>::type;
  constexpr int TN = PASSES == 5 ? 2 : 4;
  constexpr int BN = 16 * TN;
  if (args.lines <= 0 || args.half <= 0 || args.n_in <= 0) return 0;
  const long long blocks =
      ((args.lines + BM - 1) / BM) * ((args.half + BN - 1) / BN);
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  fold_gemm<InT, WT, PASSES, EPI, OutT, TN>
      <<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

template <int EPI, typename OutT, typename InT>
int by_passes(int passes, const Args& args, cudaStream_t stream) {
  switch (passes) {
    case 1: return launch<InT, 1, EPI, OutT>(args, stream);
    case 3: return launch<InT, 3, EPI, OutT>(args, stream);
    case 5: return launch<InT, 5, EPI, OutT>(args, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int EPI, typename OutT>
int dispatch(int in_kind, int passes, const Args& args, cudaStream_t stream) {
  switch (in_kind) {
    case 0: return by_passes<EPI, OutT, uint8_t>(passes, args, stream);
    case 1: return by_passes<EPI, OutT, uint16_t>(passes, args, stream);
    case 2: return by_passes<EPI, OutT, float>(passes, args, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// in_kind: 0 uint8, 1 uint16, 2 float32.  passes: 1, 3 or 5 (with 1, 2 or
// 3 operator parts per axis; unused part pointers may be NULL).
int fold_gemm_planar(const void* raw, int in_kind, int bitshift, int passes,
                     const void* wre0, const void* wre1, const void* wre2,
                     const void* wim0, const void* wim1, const void* wim2,
                     float* re_out, float* im_out, long long lines, int n_in,
                     int half, void* stream) {
  Args args = {};
  args.raw = raw;
  args.wre[0] = wre0; args.wre[1] = wre1; args.wre[2] = wre2;
  args.wim[0] = wim0; args.wim[1] = wim1; args.wim[2] = wim2;
  args.re_out = re_out;
  args.im_out = im_out;
  args.lines = lines;
  args.n_in = n_in;
  args.half = half;
  args.bitshift = bitshift;
  return dispatch<PLANAR, float>(in_kind, passes, args,
                                 static_cast<cudaStream_t>(stream));
}

// mode: 0 log (a*log10(p)+b), 1 lin (a*sqrt(p)+b), 2 fast log
// (a*fast_log2(p)+b, with a already multiplied by log10(2)).
int fold_gemm_scale(const void* raw, int in_kind, int bitshift, int passes,
                    const void* wre0, const void* wre1, const void* wre2,
                    const void* wim0, const void* wim1, const void* wim2,
                    const float* mean2, void* out, int out_bf16, int mode,
                    float a, float b, long long lines, int n_in, int half,
                    void* stream) {
  Args args = {};
  args.raw = raw;
  args.wre[0] = wre0; args.wre[1] = wre1; args.wre[2] = wre2;
  args.wim[0] = wim0; args.wim[1] = wim1; args.wim[2] = wim2;
  args.mean2 = mean2;
  args.out = out;
  args.lines = lines;
  args.n_in = n_in;
  args.half = half;
  args.bitshift = bitshift;
  args.mode = mode;
  args.a = a;
  args.b = b;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_bf16 ? dispatch<SCALE, __nv_bfloat16>(in_kind, passes, args, s)
                  : dispatch<SCALE, float>(in_kind, passes, args, s);
}

const char* fold_gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
