// The one-term SCALE fold of compute_dtype="bfloat16" (the kernel and its
// design notes in fold_bf16.cuh), behind fold_gemm_scale (fold_gemm.cu) and
// fold_gemm_scale_concat (fold_concat.cu) at passes = BF16_PASS, on every
// input type:
//
//   one_term<InT, Scale<OutT>>  _kernel_depth_scale         (octproz_tpu/pallas/fused_prep.py:375-419)
//   one_term<InT, Scale<OutT>>  _kernel_depth_scale_concat  (:337-351)
//
// with InT in {uint8, uint16, float} and OutT in {float, bf16}.  A tile is
// 128 lines x 128 bins: chain 0 the re boxes (W_re at n0 and n0 + 64),
// chain 1 the im boxes, so the thread that holds bin j's re holds its im.
// The concat kernel reads its one rounded wide (n_in, 2 * half) part
// [W_re | W_im] as two views, W and W + half, at row pitch 2 * half; at
// half % 8 != 0 the im view is not 16-byte aligned and the producers store
// it element by element.  A launch with other than one bf16 part per axis
// is refused.

#include "fold_bf16.cuh"

namespace {
namespace bf16 {

template <typename OutT>
__device__ __forceinline__ void store2(OutT* out, long long o, float v0, float v1, bool both,
                                       bool pair) {
  if (!keep(v0 + v1)) return;
  if (pair) {
    if constexpr (sizeof(OutT) == 4) {
      *reinterpret_cast<float2*>(out + o) = make_float2(v0, v1);
    } else {
      *reinterpret_cast<__nv_bfloat162*>(out + o) = __floats2bfloat162_rn(v0, v1);
    }
  } else {
    out[o] = store_cast<OutT>(v0);
    if (both) out[o + 1] = store_cast<OutT>(v1);
  }
}

// One voxel: FPN-subtracted re and im -> p -> the scale, at mode MODE.  The
// log mode takes log2 from the special-function unit (lg2.approx, at most
// ~2^-22 absolute error) times log10(2): A*log10(p)+B to ~1e-8 display
// units of the accurate log10f at the benchmark's scale, far inside the
// bounds against the plain version, at a fraction of log10f's
// instructions (log10f made the epilogue the largest part of the
// consumers' own path).  fast_log keeps the JAX package's polynomial (_fast_log2), lin
// the IEEE square root.
template <int MODE>
__device__ __forceinline__ float scale(float re, float im, float a, float b) {
  if (FOLD_SPLIT_VARIANT & 16) return re + im;  // diagnostic: no epilogue math
  const float pw = re * re + im * im;
  if constexpr (MODE == MODE_LOG) return a * __log2f(pw) + b;
  if constexpr (MODE == MODE_LIN) return a * sqrtf(pw) + b;
  return a * fast_log2(pw) + b;
}

// The scaled fold's epilogue: two views (re, im) of 128 bins per tile.
template <typename OutT>
struct Scale {
  static constexpr int COLS = 128;  // bins per tile
  static constexpr int MAPS = 2;    // W_re, W_im
  // box q: re (q < 2) or im, bins n0 + 64 (q % 2)
  __host__ __device__ static constexpr int map(int q) { return q >> 1; }
  __host__ __device__ static constexpr int offset(int q) { return (q & 1) * BOX; }
  template <typename InT>
  static int extra(const Params&) { return 0; }
  template <typename InT>
  __device__ static int prepare(const Params&, uint8_t*, int) { return 0; }

  // The tile's voxels from the sums (wgmma's n128 layout: re[4j + i] and
  // im[4j + i] are line line0 + 8 * (i >> 1), bin n0 + 8j + 2t + (i & 1));
  // a is A*log10(2) for the log modes.  Two neighbouring bins per store:
  // every 32-byte sector of a float32 row is written whole by one warp
  // instruction.
  template <int MODE>
  __device__ static void voxels(const Params& p, const float (&re)[64], const float (&im)[64],
                                long long line0, int n0, int t, float a) {
    const int half = p.width;
    OutT* const out = static_cast<OutT*>(p.out);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int bin = n0 + 8 * j + 2 * t;
      if (bin >= half) continue;
      const bool both = bin + 1 < half;
      const bool pair = both && (half & 1) == 0;  // 2-element aligned: a vector store
      const float mr0 = p.mean2[bin], mi0 = p.mean2[half + bin];
      const float mr1 = both ? p.mean2[bin + 1] : 0.f;
      const float mi1 = both ? p.mean2[half + bin + 1] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long line = line0 + 8 * h;
        if (line >= p.lines) continue;
        const int i = 4 * j + 2 * h;
        store2(out, line * half + bin, scale<MODE>(re[i] - mr0, im[i] - mi0, a, p.b),
               scale<MODE>(re[i + 1] - mr1, im[i + 1] - mi1, a, p.b), both, pair);
      }
    }
  }

  __device__ static void store(const Params& p, int, const float (&re)[64],
                               const float (&im)[64], long long line0, int n0, int t) {
    if (p.mode == MODE_LOG)
      voxels<MODE_LOG>(p, re, im, line0, n0, t, p.a * 0.30102999566398120f);
    else if (p.mode == MODE_LIN)
      voxels<MODE_LIN>(p, re, im, line0, n0, t, p.a);
    else
      voxels<MODE_FAST_LOG>(p, re, im, line0, n0, t, p.a);
  }
};

template <typename OutT>
int dispatch_input(int in_kind, const Params& p, cudaStream_t stream) {
  switch (in_kind) {
    case IN_U8: return launch<uint8_t, Scale<OutT>>(p, stream);
    case IN_U16: return launch<uint16_t, Scale<OutT>>(p, stream);
    case IN_FLOAT: return launch<float, Scale<OutT>>(p, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int scale(const void* raw, int in_kind, int bitshift, const void* wre, const void* wim, int ld,
          const float* mean2, void* out, int out_bf16, int mode, float a, float b,
          long long lines, int n_in, int half, void* stream) {
  Params p = {};
  p.raw = raw;
  p.w[0][0] = static_cast<const __nv_bfloat16*>(wre);
  p.w[1][0] = static_cast<const __nv_bfloat16*>(wim);
  p.mean2 = mean2;
  p.out = out;
  p.lines = lines;
  p.n_in = n_in;
  p.width = half;
  p.ld = ld;
  p.bitshift = bitshift;
  p.mode = mode;
  p.a = a;
  p.b = b;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_bf16 ? dispatch_input<__nv_bfloat16>(in_kind, p, s)
                  : dispatch_input<float>(in_kind, p, s);
}

}  // namespace bf16
}  // namespace

extern "C" {

// fold_gemm_scale at BF16_PASS: one rounded bf16 part per axis, wre[0] and
// wim[0] (the others NULL).
int fold_bf16_scale(const void* raw, int in_kind, int bitshift, const void* const wre[3],
                    const void* const wim[3], const float* mean2, void* out, int out_bf16,
                    int mode, float a, float b, long long lines, int n_in, int half,
                    void* stream) {
  if (split::parts_of(wre) != 1 || split::parts_of(wim) != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return bf16::scale(raw, in_kind, bitshift, wre[0], wim[0], half, mean2, out, out_bf16, mode,
                     a, b, lines, n_in, half, stream);
}

// fold_gemm_scale_concat at BF16_PASS: the one rounded wide part in w[0],
// read as the views w[0] and w[0] + half at row pitch 2 * half.
int fold_bf16_scale_concat(const void* raw, int in_kind, int bitshift, const void* const w[3],
                           const float* mean2, void* out, int out_bf16, int mode, float a,
                           float b, long long lines, int n_in, int half, void* stream) {
  if (split::parts_of(w) != 1) return static_cast<int>(cudaErrorInvalidValue);
  const void* const wim = static_cast<const __nv_bfloat16*>(w[0]) + half;
  return bf16::scale(raw, in_kind, bitshift, w[0], wim, 2 * half, mean2, out, out_bf16, mode,
                     a, b, lines, n_in, half, stream);
}

}  // extern "C"
