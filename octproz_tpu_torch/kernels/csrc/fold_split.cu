// The split-rung fold kernels on bf16 tensor cores (template and design
// notes in fold_split.cuh): the launches behind fold_gemm_planar and
// fold_gemm_scale at 3 and 5 passes (fold_gemm.cu keeps the one-pass rung).
//
//   fold_split<EPI=PLANAR>  _kernel_depth_split        (octproz_tpu/pallas/fused_prep.py:271-280)
//   fold_split<EPI=SCALE>   _kernel_depth_scale_split  (:422-438)
//
// with InT in {uint8, uint16, float} and OutT in {float, bf16} for SCALE.
// A block's two operator halves are (W_re, n0) and (W_im, n0): 64 bins of
// re and im (COLS = BINS).

#include "fold_split.cuh"

namespace {
namespace split {

template <int EPI, typename OutT>
struct Fold {
  template <typename InT, int PARTS>
  struct K {
    static int run(const Params& p, cudaStream_t stream) {
      const Kernel kernel = fold_split<InT, PARTS, EPI, OutT>;
      static const cudaError_t attr = opt_in<InT, PARTS>(kernel);
      return launch<InT, PARTS, BINS>(p, kernel, attr, stream);
    }
  };
};

Params params(const void* raw, int bitshift, const void* const wre[3], const void* const wim[3],
              long long lines, int n_in, int half) {
  Params p = {};
  p.raw = raw;
  for (int q = 0; q < 3; ++q) {
    p.w[0][q] = static_cast<const __nv_bfloat16*>(wre[q]);
    p.w[1][q] = static_cast<const __nv_bfloat16*>(wim[q]);
  }
  p.lines = lines;
  p.n_in = n_in;
  p.width = half;
  p.bitshift = bitshift;
  return p;
}

}  // namespace split
}  // namespace

extern "C" {

// The 3/5-pass launches of fold_gemm_planar / fold_gemm_scale (fold_gemm.cu),
// with the same arguments.
int fold_split_planar(const void* raw, int in_kind, int bitshift, int passes,
                      const void* const wre[3], const void* const wim[3], float* re_out,
                      float* im_out, long long lines, int n_in, int half, void* stream) {
  split::Params p = split::params(raw, bitshift, wre, wim, lines, n_in, half);
  p.re_out = re_out;
  p.im_out = im_out;
  return split::dispatch<split::Fold<PLANAR, float>::K>(in_kind, passes, p,
                                                        static_cast<cudaStream_t>(stream));
}

int fold_split_scale(const void* raw, int in_kind, int bitshift, int passes,
                     const void* const wre[3], const void* const wim[3], const float* mean2,
                     void* out, int out_bf16, int mode, float a, float b, long long lines,
                     int n_in, int half, void* stream) {
  split::Params p = split::params(raw, bitshift, wre, wim, lines, n_in, half);
  p.mean2 = mean2;
  p.out = out;
  p.mode = mode;
  p.a = a;
  p.b = b;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_bf16 ? split::dispatch<split::Fold<SCALE, __nv_bfloat16>::K>(in_kind, passes, p, s)
                  : split::dispatch<split::Fold<SCALE, float>::K>(in_kind, passes, p, s);
}

}  // extern "C"
