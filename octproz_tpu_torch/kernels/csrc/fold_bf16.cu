// The one-term SCALE fold of compute_dtype="bfloat16" (kernel and design
// notes in fold_bf16.cuh), behind fold_gemm_scale (fold_gemm.cu) and
// fold_gemm_scale_concat (fold_concat.cu) at passes = BF16_PASS, on every
// input type:
//
//   fold_bf16<InT, OutT>  _kernel_depth_scale         (octproz_tpu/pallas/fused_prep.py:375-419)
//   fold_bf16<InT, OutT>  _kernel_depth_scale_concat  (:337-351)
//
// with InT in {uint8, uint16, float} and OutT in {float, bf16}.  The concat
// kernel reads its one rounded wide (n_in, 2 * half) part [W_re | W_im] as
// two views, W and W + half, at row pitch 2 * half; at half % 8 != 0 the im
// view is not 16-byte aligned and the producers store it element by
// element.  A launch with other than one bf16 part per axis is refused.

#include "fold_bf16.cuh"

namespace {
namespace bf16 {

template <typename OutT>
int dispatch_input(int in_kind, const Params& p, cudaStream_t stream) {
  switch (in_kind) {
    case IN_U8: return launch<uint8_t, OutT>(p, stream);
    case IN_U16: return launch<uint16_t, OutT>(p, stream);
    case IN_FLOAT: return launch<float, OutT>(p, stream);
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
