// The folded-GEMM kernels against one concatenated operator [W_re | W_im],
// behind the C entry fold_gemm_scale_concat -- the counterparts of the
// Pallas kernels in octproz_tpu/pallas/fused_prep.py:
//
//   fold_gemm<EPI=SCALE, CONCAT>  _kernel_depth_scale_concat        (:337-351)
//                                 (the float32-FMA template of fold_gemm.cuh)
//   fold_split<EPI=SCALE>         _kernel_depth_scale_concat_split  (:354-372)
//                                 (bf16 tensor cores, fold_split.cu)
//
// The TPU kernels run ONE (tile, n_in) x (n_in, 2*half) MXU pass per tile
// (per bf16 part for the split rung, whose wide operator is split BEFORE
// the passes) and slice re = y[:, :half], im = y[:, half:] in the
// epilogue.  Here a block reads the same wide (n_in, 2*half) parts: for its
// bins j it stages columns j and j + half of each part, so the epilogue has
// bin j's re and im in registers, as with one operator per axis.  The split
// of a concatenation is the concatenation of the splits (the split is
// elementwise), so the split rung is the two-operator split kernel reading
// two views of each wide part, at W and W + half with row pitch 2*half.
//
// InT in {uint8, uint16, float}; OutT in {float, bf16}.

#include "fold_gemm.cuh"

extern "C" {
int fold_split_scale_concat(const void* raw, int in_kind, int bitshift, int passes,
                            const void* const w[3], const float* mean2, void* out,
                            int out_bf16, int mode, float a, float b, long long lines,
                            int n_in, int half, void* stream);
}

namespace {

// The one-pass rung for in_kind.
template <typename OutT>
int one_pass(int in_kind, const Args& args, cudaStream_t stream) {
  switch (in_kind) {
    case IN_U8: return launch<uint8_t, SCALE, OutT, true>(args, stream);
    case IN_U16: return launch<uint16_t, SCALE, OutT, true>(args, stream);
    case IN_FLOAT: return launch<float, SCALE, OutT, true>(args, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// in_kind: 0 uint8, 1 uint16, 2 float32.  passes: 1, 3 or 5 (with 1, 2 or
// 3 wide (n_in, 2*half) operator parts; unused part pointers may be NULL).
// mode: 0 log (a*log10(p)+b), 1 lin (a*sqrt(p)+b).
int fold_gemm_scale_concat(const void* raw, int in_kind, int bitshift,
                           int passes, const void* w0, const void* w1,
                           const void* w2, const float* mean2, void* out,
                           int out_bf16, int mode, float a, float b,
                           long long lines, int n_in, int half,
                           void* stream) {
  if (mode != MODE_LOG && mode != MODE_LIN)
    return static_cast<int>(cudaErrorInvalidValue);
  if (passes != 1) {
    const void* const w[3] = {w0, w1, w2};
    return fold_split_scale_concat(raw, in_kind, bitshift, passes, w, mean2, out, out_bf16,
                                   mode, a, b, lines, n_in, half, stream);
  }
  Args args = {};
  args.raw = raw;
  args.wre = static_cast<const float*>(w0);
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
  return out_bf16 ? one_pass<__nv_bfloat16>(in_kind, args, s) : one_pass<float>(in_kind, args, s);
}

}  // extern "C"
