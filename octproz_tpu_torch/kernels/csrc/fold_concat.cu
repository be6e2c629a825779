// Folded-GEMM kernels against one concatenated operator [W_re | W_im]
// (template and design notes in fold_gemm.cuh).  Two instantiation
// families, the counterparts of the Pallas kernels in
// octproz_tpu/pallas/fused_prep.py:
//
//   fold_gemm<EPI=SCALE, PASSES=1,   CONCAT>  _kernel_depth_scale_concat        (:337-351)
//   fold_gemm<EPI=SCALE, PASSES=3|5, CONCAT>  _kernel_depth_scale_concat_split  (:354-372)
//
// The TPU kernels run ONE (tile, n_in) x (n_in, 2*half) MXU pass per tile
// (per bf16 part for the split rung, whose wide operator is split BEFORE
// the passes) and slice re = y[:, :half], im = y[:, half:] in the
// epilogue.  Here a block reads the same wide (n_in, 2*half) parts: for its
// bins j it stages columns j and j + half of each part, so the epilogue has
// bin j's re and im in registers, as with one operator per axis.  Each
// part's wide columns are consumed in one K loop; the split of a
// concatenation is the concatenation of the splits (the split is
// elementwise), so these kernels compute the same terms as fold_gemm.cu's
// SCALE family on the halves.
//
// InT in {uint8, uint16, float}; OutT in {float, bf16}.

#include "fold_gemm.cuh"

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
  Args args = {};
  args.raw = raw;
  args.wre[0] = w0; args.wre[1] = w1; args.wre[2] = w2;
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
  return out_bf16 ? dispatch<SCALE, __nv_bfloat16, true>(in_kind, passes, args, s)
                  : dispatch<SCALE, float, true>(in_kind, passes, args, s);
}

}  // extern "C"
