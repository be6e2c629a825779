// The folded-GEMM kernels against one concatenated operator [W_re | W_im],
// behind the C entry fold_gemm_scale_concat -- the counterparts of the
// Pallas kernels in octproz_tpu/pallas/fused_prep.py:
//
//   fold_split<EPI=SCALE, 3 parts> | fold_gemm<EPI=SCALE, CONCAT>
//                                 _kernel_depth_scale_concat        (:337-351)
//   fold_split<EPI=SCALE> (3|5)   _kernel_depth_scale_concat_split  (:354-372)
//   fold_bf16 (fold_bf16.cu)      _kernel_depth_scale_concat at compute_dtype="bfloat16"
//
// Every rung on uint8/uint16 lines runs on the bf16 tensor cores
// (fold_split.cu): the split rungs against the wide operator's 2/3 bf16
// parts, and the one-pass rung against the three bf16 parts of the float32
// wide operator (the five "highest" terms, terms() in fold_split.cuh: the
// float32 product at float32 grade for samples of at most 16 bits).  The
// float32-FMA template of fold_gemm.cuh keeps the one pass on float32 lines
// -- samples above 16 bits, which the x_hi + x_lo split cannot carry; the
// three x parts that B2 takes on them are not routed here -- against the
// float32 wide operator.  The input type alone picks the route
// at float32 compute; compute_dtype="bfloat16" runs the persistent one-term
// kernel of fold_bf16.cu on one rounded wide part for every input type.
//
// The TPU kernels run ONE (tile, n_in) x (n_in, 2*half) MXU pass per tile
// (per bf16 part for the split rung, whose wide operator is split BEFORE
// the passes) and slice re = y[:, :half], im = y[:, half:] in the
// epilogue.  Here a block reads the same wide (n_in, 2*half) parts: for its
// bins j it stages columns j and j + half of each part, so the epilogue has
// bin j's re and im in registers, as with one operator per axis.  The split
// of a concatenation is the concatenation of the splits (the split is
// elementwise), so the tensor-core launch is the two-operator split kernel
// reading two views of each wide part, at W and W + half with row pitch
// 2*half.
//
// What bounds it, on one H100 (H100 80GB HBM3, 700 W): at the main path's
// geometry (131072 lines x 1024 samples -> 512 bins) each pass term is 275
// GFLOP; on shifted 12-bit samples (x_lo zero) the one pass runs three bf16
// terms, 0.83 ms at 989 TFLOP/s (five with x_lo, 1.39 ms), where the
// float32-FMA template is bound to 4.1 ms at 67 TFLOP/s.
//
// OutT in {float, bf16}.

#include "fold_gemm.cuh"

extern "C" {
int fold_split_scale_concat(const void* raw, int in_kind, int bitshift, int passes,
                            const void* const w[3], const float* mean2, void* out,
                            int out_bf16, int mode, float a, float b, long long lines,
                            int n_in, int half, void* stream);
int fold_bf16_scale_concat(const void* raw, int in_kind, int bitshift, const void* const w[3],
                           const float* mean2, void* out, int out_bf16, int mode, float a,
                           float b, long long lines, int n_in, int half, void* stream);

// in_kind: 0 uint8, 1 uint16, 2 float32.  passes: 3 or 5 with 2 or 3 bf16
// parts of the wide (n_in, 2*half) operator; 1 with the float32 wide
// operator in w0 for float32 lines, and with its three bf16 parts for
// uint8/uint16 lines; BF16_PASS (compute_dtype="bfloat16") with its one
// rounded bf16 part for any lines.  Unused part pointers may be NULL.
// mode: 0 log (a*log10(p)+b), 1 lin (a*sqrt(p)+b).
int fold_gemm_scale_concat(const void* raw, int in_kind, int bitshift,
                           int passes, const void* w0, const void* w1,
                           const void* w2, const float* mean2, void* out,
                           int out_bf16, int mode, float a, float b,
                           long long lines, int n_in, int half,
                           void* stream) {
  if (mode != MODE_LOG && mode != MODE_LIN)
    return static_cast<int>(cudaErrorInvalidValue);
  if (passes != 1 || in_kind != IN_FLOAT) {
    const void* const w[3] = {w0, w1, w2};
    if (passes == BF16_PASS)
      return fold_bf16_scale_concat(raw, in_kind, bitshift, w, mean2, out, out_bf16, mode, a,
                                    b, lines, n_in, half, stream);
    return fold_split_scale_concat(raw, in_kind, bitshift, passes, w, mean2, out, out_bf16,
                                   mode, a, b, lines, n_in, half, stream);
  }
  Args args = {};
  args.raw = static_cast<const float*>(raw);
  args.wre = static_cast<const float*>(w0);
  args.mean2 = mean2;
  args.out = out;
  args.lines = lines;
  args.n_in = n_in;
  args.half = half;
  args.mode = mode;
  args.a = a;
  args.b = b;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_bf16 ? launch<SCALE, __nv_bfloat16, true>(args, s)
                  : launch<SCALE, float, true>(args, s);
}

}  // extern "C"
