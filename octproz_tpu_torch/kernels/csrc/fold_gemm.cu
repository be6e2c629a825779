// Folded-GEMM kernels with one operator per axis.  Four instantiation
// families, each the counterpart of a Pallas kernel in
// octproz_tpu/pallas/fused_prep.py:
//
//   fold_split<EPI=PLANAR, 3 parts> | fold_gemm  _kernel_depth  (:261-268)
//   fold_split<EPI=PLANAR>  (3|5)      _kernel_depth_split        (:271-280)
//   fold_split<EPI=SCALE, 3 parts>     _kernel_depth_scale        (:375-419; XP=3 on float32 lines)
//   fold_split<EPI=SCALE>   (3|5)      _kernel_depth_scale_split  (:422-438)
//   one_term<InT, Planar>  (fold_bf16.cu)  _kernel_depth at compute_dtype="bfloat16"
//   one_term<InT, Scale>   (fold_bf16.cu)  _kernel_depth_scale at compute_dtype="bfloat16"
//
// The split rungs run the bf16 tensor-core kernels of fold_split.cuh
// (launched from fold_split.cu), and so does the one-pass rung against
// three bf16 parts of its float32 operator: for the scaled kernel on every
// input type (float32 lines -- samples above 16 bits, decoded by the
// wrapper -- as three x parts, six terms: terms() in fold_split.cuh), for
// the planar kernel on uint8 and uint16 lines.  The planar kernel's one
// pass on float32 lines runs the float32-FMA kernel of fold_gemm.cuh
// against the float32 operator.  The input type and the family alone pick
// the route at float32 compute; compute_dtype="bfloat16" runs the
// persistent one-term kernel of fold_bf16.cu on every input type, the
// planar and the scaled epilogue alike.  OutT in {float, bf16} for SCALE.

#include "fold_gemm.cuh"

extern "C" {
int fold_split_planar(const void* raw, int in_kind, int bitshift, int passes,
                      const void* const wre[3], const void* const wim[3], float* re_out,
                      float* im_out, long long lines, int n_in, int half, void* stream);
int fold_split_scale(const void* raw, int in_kind, int bitshift, int passes,
                     const void* const wre[3], const void* const wim[3], const float* mean2,
                     void* out, int out_bf16, int mode, float a, float b, long long lines,
                     int n_in, int half, void* stream);
int fold_bf16_planar(const void* raw, int in_kind, int bitshift, const void* const wre[3],
                     const void* const wim[3], float* re_out, float* im_out, long long lines,
                     int n_in, int half, void* stream);
int fold_bf16_scale(const void* raw, int in_kind, int bitshift, const void* const wre[3],
                    const void* const wim[3], const float* mean2, void* out, int out_bf16,
                    int mode, float a, float b, long long lines, int n_in, int half,
                    void* stream);

// in_kind: 0 uint8, 1 uint16, 2 float32.  passes: 3 or 5 with 2 or 3 bf16
// operator parts per axis; 1 with the float32 operator in wre0 / wim0 for
// float32 lines, and with its three bf16 parts for uint8/uint16 lines;
// BF16_PASS (compute_dtype="bfloat16") with one rounded bf16 part per axis
// for any lines, forwarded to the one-term kernel of fold_bf16.cu.
// Unused part pointers may be NULL.  fold_gemm_scale takes the same
// arguments, but at one pass the three bf16 parts for every input type.
int fold_gemm_planar(const void* raw, int in_kind, int bitshift, int passes,
                     const void* wre0, const void* wre1, const void* wre2,
                     const void* wim0, const void* wim1, const void* wim2,
                     float* re_out, float* im_out, long long lines, int n_in,
                     int half, void* stream) {
  if (passes != 1 || in_kind != IN_FLOAT) {
    const void* const wre[3] = {wre0, wre1, wre2};
    const void* const wim[3] = {wim0, wim1, wim2};
    if (passes == BF16_PASS)
      return fold_bf16_planar(raw, in_kind, bitshift, wre, wim, re_out, im_out, lines, n_in,
                              half, stream);
    return fold_split_planar(raw, in_kind, bitshift, passes, wre, wim, re_out, im_out,
                             lines, n_in, half, stream);
  }
  Args args = {};
  args.raw = static_cast<const float*>(raw);
  args.wre = static_cast<const float*>(wre0);
  args.wim = static_cast<const float*>(wim0);
  args.re_out = re_out;
  args.im_out = im_out;
  args.lines = lines;
  args.n_in = n_in;
  args.half = half;
  return launch(args, static_cast<cudaStream_t>(stream));
}

// mode: 0 log (a*log10(p)+b), 1 lin (a*sqrt(p)+b), 2 fast log
// (a*fast_log2(p)+b, with a already multiplied by log10(2)).
int fold_gemm_scale(const void* raw, int in_kind, int bitshift, int passes,
                    const void* wre0, const void* wre1, const void* wre2,
                    const void* wim0, const void* wim1, const void* wim2,
                    const float* mean2, void* out, int out_bf16, int mode,
                    float a, float b, long long lines, int n_in, int half,
                    void* stream) {
  const void* const wre[3] = {wre0, wre1, wre2};
  const void* const wim[3] = {wim0, wim1, wim2};
  if (passes == BF16_PASS)
    return fold_bf16_scale(raw, in_kind, bitshift, wre, wim, mean2, out, out_bf16, mode, a, b,
                           lines, n_in, half, stream);
  return fold_split_scale(raw, in_kind, bitshift, passes, wre, wim, mean2, out, out_bf16, mode,
                          a, b, lines, n_in, half, stream);
}

const char* fold_gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
