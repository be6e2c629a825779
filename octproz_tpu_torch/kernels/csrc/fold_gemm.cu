// Folded-GEMM kernels with one operator per axis.  Four instantiation
// families, each the counterpart of a Pallas kernel in
// octproz_tpu/pallas/fused_prep.py:
//
//   fold_split<EPI=PLANAR, 3 parts> | fold_gemm<EPI=PLANAR>  _kernel_depth  (:261-268)
//   fold_split<EPI=PLANAR>  (3|5)      _kernel_depth_split        (:271-280)
//   fold_split<EPI=SCALE, 3 parts> | fold_gemm<EPI=SCALE>  _kernel_depth_scale  (:375-419)
//   fold_split<EPI=SCALE>   (3|5)      _kernel_depth_scale_split  (:422-438)
//
// The split rungs run the bf16 tensor-core kernels of fold_split.cuh
// (launched from fold_split.cu), and so does the one-pass rung for uint8
// and uint16 lines, against three bf16 parts of its float32 operator.  For
// float32 lines -- samples above 16 bits, decoded by the wrapper, which the
// x_hi + x_lo split cannot carry -- the one-pass rung runs the float32-FMA
// template of fold_gemm.cuh against the float32 operator.  The input type
// alone picks the route at float32 compute; compute_dtype="bfloat16" runs
// the tensor-core kernels on every input type.  OutT in {float, bf16} for
// SCALE.

#include "fold_gemm.cuh"

extern "C" {
int fold_split_planar(const void* raw, int in_kind, int bitshift, int passes,
                      const void* const wre[3], const void* const wim[3], float* re_out,
                      float* im_out, long long lines, int n_in, int half, void* stream);
int fold_split_scale(const void* raw, int in_kind, int bitshift, int passes,
                     const void* const wre[3], const void* const wim[3], const float* mean2,
                     void* out, int out_bf16, int mode, float a, float b, long long lines,
                     int n_in, int half, void* stream);

// in_kind: 0 uint8, 1 uint16, 2 float32.  passes: 3 or 5 with 2 or 3 bf16
// operator parts per axis; 1 with the float32 operator in wre0 / wim0 for
// float32 lines, and with its three bf16 parts for uint8/uint16 lines;
// BF16_PASS (compute_dtype="bfloat16") with one rounded bf16 part per axis
// for any lines, forwarded to the tensor cores like the split rungs.
// Unused part pointers may be NULL.
int fold_gemm_planar(const void* raw, int in_kind, int bitshift, int passes,
                     const void* wre0, const void* wre1, const void* wre2,
                     const void* wim0, const void* wim1, const void* wim2,
                     float* re_out, float* im_out, long long lines, int n_in,
                     int half, void* stream) {
  if (passes != 1 || in_kind != IN_FLOAT) {
    const void* const wre[3] = {wre0, wre1, wre2};
    const void* const wim[3] = {wim0, wim1, wim2};
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
  return launch<PLANAR, float, false>(args, static_cast<cudaStream_t>(stream));
}

// mode: 0 log (a*log10(p)+b), 1 lin (a*sqrt(p)+b), 2 fast log
// (a*fast_log2(p)+b, with a already multiplied by log10(2)).
int fold_gemm_scale(const void* raw, int in_kind, int bitshift, int passes,
                    const void* wre0, const void* wre1, const void* wre2,
                    const void* wim0, const void* wim1, const void* wim2,
                    const float* mean2, void* out, int out_bf16, int mode,
                    float a, float b, long long lines, int n_in, int half,
                    void* stream) {
  if (passes != 1 || in_kind != IN_FLOAT) {
    const void* const wre[3] = {wre0, wre1, wre2};
    const void* const wim[3] = {wim0, wim1, wim2};
    return fold_split_scale(raw, in_kind, bitshift, passes, wre, wim, mean2, out, out_bf16,
                            mode, a, b, lines, n_in, half, stream);
  }
  Args args = {};
  args.raw = static_cast<const float*>(raw);
  args.wre = static_cast<const float*>(wre0);
  args.wim = static_cast<const float*>(wim0);
  args.mean2 = mean2;
  args.out = out;
  args.lines = lines;
  args.n_in = n_in;
  args.half = half;
  args.mode = mode;
  args.a = a;
  args.b = b;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_bf16 ? launch<SCALE, __nv_bfloat16, false>(args, s)
                  : launch<SCALE, float, false>(args, s);
}

const char* fold_gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
