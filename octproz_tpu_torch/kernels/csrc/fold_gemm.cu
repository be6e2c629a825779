// Folded-GEMM kernels with one operator per axis (template and design notes
// in fold_gemm.cuh).  Four instantiation families, each the counterpart of
// a Pallas kernel in octproz_tpu/pallas/fused_prep.py:
//
//   fold_gemm<EPI=PLANAR, PASSES=1>    _kernel_depth              (:261-268)
//   fold_gemm<EPI=PLANAR, PASSES=3|5>  _kernel_depth_split        (:271-280)
//   fold_gemm<EPI=SCALE,  PASSES=1>    _kernel_depth_scale        (:375-419)
//   fold_gemm<EPI=SCALE,  PASSES=3|5>  _kernel_depth_scale_split  (:422-438)
//
// with InT in {uint8, uint16, float} (raw samples; float is input the
// wrapper decoded already) and OutT in {float, bf16} for SCALE.

#include "fold_gemm.cuh"

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
  return dispatch<PLANAR, float, false>(in_kind, passes, args,
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
  return out_bf16 ? dispatch<SCALE, __nv_bfloat16, false>(in_kind, passes, args, s)
                  : dispatch<SCALE, float, false>(in_kind, passes, args, s);
}

const char* fold_gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
