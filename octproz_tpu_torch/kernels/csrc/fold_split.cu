// The fold kernels' C entries and their tensor-core launches (template and
// design notes in fold_split.cuh).  fold_gemm_planar and fold_gemm_scale
// (one operator per axis) and fold_gemm_scale_concat (one wide [W_re |
// W_im] operator) run, at 3 and 5 passes,
//
//   fold_split<EPI=PLANAR>  _kernel_depth_split        (octproz_tpu/pallas/fused_prep.py:271-280)
//   fold_split<EPI=SCALE>   _kernel_depth_scale_split  (:422-438)
//   fold_split<EPI=SCALE>   _kernel_depth_scale_concat_split  (:354-372, two views)
//
// with InT in {uint8, uint16, float} and OutT in {float, bf16} for SCALE,
// and at one pass, on uint8/uint16 lines and (with three x parts: XP=3) on
// float32 lines,
//
//   fold_split<EPI=PLANAR, PARTS=3>        _kernel_depth        (:261-268)
//   fold_split<EPI=SCALE,  PARTS=3>        _kernel_depth_scale  (:375-419)
//   fold_split<EPI=SCALE,  PARTS=3>        _kernel_depth_scale_concat  (:337-351, two views)
//   fold_split<EPI=PLANAR, PARTS=3, XP=3>  _kernel_depth on float32 lines
//   fold_split<EPI=SCALE,  PARTS=3, XP=3>  _kernel_depth_scale(_concat) on float32 lines
//
// and at compute_dtype="bfloat16" (passes = BF16_PASS: one term) the
// persistent one-term kernel of fold_bf16.cu, planar and scaled:
//
//   one_term<InT, Planar>      _kernel_depth
//   one_term<InT, Scale<OutT>> _kernel_depth_scale(_concat)
//
// The one-pass rung is a float32 product.  Its float32 operator arrives
// here as three bf16 parts (two mask truncations and a rounded remainder:
// ~24 mantissa bits), and an integer sample of at most 16 bits is exactly
// x_hi + x_lo, so the terms x_hi w_2, x_hi w_1, x_hi w_0 and, where a stage
// holds a sample of 256 or more, x_lo w_1, x_lo w_0 -- those of "highest",
// the same instantiations -- give that product at float32 grade on the
// tensor cores.  What bounds it, on one H100 (H100 80GB HBM3, 700 W): at the
// main path's geometry each term is 275 GFLOP of bf16 products, so shifted
// 12-bit samples (three terms) are bound to 0.83 ms at 989 TFLOP/s.  A
// float32 sample (above 16 bits, of which x_hi + x_lo keeps 16) is exactly
// x_hi + x_mid + x_lo: every fold kernel's one pass on float32 lines, the
// planar, the two-operator and the concat kernel alike, runs the six terms
// of those three x parts against the three operator parts (fold_split<EPI,
// PARTS=3, XP=3>, terms()), 1.67 ms at 989 TFLOP/s on 24-bit samples.  A
// one-pass launch without the three bf16 parts is refused.
//
// A block's two operator halves are (W_re, n0) and (W_im, n0): 64 bins of
// re and im (COLS = BINS).  The concat kernels read one wide (n_in, 2*half)
// [W_re | W_im] part per part; the split of a concatenation is the
// concatenation of the splits (the split is elementwise), so their W_re and
// W_im are two views of that part, at W and W + half with row pitch
// 2 * half, and they compute the terms of the two-operator kernel -- at one
// pass the three parts of both views, six pointers, each checked for TMA's
// 16-byte alignment.  half % 8 != 0 (an operator row pitch or a view TMA
// cannot describe), or raw rows that are not 16-byte aligned, take the
// element-wise producer, which writes the raw tile in the layout the kernel
// reads, the three-x-part kernel's swizzled boxes included.

#include "fold_split.cuh"

extern "C" {
int fold_bf16_planar(const void* raw, int in_kind, int bitshift, const void* const wre[3],
                     const void* const wim[3], float* re_out, float* im_out, long long lines,
                     int n_in, int half, void* stream);
int fold_bf16_scale(const void* raw, int in_kind, int bitshift, const void* const wre[3],
                    const void* const wim[3], const float* mean2, void* out, int out_bf16,
                    int mode, float a, float b, long long lines, int n_in, int half,
                    void* stream);
int fold_bf16_scale_concat(const void* raw, int in_kind, int bitshift, const void* const w[3],
                           const float* mean2, void* out, int out_bf16, int mode, float a,
                           float b, long long lines, int n_in, int half, void* stream);
}

namespace {
namespace split {

template <int EPI, typename OutT>
struct Fold {
  template <typename InT, int PARTS, int XP>
  struct K {
    static int run(const Params& p, cudaStream_t stream) {
      const Kernel kernel = fold_split<InT, PARTS, XP, EPI, OutT>;
      static const cudaError_t attr = opt_in<InT, PARTS, XP>(kernel);
      return launch<InT, PARTS, BINS, XP>(p, kernel, attr, stream);
    }
  };
};

// terms() of a fold launch: as many parts on both axes.
int fold_terms(int in_kind, int passes, const void* const wre[3], const void* const wim[3]) {
  const int parts = parts_of(wre);
  return terms(in_kind, passes, parts_of(wim) == parts ? parts : 0);
}

// ld: the parts' row pitch, half for one operator per axis.
Params params(const void* raw, int bitshift, const void* const wre[3], const void* const wim[3],
              long long lines, int n_in, int half, int ld) {
  Params p = {};
  p.raw = raw;
  for (int q = 0; q < 3; ++q) {
    p.w[0][q] = static_cast<const __nv_bfloat16*>(wre[q]);
    p.w[1][q] = static_cast<const __nv_bfloat16*>(wim[q]);
  }
  p.lines = lines;
  p.n_in = n_in;
  p.width = half;
  p.ld = ld;
  p.bitshift = bitshift;
  return p;
}

// The SCALE launch of n_terms pass terms (terms(): 3, 5, or 6 with three x parts).
int scale(Params p, int in_kind, int n_terms, const float* mean2, void* out, int out_bf16,
          int mode, float a, float b, void* stream) {
  p.mean2 = mean2;
  p.out = out;
  p.mode = mode;
  p.a = a;
  p.b = b;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_bf16 ? dispatch<Fold<SCALE, __nv_bfloat16>::K>(in_kind, n_terms, p, s)
                  : dispatch<Fold<SCALE, float>::K>(in_kind, n_terms, p, s);
}

}  // namespace split
}  // namespace

extern "C" {

// The tensor-core launches of fold_gemm_planar / fold_gemm_scale, with the
// same arguments as three part pointers per axis: 3 or 5 passes against 2
// or 3 bf16 parts per axis, or 1 pass against the float32 operator's three
// bf16 parts (5 terms on uint8/uint16 lines, 6 on float32 lines).
int fold_split_planar(const void* raw, int in_kind, int bitshift, int passes,
                      const void* const wre[3], const void* const wim[3], float* re_out,
                      float* im_out, long long lines, int n_in, int half, void* stream) {
  split::Params p = split::params(raw, bitshift, wre, wim, lines, n_in, half, half);
  p.re_out = re_out;
  p.im_out = im_out;
  return split::dispatch<split::Fold<PLANAR, float>::K>(
      in_kind, split::fold_terms(in_kind, passes, wre, wim), p,
      static_cast<cudaStream_t>(stream));
}

int fold_split_scale(const void* raw, int in_kind, int bitshift, int passes,
                     const void* const wre[3], const void* const wim[3], const float* mean2,
                     void* out, int out_bf16, int mode, float a, float b, long long lines,
                     int n_in, int half, void* stream) {
  return split::scale(split::params(raw, bitshift, wre, wim, lines, n_in, half, half), in_kind,
                      split::fold_terms(in_kind, passes, wre, wim), mean2, out, out_bf16, mode,
                      a, b, stream);
}

// in_kind: 0 uint8, 1 uint16, 2 float32.  passes: 3 or 5 with 2 or 3 bf16
// operator parts per axis; 1 with the float32 operator's three bf16 parts
// for every input type; BF16_PASS (compute_dtype="bfloat16") with one
// rounded bf16 part per axis for any lines, forwarded to the one-term
// kernel of fold_bf16.cu.  Unused part pointers may be NULL.
int fold_gemm_planar(const void* raw, int in_kind, int bitshift, int passes,
                     const void* wre0, const void* wre1, const void* wre2,
                     const void* wim0, const void* wim1, const void* wim2,
                     float* re_out, float* im_out, long long lines, int n_in,
                     int half, void* stream) {
  const void* const wre[3] = {wre0, wre1, wre2};
  const void* const wim[3] = {wim0, wim1, wim2};
  if (passes == BF16_PASS)
    return fold_bf16_planar(raw, in_kind, bitshift, wre, wim, re_out, im_out, lines, n_in,
                            half, stream);
  return fold_split_planar(raw, in_kind, bitshift, passes, wre, wim, re_out, im_out, lines,
                           n_in, half, stream);
}

// fold_gemm_planar's arguments, then the FPN mean line and the scale.  mode:
// 0 log (a*log10(p)+b), 1 lin (a*sqrt(p)+b), 2 fast log (a*fast_log2(p)+b,
// with a already multiplied by log10(2)).  OutT: float32, or bf16 with
// out_bf16.
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

// in_kind: 0 uint8, 1 uint16, 2 float32.  passes: 3 or 5 with 2 or 3 bf16
// parts of the wide (n_in, 2 * half) operator [W_re | W_im]; 1 with the
// float32 wide operator's three bf16 parts for every input type (5 terms
// on uint8/uint16 lines, 6 on float32 lines); each part read as the views
// (W, n0) and (W + half, n0) at row pitch 2 * half.  BF16_PASS
// (compute_dtype="bfloat16") with its one rounded bf16 part for any lines,
// forwarded to fold_bf16.cu.  Unused part pointers may be NULL.  mode: 0
// log (a*log10(p)+b), 1 lin (a*sqrt(p)+b).
int fold_gemm_scale_concat(const void* raw, int in_kind, int bitshift, int passes,
                           const void* w0, const void* w1, const void* w2, const float* mean2,
                           void* out, int out_bf16, int mode, float a, float b,
                           long long lines, int n_in, int half, void* stream) {
  if (mode != MODE_LOG && mode != MODE_LIN) return static_cast<int>(cudaErrorInvalidValue);
  const void* const w[3] = {w0, w1, w2};
  if (passes == BF16_PASS)
    return fold_bf16_scale_concat(raw, in_kind, bitshift, w, mean2, out, out_bf16, mode, a, b,
                                  lines, n_in, half, stream);
  const void* wim[3];
  for (int q = 0; q < 3; ++q)
    wim[q] = w[q] ? static_cast<const __nv_bfloat16*>(w[q]) + half : nullptr;
  return split::scale(split::params(raw, bitshift, w, wim, lines, n_in, half, 2 * half),
                      in_kind, split::terms(in_kind, passes, split::parts_of(w)), mean2,
                      out, out_bf16, mode, a, b, stream);
}

const char* fold_gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
