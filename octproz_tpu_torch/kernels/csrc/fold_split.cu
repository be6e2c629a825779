// The fold kernels on bf16 tensor cores (template and design notes in
// fold_split.cuh): every rung of every fold family on uint8/uint16 lines.
// Behind fold_gemm_planar and fold_gemm_scale (fold_gemm.cu) at 3 and 5
// passes,
//
//   fold_split<EPI=PLANAR>  _kernel_depth_split        (octproz_tpu/pallas/fused_prep.py:271-280)
//   fold_split<EPI=SCALE>   _kernel_depth_scale_split  (:422-438)
//
// with InT in {uint8, uint16, float} and OutT in {float, bf16} for SCALE,
// and at one pass on uint8/uint16 lines,
//
//   fold_split<EPI=PLANAR, PARTS=3>  _kernel_depth        (:261-268)
//   fold_split<EPI=SCALE,  PARTS=3>  _kernel_depth_scale  (:375-419)
//
// and behind fold_gemm_scale_concat (fold_concat.cu) the same SCALE
// instantiations, at 3 and 5 passes and at one pass on uint8/uint16 lines:
//
//   fold_split<EPI=SCALE>            _kernel_depth_scale_concat_split  (:354-372)
//   fold_split<EPI=SCALE, PARTS=3>   _kernel_depth_scale_concat        (:337-351)
//
// The one-pass rung is a float32 product.  Its float32 operator arrives
// here as three bf16 parts (two mask truncations and a rounded remainder:
// ~24 mantissa bits), and an integer sample of at most 16 bits is exactly
// x_hi + x_lo, so the terms x_hi w_2, x_hi w_1, x_hi w_0 and, where a stage
// holds a sample of 256 or more, x_lo w_1, x_lo w_0 -- those of "highest",
// the same instantiations -- give that product at float32 grade on the
// tensor cores.  What bounds it, on one H100 (H100 80GB HBM3, 700 W): at the
// main path's geometry each term is 275 GFLOP of bf16 products, so shifted
// 12-bit samples (three terms) are bound to 0.83 ms at 989 TFLOP/s, where
// the float32-FMA template is bound to 4.1 ms at 67 TFLOP/s.  float32 lines
// (samples above 16 bits, of which x_hi + x_lo keeps 16) stay on that
// template (fold_gemm.cuh, through fold_gemm.cu and fold_concat.cu): the
// caller routes by input type, and a float32 launch at one pass is refused
// here (terms()).
//
// A block's two operator halves are (W_re, n0) and (W_im, n0): 64 bins of
// re and im (COLS = BINS).  The concat kernels read one wide (n_in, 2*half)
// [W_re | W_im] part per part; the split of a concatenation is the
// concatenation of the splits (the split is elementwise), so their W_re and
// W_im are two views of that part, at W and W + half with row pitch
// 2 * half, and they compute the terms of the two-operator kernel -- at one
// pass the three parts of both views, six pointers, each checked for TMA's
// 16-byte alignment (half % 8 != 0 takes the element-wise producer).
//
// At compute_dtype="bfloat16" (passes = BF16_PASS) the same three entries
// launch the PARTS = 1 instantiations on every input type -- uint8, uint16
// and float32 lines alike, as the JAX package rounds predecoded float32
// lines too: one bf16 part per axis (the operator rounded to nearest on the
// host; for the concat entry one rounded wide part, read as its two views),
// x rounded to nearest in the kernel, one term per 64-sample stage, folded
// into the float32 sum as at every rung:
//
//   fold_split<EPI=PLANAR, PARTS=1>  _kernel_depth               (:261-268, bf16)
//   fold_split<EPI=SCALE,  PARTS=1>  _kernel_depth_scale         (:375-419, bf16)
//   fold_split<EPI=SCALE,  PARTS=1>  _kernel_depth_scale_concat  (:337-351, bf16)
//
// On one H100 (H100 80GB HBM3, 700 W) the one term is 275 GFLOP: 0.28 ms at
// 989 TFLOP/s, a third of the one-pass rung's three terms.

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

// The SCALE launch of n_terms pass terms (3 or 5).
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

// The tensor-core launches of fold_gemm_planar / fold_gemm_scale
// (fold_gemm.cu), with the same arguments: 3 or 5 passes against 2 or 3
// bf16 parts per axis, 1 pass on uint8/uint16 lines against the float32
// operator's three bf16 parts (5 terms), or BF16_PASS against one rounded
// bf16 part per axis on any input type (1 term).
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

// The tensor-core launch of fold_gemm_scale_concat (fold_concat.cu): w
// holds the 2 or 3 bf16 parts of the wide (n_in, 2 * half) operator
// [W_re | W_im] for 3 or 5 passes, at 1 pass on uint8/uint16 lines the
// three bf16 parts of the float32 wide operator (5 terms), or at BF16_PASS
// the one rounded wide part (1 term), each read as the views (W, n0) and
// (W + half, n0) at row pitch 2 * half.
int fold_split_scale_concat(const void* raw, int in_kind, int bitshift, int passes,
                            const void* const w[3], const float* mean2, void* out,
                            int out_bf16, int mode, float a, float b, long long lines,
                            int n_in, int half, void* stream) {
  const void* wim[3];
  for (int q = 0; q < 3; ++q)
    wim[q] = w[q] ? static_cast<const __nv_bfloat16*>(w[q]) + half : nullptr;
  return split::scale(split::params(raw, bitshift, w, wim, lines, n_in, half, 2 * half),
                      in_kind, split::terms(in_kind, passes, split::parts_of(w)), mean2,
                      out, out_bf16, mode, a, b, stream);
}

}  // extern "C"
