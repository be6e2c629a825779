// The prep kernels on Hopper's bf16 tensor cores (sm_90a): stages 1-3 of
// the FFT path -- decode, the pass terms of _dot_split for y = x @ P
// against bf16 operator parts, then the phasor epilogue (y cos, y sin) into
// complex64 or a float32 y -- at every rung on uint8/uint16 lines.  The
// counterparts of
//
//   prep_split<EPI=PHASE>            _kernel_phase_split  (octproz_tpu/pallas/fused_prep.py:245-251)
//   prep_split<EPI=REAL>             _kernel_real_split   (:254-258)
//   prep_split<EPI=PHASE, PARTS=3>   _kernel_phase        (:228-235, integer lines)
//   prep_split<EPI=REAL,  PARTS=3>   _kernel_real         (:238-242, integer lines)
//
// with InT in {uint8, uint16, float}, launched by prep_gemm_phase and
// prep_gemm_real (prep_gemm.cu) at passes != 1, and by both at one pass for
// uint8/uint16 lines.  At one pass the float32 operator arrives as its three
// bf16 parts and the launch runs the five terms of "highest" (terms() in
// fold_split.cuh): the float32 product at float32 grade for samples of at
// most 16 bits.  float32 lines (samples above 16 bits) keep the float32-FMA
// kernel of prep_gemm.cu at one pass; the input type alone picks the route,
// and a float32 launch at one pass is refused here.  At
// compute_dtype="bfloat16" (passes = BF16_PASS) both entries launch the
// PARTS = 1 instantiations on every input type: the operator rounded to
// one bf16 part on the host, x rounded to nearest in the kernel, one term,
//
//   prep_split<EPI=PHASE, PARTS=1>   _kernel_phase        (:228-235, bf16)
//   prep_split<EPI=REAL,  PARTS=1>   _kernel_real         (:238-242, bf16)
//
// bound on one H100 (H100 80GB HBM3, 700 W) by its store more than its one
// 275 GFLOP term (0.28 ms): 1.07 GB of complex64 out, 0.40 ms at 3.35
// TB/s, for the phase kernel; 0.28 ms of operations for the real one.
//
// What bounds it, on one H100 (H100 80GB HBM3, 700 W: 989 TFLOP/s of dense
// bf16, 3.35 TB/s): at the FFT path's geometry (131072 lines x 1024 samples
// -> 1024 columns, shifted 12-bit samples, x_lo zero) the x_hi terms are
// 275 GFLOP of bf16 products each -- two at "high", 0.56 ms; three at one
// pass, 0.83 ms (five with x_lo, 1.39 ms), where the float32-FMA kernel is
// bound to 4.1 ms at 67 TFLOP/s -- against 0.27 GB in and 1.07 GB (complex64)
// or 0.54 GB (float32) out, 0.40 / 0.24 ms: compute bound, with a store
// large enough to matter.
//
// Design: the pipeline of fold_split.cuh (mainloop: TMA ring of operator
// parts, x decoded and split into wgmma's register operand, one
// m64n128k16 per part and 16 samples, the float32 fold every 64-sample
// stage, the x_lo vote) with one operator: a block owns 128 lines x 128
// columns of P, its two 64-column halves the pairs (P, n0) and
// (P, n0 + 64) of one tensor map -- at 131072 x 1024 -> 1024 the fold
// kernels' 8192 blocks.
// The epilogue stages the sums in shared memory (stage_sums) and each warp
// writes its 16 lines with one lane per column: one float2 (y cos, y sin)
// per lane, a whole 256-byte line per warp store, straight into the
// complex64 tensor that torch.fft reads (or a 128-byte line of float32 y).

#include "fold_split.cuh"

namespace {
namespace split {

constexpr int COLS = 2 * BINS;  // operator columns per block: the halves (P, n0), (P, n0 + 64)

template <typename InT, int PARTS, int EPI>
__global__ void __launch_bounds__(THREADS, 1)
    prep_split(const __grid_constant__ Params p, const __grid_constant__ Maps maps) {
  extern __shared__ uint8_t smem_raw[];
  const Block blk = block_of<COLS>(p, smem_raw);
  float acc[64];  // columns n0 .. n0 + 63 in 0-31, n0 + 64 .. n0 + 127 in 32-63
  if (!mainloop<InT, PARTS, COLS>(p, maps, blk.smem, blk.m0, blk.n0, acc)) return;

  const float* const tile = stage_sums(blk.smem, acc);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // column n0 + 32h + lane is staged at (h / 2) * 16 * EPI_ROW + 32 * (h % 2) + lane
  float cs[4], sn[4];
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const int col = blk.n0 + 32 * h + lane;
    const bool in = EPI == PHASE && col < p.width;
    cs[h] = in ? p.cos_row[col] : 0.f;
    sn[h] = in ? p.sin_row[col] : 0.f;
  }
  const long long line0 = blk.m0 + warp * 16;
#pragma unroll 4
  for (int rr = 0; rr < 16; ++rr) {
    const long long line = line0 + rr;
    if (line >= p.lines) break;
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int col = blk.n0 + 32 * h + lane;
      if (col >= p.width) continue;
      const float y = tile[(h >> 1) * 16 * EPI_ROW + rr * EPI_ROW + 32 * (h & 1) + lane];
      const long long o = line * p.width + col;
      if constexpr (EPI == PHASE)
        static_cast<float2*>(p.out)[o] = make_float2(y * cs[h], y * sn[h]);
      else
        static_cast<float*>(p.out)[o] = y;
    }
  }
}

template <int EPI>
struct Prep {
  template <typename InT, int PARTS>
  struct K {
    static int run(const Params& p, cudaStream_t stream) {
      const Kernel kernel = prep_split<InT, PARTS, EPI>;
      static const cudaError_t attr = opt_in<InT, PARTS>(kernel);
      return launch<InT, PARTS, COLS>(p, kernel, attr, stream);
    }
  };
};

Params params(const void* raw, int bitshift, const void* const w[3], void* out,
              long long lines, int n_in, int n_out) {
  Params p = {};
  p.raw = raw;
  for (int q = 0; q < 3; ++q) p.w[0][q] = static_cast<const __nv_bfloat16*>(w[q]);
  p.out = out;
  p.lines = lines;
  p.n_in = n_in;
  p.width = n_out;
  p.ld = n_out;
  p.bitshift = bitshift;
  return p;
}

}  // namespace split
}  // namespace

extern "C" {

// The tensor-core launches of prep_gemm_phase / prep_gemm_real
// (prep_gemm.cu): w holds the operator's 2 or 3 bf16 parts, (n_in, n_out)
// row-major, for 3 or 5 passes; at 1 pass on uint8/uint16 lines the float32
// operator's three bf16 parts (5 terms); at BF16_PASS its one rounded bf16
// part, on any input type (1 term).
int prep_split_phase(const void* raw, int in_kind, int bitshift, int passes,
                     const void* const w[3], const float* cos_row, const float* sin_row,
                     void* out, long long lines, int n_in, int n_out, void* stream) {
  split::Params p = split::params(raw, bitshift, w, out, lines, n_in, n_out);
  p.cos_row = cos_row;
  p.sin_row = sin_row;
  return split::dispatch<split::Prep<PHASE>::K>(
      in_kind, split::terms(in_kind, passes, split::parts_of(w)), p,
      static_cast<cudaStream_t>(stream));
}

int prep_split_real(const void* raw, int in_kind, int bitshift, int passes,
                    const void* const w[3], void* out, long long lines, int n_in, int n_out,
                    void* stream) {
  split::Params p = split::params(raw, bitshift, w, out, lines, n_in, n_out);
  return split::dispatch<split::Prep<REAL>::K>(
      in_kind, split::terms(in_kind, passes, split::parts_of(w)), p,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
