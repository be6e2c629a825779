// The prep kernels of compute_dtype="bfloat16" on the one-term kernel of
// fold_bf16.cuh (its design notes there), behind prep_gemm_phase and
// prep_gemm_real (prep_gemm.cu) at passes = BF16_PASS, on every input
// type:
//
//   one_term<InT, Prep<PHASE>>  _kernel_phase  (octproz_tpu/pallas/fused_prep.py:228-235, call :535)
//   one_term<InT, Prep<REAL>>   _kernel_real   (:238-242, call :551)
//
// with InT in {uint8, uint16, float}: x decoded and rounded to nearest bf16,
// the operator P rounded to one bf16 part on the host, one float32 product
// y = x @ P, then (y cos, y sin) interleaved into the complex64 tensor that
// torch.fft reads (PHASE) or y as float32 (REAL).  A tile is 128 lines x
// 256 columns of P: the four boxes of a stage are columns n0, n0 + 64,
// n0 + 128 and n0 + 192, chain 0 holds n0 .. n0 + 127 and chain 1
// n0 + 128 .. n0 + 255 -- the fold kernel's 128 float32 sums a thread, 32
// KB of operator a stage and raw tile; at n_out = 1024 the raw buffer is
// read and decoded 4 times instead of 8.
//
// What bounds it, on one H100 (H100 80GB HBM3, 700 W): at 131072 lines x
// 1024 samples -> 1024 columns the one term is 275 GFLOP (0.278 ms at 989
// TFLOP/s); PHASE moves 0.27 GB of raw lines in and 1.07 GB of complex64
// out, 0.401 ms at 3.35 TB/s -- bound by its bytes; REAL's 0.54 GB of
// float32 out leaves it bound by its operations.  A tile's complex64 stores
// (256 KB) take as long as its products at one SM's share of the memory
// rate, so the epilogue issues them straight from the registers and goes
// on to the next tile's stages, which the producer has been loading: the
// stores drain under that tile's wgmma.  Tried on the card against this
// cooperative schedule and dropped, both slower for B7: a ping-pong
// schedule (each consumer warpgroup its own 64-line tiles, ring and
// producer warp, the mainloops in turns: 1.7x the L2 -> shared
// memory traffic), and the epilogue through shared-memory staging buffers
// and TMA stores (a ring of 3 stages; at most its buffers in flight under
// the next tile).  The complex64 stores carry the evict-first hint
// (st.global.cs): 1.07 GB of spectra streaming through L2 would otherwise
// push out the operator and raw lines that the next tiles read (3 % on
// B7; on B8's float32 y the hint did not help).  Operator boxes loaded
// with an evict-last policy gained nothing.
//
// The epilogue, from the sums in registers (wgmma's n128 layout: d[4j + i]
// is line line0 + 8 * (i >> 1), column c0 + 8j + 2t + (i & 1)): a thread
// holds two neighbouring columns of a line, and PHASE writes (y0 cos0,
// y0 sin0, y1 cos1, y1 sin1) as one 16-byte store, REAL (y0, y1) as one
// 8-byte store -- every 32-byte sector written whole by one warp
// instruction.  The phasor rows come from shared memory, (cos, sin) per
// column put there once per block beside the ring (8 KB at n_out = 1024;
// from device memory where 8 * n_out bytes do not fit).  Where a column
// pair is not aligned for the vector store (n_out odd) or runs past n_out,
// the columns are stored one by one.  A launch with other than one bf16
// part is refused.

#include "fold_bf16.cuh"

namespace {
namespace bf16 {

template <int EPI>
struct Prep {
  static constexpr int COLS = 4 * BOX;  // operator columns per tile
  static constexpr int MAPS = 1;        // P
  // box q: columns n0 + 64 q of P
  __host__ __device__ static constexpr int map(int) { return 0; }
  __host__ __device__ static constexpr int offset(int q) { return q * BOX; }

  // The phasor rows fit beside the ring: 8 bytes a column.
  template <typename InT>
  __host__ __device__ static bool in_smem(int width) {
    return EPI == PHASE && Layout<InT>::SMEM + 8LL * width <= SMEM_MAX;
  }
  template <typename InT>
  static int extra(const Params& p) {
    return in_smem<InT>(p.width) ? 8 * p.width : 0;
  }

  // The consumers put (cos, sin) of every column into the extra bytes;
  // returns them, or nullptr where they stay in device memory.
  template <typename InT>
  __device__ static const float2* prepare(const Params& p, uint8_t* extra, int ctid) {
    if (!in_smem<InT>(p.width)) return nullptr;
    float2* const ph = reinterpret_cast<float2*>(extra);
    for (int c = ctid; c < p.width; c += CONSUMERS)
      ph[c] = make_float2(p.cos_row[c], p.sin_row[c]);
    split::named_sync(2, CONSUMERS);
    return ph;
  }

  // cos and sin of columns col and col + 1 (zeros past the width).
  __device__ static float4 phasor(const Params& p, const float2* ph, int col) {
    float4 cs = make_float4(0.f, 0.f, 0.f, 0.f);
    if (EPI != PHASE || col >= p.width) return cs;
    const bool both = col + 1 < p.width;
    if (ph != nullptr && both) return *reinterpret_cast<const float4*>(ph + col);
    if (ph != nullptr) return make_float4(ph[col].x, ph[col].y, 0.f, 0.f);
    cs.x = __ldg(p.cos_row + col);
    cs.y = __ldg(p.sin_row + col);
    cs.z = both ? __ldg(p.cos_row + col + 1) : 0.f;
    cs.w = both ? __ldg(p.sin_row + col + 1) : 0.f;
    return cs;
  }

  // One chain's 128 columns c0 .. c0 + 127 of lines line0 and line0 + 8.
  __device__ static void columns(const Params& p, const float2* ph, const float (&d)[64],
                                 long long line0, int c0, int t) {
    const int w = p.width;
    float* const out = static_cast<float*>(p.out);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = c0 + 8 * j + 2 * t;
      if (col >= w) continue;
      const bool both = col + 1 < w;
      const bool pair = both && (w & 1) == 0;  // an even element offset: a vector store
      const float4 cs = phasor(p, ph, col);  // cos, sin of col and col + 1
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long line = line0 + 8 * h;
        if (line >= p.lines) continue;
        const float y0 = d[4 * j + 2 * h];
        const float y1 = d[4 * j + 2 * h + 1];
        const long long o = line * w + col;
        if constexpr (EPI == PHASE) {
          const float4 v = make_float4(y0 * cs.x, y0 * cs.y, y1 * cs.z, y1 * cs.w);
          if (!keep(v.x + v.y + v.z + v.w)) continue;
          if (pair) {
            __stcs(reinterpret_cast<float4*>(out + 2 * o), v);  // evict first
          } else {
            *reinterpret_cast<float2*>(out + 2 * o) = make_float2(v.x, v.y);
            if (both) *reinterpret_cast<float2*>(out + 2 * o + 2) = make_float2(v.z, v.w);
          }
        } else {
          if (!keep(y0 + y1)) continue;
          if (pair) {
            *reinterpret_cast<float2*>(out + o) = make_float2(y0, y1);
          } else {
            out[o] = y0;
            if (both) out[o + 1] = y1;
          }
        }
      }
    }
  }

  __device__ static void store(const Params& p, const float2* ph, const float (&d0)[64],
                               const float (&d1)[64], long long line0, int n0, int t) {
    columns(p, ph, d0, line0, n0, t);
    columns(p, ph, d1, line0, n0 + 2 * BOX, t);
  }
};

template <int EPI>
int prep(const void* raw, int in_kind, int bitshift, const void* w, const float* cos_row,
         const float* sin_row, void* out, long long lines, int n_in, int n_out, void* stream) {
  Params p = {};
  p.raw = raw;
  p.w[0][0] = static_cast<const __nv_bfloat16*>(w);
  p.cos_row = cos_row;
  p.sin_row = sin_row;
  p.out = out;
  p.lines = lines;
  p.n_in = n_in;
  p.width = n_out;
  p.ld = n_out;
  p.bitshift = bitshift;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_kind) {
    case IN_U8: return launch<uint8_t, Prep<EPI>>(p, s);
    case IN_U16: return launch<uint16_t, Prep<EPI>>(p, s);
    case IN_FLOAT: return launch<float, Prep<EPI>>(p, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace bf16
}  // namespace

extern "C" {

// prep_gemm_phase at BF16_PASS: the one rounded bf16 part of P in w[0]
// (the others NULL); out: complex64 (lines, n_out) as interleaved floats.
int prep_bf16_phase(const void* raw, int in_kind, int bitshift, const void* const w[3],
                    const float* cos_row, const float* sin_row, void* out, long long lines,
                    int n_in, int n_out, void* stream) {
  if (split::parts_of(w) != 1) return static_cast<int>(cudaErrorInvalidValue);
  return bf16::prep<PHASE>(raw, in_kind, bitshift, w[0], cos_row, sin_row, out, lines, n_in,
                           n_out, stream);
}

// prep_gemm_real at BF16_PASS; out: float32 (lines, n_out).
int prep_bf16_real(const void* raw, int in_kind, int bitshift, const void* const w[3],
                   void* out, long long lines, int n_in, int n_out, void* stream) {
  if (split::parts_of(w) != 1) return static_cast<int>(cudaErrorInvalidValue);
  return bf16::prep<REAL>(raw, in_kind, bitshift, w[0], nullptr, nullptr, out, lines, n_in,
                          n_out, stream);
}

}  // extern "C"
