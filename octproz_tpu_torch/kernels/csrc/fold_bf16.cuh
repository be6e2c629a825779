// The one-term SCALE fold of compute_dtype="bfloat16" on Hopper (sm_90a):
// a persistent kernel written for one product term, beside the shared
// pipeline of fold_split.cuh that the three-part and split rungs run.
//
//   fold_bf16<InT, OutT>  _kernel_depth_scale         (octproz_tpu/pallas/fused_prep.py:375-419,
//                                                      call :736; bf16 operands)
//   fold_bf16<InT, OutT>  _kernel_depth_scale_concat  (:337-351, call :721; two views of the
//                                                      one rounded wide part, fold_bf16.cu)
//
// It computes what the Pallas kernels compute at compute_dtype="bfloat16":
// x decoded (>> 4 with bitshift) and rounded to nearest-even bf16 (:344,
// :401/:409), the operator rounded to bf16 on the host (:470-472), the
// product accumulated in float32, then FPN mean subtraction, p = re^2 +
// im^2, and A*log10(p)+B, A*sqrt(p)+B or A*fast_log2(p)+B stored as float32
// or bf16.  InT in {uint8, uint16, float}.
//
// What bounds it, on one H100 (H100 80GB HBM3, 700 W: 989 TFLOP/s dense
// bf16, 3.35 TB/s): at the main path's geometry (131072 lines x 1024
// samples -> 512 bins) the one term is 2 x 2 x 131072 x 1024 x 512 = 275
// GFLOP against ~0.54 GB of raw lines, operator and image: 0.278 ms of
// tensor-core work.  The shared pipeline ran it at 1.19 ms: 8192 short-lived
// blocks of 128 lines x 64 bins (62 waves and a tail), each paying its
// barrier set-up and ring fill, an epilogue in the ring's shared memory
// with no load in flight, turns built to stagger 3-5 terms, and the raw
// buffer read and decoded once per 64-bin column tile (8 times).  This
// kernel takes 0.60 ms (ab.py, same card: 46 % of the bound); per
// diagnose.py its consumers' own path (decode, barriers, epilogue: 0.22
// ms) and its wgmma groups add up rather than overlap, refills costing
// little (0.57 ms without them).
//
// Design.
// * Persistent grid: one block per SM walks the tiles t = blockIdx.x,
//   blockIdx.x + gridDim.x, ... of 128 lines x 128 bins, column tile
//   fastest, so the SMs working at one time share a few row tiles and each
//   raw tile comes from device memory once and from L2 for its other
//   column tiles.  The ring's stage counter and mbarrier phases run on
//   across tiles: the producer starts the next tile's stages while the
//   consumers finish the last one, and the ring never drains.
// * Per 64-sample stage one producer thread (its warpgroup released to 56
//   registers by setmaxnreg) starts four 64 x 64 operator boxes (re bins
//   n0..n0+63, n0+64..n0+127, then im likewise, 32 KB; a box wholly past
//   the operator's width is not loaded, its columns are never stored) and
//   the raw tile, 128 lines x 64 samples, all by TMA into swizzled rows,
//   with one arrival carrying their bytes: no address arithmetic and no
//   per-thread arrivals.  Out-of-range lines, samples and
//   columns arrive as zeros.  The raw buffer is read and decoded 4 times
//   per buffer, once per 128-bin column tile, instead of 8.  Where TMA
//   cannot describe the operator or the raw lines (the concat kernel's im
//   view at half % 8 != 0, rows not 16-byte aligned), the producer
//   warpgroup stores the same layout element by element.
// * Two consumer warpgroups (setmaxnreg up to 224) of 64 lines each decode
//   their rows of the stage's raw tile once into wgmma's A fragments (x
//   rounded to nearest bf16) and run one group of two m64n128k16 chains,
//   re and im, against the stage's boxes, wait for it and release the
//   stage; one warpgroup's decode runs under the other's group.  Tried on
//   the card and dropped: a second fragment set decoded under the group
//   (ptxas reallocated the issued wgmma's A registers: wrong lines), A
//   through shared memory instead (the stores, proxy fence and warpgroup
//   barrier per stage made it slower), turns (no gain), three consumer
//   warpgroups of 64 lines (160 registers each: spills, slower), one
//   m64n256k16 in place of the two n128 (no gain), and a 2-CTA cluster
//   sharing the operator boxes by TMA multicast (slower).
// * All of n_in runs in one wgmma chain into the float32 sums, 128 per
//   thread.  The shared pipeline folds every stage into a float32 sum
//   because its three- and five-term sums missed the planar bound in one
//   chain; for one term one chain meets the bounds (diagnose.py's
//   one_chain: scaled RMS <= 1.8e-7, max <= 1.0e-5; the magnitude's
//   relative L2 <= 1.09e-6 against 3e-6; H100, 700 W), and the fold cost
//   0.12 ms of 0.90 in the first build.
// * The epilogue runs in the registers that hold the sums: the thread that
//   holds bin j's re holds its im, subtracts the FPN mean line, forms p,
//   scales and stores straight to device memory (two neighbouring bins per
//   store: every 32-byte sector of a float32 row is written whole by one
//   warp instruction).  It uses no shared memory, so the producer refills
//   the ring with the next tile's stages meanwhile.  The scaling mode is a
//   template argument of the unrolled loop, and the log mode's log10 is
//   the special-function unit's log2 times log10(2) (scale()).
//
// Diagnostic builds (kernels/diagnose.py, -DFOLD_SPLIT_VARIANT as in
// fold_split.cuh): 2 refills no stage after the ring's first fill, 4 runs
// no wgmma, 16 skips the epilogue's arithmetic, 32 the decode -- timing
// only; 1 and 8 (one chain, no turns) change nothing here.
//
// Launch contract as in fold_split.cuh: the caller's stream, no
// allocation, no synchronisation; launch() returns cudaGetLastError() or
// the error of encoding a tensor map, raising the shared-memory limit or
// reading the SM count.  Built without --use_fast_math.

#pragma once

#include "fold_split.cuh"

namespace {
namespace bf16 {

using split::Params;

constexpr int LINES = 128;  // lines per tile: two consumer warpgroups of 64
constexpr int BINS = 128;   // bins per tile, re and im
constexpr int DEPTH = split::DEPTH;
constexpr int BOX = 64;                     // operator columns per TMA box
constexpr int B_TILE = DEPTH * BOX * 2;     // one box: 64 samples x 64 bf16 columns
constexpr int B_BYTES = 4 * B_TILE;         // re 0-63, re 64-127, im 0-63, im 64-127
constexpr int CONSUMERS = 256;              // warpgroups 0 and 1
constexpr int PRODUCERS = 128;              // warpgroup 2
constexpr int THREADS = CONSUMERS + PRODUCERS;
constexpr int SMEM_MAX = 232448;            // a block's dynamic shared memory on sm_90
constexpr int MAX_STAGES = 4;
static_assert(split::B_TILE == B_TILE, "b_desc<1> strides one box per 64 columns");

// The stage's raw tile as TMA writes it: 128 lines of 64 samples in boxes
// of ROW-byte rows (one box of 64 samples for uint8 and uint16 lines, two
// of 32 for float32 lines), each swizzled over ROW bytes (128-byte swizzle;
// 64-byte for uint8): the 16-byte chunk c of row r lands at chunk c ^ (r %
// 8) (c ^ (r / 2 % 4)), so a warp's A-fragment reads (8 lines, 4 sample
// pairs) fall into different banks.
template <typename InT>
struct Raw {
  static constexpr int ROW = sizeof(InT) == 1 ? 64 : 128;
  static constexpr int SAMPLES = ROW / static_cast<int>(sizeof(InT));  // per box row
  static constexpr int BOXES = DEPTH / SAMPLES;
  static constexpr int BOX_BYTES = LINES * ROW;
  static constexpr int BYTES = BOXES * BOX_BYTES;
  static constexpr uint32_t SWIZZLE = ROW / 16 - 1;
  // byte offset of sample k of line r in the raw tile
  __device__ static __forceinline__ uint32_t offset(int r, int k) {
    const uint32_t a = (k / SAMPLES) * BOX_BYTES + r * ROW + (k % SAMPLES) * sizeof(InT);
    return a ^ (((a >> 7) & SWIZZLE) << 4);
  }
};

template <typename InT>
struct Layout {
  static constexpr int STAGE = B_BYTES + Raw<InT>::BYTES;  // a multiple of 1024
  static constexpr int FIT = (SMEM_MAX - 1024 - 2 * MAX_STAGES * 8) / STAGE;
  static constexpr int STAGES = FIT > MAX_STAGES ? MAX_STAGES : FIT;
  static constexpr int SMEM = 1024 + STAGES * STAGE + 2 * STAGES * 8;
  static_assert(STAGE % 1024 == 0, "stages keep the 1024-byte swizzle alignment");
  static_assert(STAGES >= 2, "at least a double buffer");
};

struct Maps {
  CUtensorMap op[2];  // re, im: 64 columns x 64 samples, 128-byte swizzle
  CUtensorMap raw;    // SAMPLES x 128 lines (Raw<InT>)
};

__host__ __device__ __forceinline__ int col_tiles(const Params& p) {
  return (p.width + BINS - 1) / BINS;
}
__host__ __device__ __forceinline__ long long tiles(const Params& p) {
  return (p.lines + LINES - 1) / LINES * col_tiles(p);
}
// --- the producer warpgroup --------------------------------------------------

// With TMA one thread runs the ring: per stage two or four operator boxes
// (those inside the operator's width) and the raw tile's boxes, one
// arrival with their bytes.  Without (p.tma = 0) the whole group stores the
// same layout element by element and its thread 0 arrives.
template <typename InT>
__device__ __forceinline__ void produce(const Params& p, const Maps& maps, uint8_t* smem,
                                        uint32_t base, uint32_t full, uint32_t empty,
                                        int ptid) {
  using L = Layout<InT>;
  using R = Raw<InT>;
  using namespace split;
  if (p.tma && ptid != 0) return;
  const InT* raw = static_cast<const InT*>(p.raw);
  const int cols = bf16::col_tiles(p);
  const long long count = bf16::tiles(p);
  const int nkb = (p.n_in + DEPTH - 1) / DEPTH;
  uint32_t it = 0;  // the ring's stage counter, across tiles
  for (long long t = blockIdx.x; t < count; t += gridDim.x) {
    const long long m0 = t / cols * LINES;
    const int n0 = static_cast<int>(t % cols) * BINS;
    const bool second = n0 + BOX < p.width;  // boxes 1 and 3 lie inside the operator
    for (int kb = 0; kb < nkb; ++kb, ++it) {
      const int s = it % L::STAGES;
      mbar_wait(empty + 8 * s, ((it / L::STAGES) & 1) ^ 1);
      const uint32_t stage = base + s * L::STAGE;
      const int k0 = kb * DEPTH;
      if (NO_LOADS && it >= L::STAGES) {
        if (ptid == 0) mbar_arrive(full + 8 * s);
        continue;
      }
      if (p.tma) {
        mbar_expect_tx(full + 8 * s, (second ? B_BYTES : B_BYTES / 2) + R::BYTES);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if ((q & 1) == 0 || second)
            tma_load(stage + q * B_TILE, &maps.op[q >> 1], n0 + (q & 1) * BOX, k0,
                     full + 8 * s);
#pragma unroll
        for (int b = 0; b < R::BOXES; ++b)
          tma_load(stage + B_BYTES + b * R::BOX_BYTES, &maps.raw, k0 + b * R::SAMPLES,
                   static_cast<int>(m0), full + 8 * s);
        continue;
      }
      // The boxes as TMA would write them: column n of sample row r at
      // r*128 + ((n/8) ^ (r%8))*16 + (n%8)*2.
      uint8_t* st = smem + (stage - base);
      for (int e = ptid; e < DEPTH * BOX; e += PRODUCERS) {
        const int r = e / BOX;
        const int n = e % BOX;
        const int k = k0 + r;
        const int off = r * 128 + ((((n >> 3) ^ (r & 7)) << 4) | ((n & 7) * 2));
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = n0 + (q & 1) * BOX + n;
          const __nv_bfloat16 v = k < p.n_in && c < p.width
                                      ? p.w[q >> 1][0][static_cast<long long>(k) * p.ld + c]
                                      : __float2bfloat16_rn(0.f);
          *reinterpret_cast<__nv_bfloat16*>(st + q * B_TILE + off) = v;
        }
      }
      for (int e = ptid; e < LINES * DEPTH; e += PRODUCERS) {
        const int r = e / DEPTH;
        const int k = e % DEPTH;
        const long long line = m0 + r;
        const InT v = line < p.lines && k0 + k < p.n_in ? raw[line * p.n_in + k0 + k] : InT(0);
        *reinterpret_cast<InT*>(st + B_BYTES + R::offset(r, k)) = v;
      }
      // wgmma reads the boxes through the async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_sync(1, PRODUCERS);
      if (ptid == 0) mbar_arrive(full + 8 * s);
    }
  }
}

// --- the consumer warpgroups -------------------------------------------------

// This thread's A fragments (m64nNk16) of the stage: register i of chunk kk
// holds line row0 + 8*(i&1), samples 16*kk + 2t + 8*(i>>1) and the next
// one, decoded and rounded to nearest bf16.
template <typename InT>
__device__ __forceinline__ void fragments(const uint8_t* tile, int row0, int t, int bitshift,
                                          uint32_t (&x)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (FOLD_SPLIT_VARIANT & 32) {  // diagnostic: no decode
        x[kk][i] = 0x3F803F80u;
        continue;
      }
      float v0, v1;
      uint32_t wide = 0;
      split::load_pair<InT>(tile + Raw<InT>::offset(row0 + 8 * (i & 1), 16 * kk + 2 * t + 8 * (i >> 1)),
                            bitshift, v0, v1, wide);
      x[kk][i] = split::pack_rn(v0, v1);
    }
}

// One half's chain (re or im: its two boxes at addr) of a stage: four
// m64n128k16 over its 64 samples; the first overwrites d unless
// accumulate is set.
__device__ __forceinline__ void chain(float (&d)[64], const uint32_t (&x)[4][4], uint32_t addr,
                                      bool accumulate) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    if (!split::NO_MMA)
      split::wgmma_n128(d, x[kk], split::b_desc<1>(addr + kk * 2048), accumulate || kk > 0);
}

// The stage's wgmma group: both halves' chains from one set of fragments.
__device__ __forceinline__ void stage_group(float (&re)[64], float (&im)[64],
                                            const uint32_t (&x)[4][4], uint32_t stage,
                                            bool accumulate) {
  split::pin(re);
  split::pin(im);
  split::wgmma_fence();
  chain(re, x, stage, accumulate);
  chain(im, x, stage + 2 * B_TILE, accumulate);
  split::wgmma_commit();
  split::pin(re);
  split::pin(im);
}

template <typename OutT>
__device__ __forceinline__ void store2(OutT* out, long long o, float v0, float v1, bool both,
                                       bool pair) {
  if (pair) {
    if constexpr (sizeof(OutT) == 4) {
      *reinterpret_cast<float2*>(out + o) = make_float2(v0, v1);
    } else {
      *reinterpret_cast<__nv_bfloat162*>(out + o) = __floats2bfloat162_rn(v0, v1);
    }
  } else {
    out[o] = store_cast<OutT>(v0);
    if (both) out[o + 1] = store_cast<OutT>(v1);
  }
}

// One voxel: FPN-subtracted re and im -> p -> the scale, at mode MODE.  The
// log mode takes log2 from the special-function unit (lg2.approx, at most
// ~2^-22 absolute error) times log10(2): A*log10(p)+B to ~1e-8 display
// units of the accurate log10f at the benchmark's scale, far inside the
// bounds against the plain version, at a fraction of log10f's
// instructions (log10f made the epilogue the largest part of the
// consumers' own path).  fast_log keeps the JAX package's polynomial (_fast_log2), lin
// the IEEE square root.
template <int MODE>
__device__ __forceinline__ float scale(float re, float im, float a, float b) {
  if (FOLD_SPLIT_VARIANT & 16) return re + im;  // diagnostic: no epilogue math
  const float pw = re * re + im * im;
  if constexpr (MODE == MODE_LOG) return a * __log2f(pw) + b;
  if constexpr (MODE == MODE_LIN) return a * sqrtf(pw) + b;
  return a * fast_log2(pw) + b;
}

// The tile's epilogue from the sums in registers (wgmma's n128 layout: re[4j
// + i] and im[4j + i] are line line0 + 8 * (i >> 1), bin n0 + 8j + 2t + (i &
// 1)); a is A*log10(2) for the log modes.
template <int MODE, typename OutT>
__device__ __forceinline__ void epilogue(const Params& p, const float (&re)[64],
                                         const float (&im)[64], long long line0, int n0,
                                         int t, float a) {
  const int half = p.width;
  OutT* const out = static_cast<OutT*>(p.out);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int bin = n0 + 8 * j + 2 * t;
    if (bin >= half) continue;
    const bool both = bin + 1 < half;
    const bool pair = both && (half & 1) == 0;  // 2-element aligned: a vector store
    const float mr0 = p.mean2[bin], mi0 = p.mean2[half + bin];
    const float mr1 = both ? p.mean2[bin + 1] : 0.f;
    const float mi1 = both ? p.mean2[half + bin + 1] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long line = line0 + 8 * h;
      if (line >= p.lines) continue;
      const int i = 4 * j + 2 * h;
      store2(out, line * half + bin, scale<MODE>(re[i] - mr0, im[i] - mi0, a, p.b),
             scale<MODE>(re[i + 1] - mr1, im[i + 1] - mi1, a, p.b), both, pair);
    }
  }
}

template <typename OutT>
__device__ __forceinline__ void epilogue(const Params& p, const float (&re)[64],
                                         const float (&im)[64], long long line0, int n0,
                                         int t) {
  if (p.mode == MODE_LOG)
    epilogue<MODE_LOG, OutT>(p, re, im, line0, n0, t, p.a * 0.30102999566398120f);
  else if (p.mode == MODE_LIN)
    epilogue<MODE_LIN, OutT>(p, re, im, line0, n0, t, p.a);
  else
    epilogue<MODE_FAST_LOG, OutT>(p, re, im, line0, n0, t, p.a);
}

// A consumer warpgroup: 64 lines of every tile of the block, one stage's
// group on the tensor cores at a time (the other warpgroup's runs while
// this one decodes).  Stage k + 1's fragments are not decoded under stage
// k's group: ptxas reallocates the registers of an issued wgmma's A
// fragments, and a second fragment set decoded while the group ran was
// found overwriting the first on the card (lines 16-23, 32-39 and 48-55 of
// every 64 wrong).
template <typename InT, typename OutT>
__device__ __forceinline__ void consume(const Params& p, const uint8_t* smem, uint32_t base,
                                        uint32_t full, uint32_t empty, int ctid) {
  using L = Layout<InT>;
  using namespace split;
  const int warp = ctid / 32;
  const int lane = ctid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int row0 = warp * 16 + g;  // this thread's tile rows: row0, row0 + 8
  const int cols = bf16::col_tiles(p);
  const long long count = bf16::tiles(p);
  const int nkb = (p.n_in + DEPTH - 1) / DEPTH;
  uint32_t it = 0;
  for (long long tl = blockIdx.x; tl < count; tl += gridDim.x) {
    const long long m0 = tl / cols * LINES;
    const int n0 = static_cast<int>(tl % cols) * BINS;
    float re[64], im[64];  // bins n0 .. n0 + 127 of lines row0 and row0 + 8
    for (int kb = 0; kb < nkb; ++kb, ++it) {
      const int s = it % L::STAGES;
      mbar_wait(full + 8 * s, (it / L::STAGES) & 1);
      uint32_t x[4][4];
      fragments<InT>(smem + s * L::STAGE + B_BYTES, row0, t, p.bitshift, x);
      stage_group(re, im, x, base + s * L::STAGE, kb > 0);
      wgmma_wait_all();
      pin(re);
      pin(im);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }
    epilogue<OutT>(p, re, im, m0 + row0, n0, t);
  }
}

// --- the kernel ----------------------------------------------------------------

template <typename InT, typename OutT>
__global__ void __launch_bounds__(THREADS, 1)
    fold_bf16(const __grid_constant__ Params p, const __grid_constant__ Maps maps) {
  using L = Layout<InT>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = split::smem_u32(smem_raw);
  const uint32_t base = (raw_addr + 1023u) & ~1023u;
  uint8_t* const smem = smem_raw + (base - raw_addr);
  const uint32_t full = base + L::STAGES * L::STAGE;  // one mbarrier per stage
  const uint32_t empty = full + 8 * L::STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      split::mbar_init(full + 8 * s, 1);  // the producer's one arrival (with the bytes)
      split::mbar_init(empty + 8 * s, CONSUMERS / 32);  // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // One if-else for the whole kernel: the two roles never meet again, so
  // ptxas can honour setmaxnreg.
  if (threadIdx.x >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    produce<InT>(p, maps, smem, base, full, empty, threadIdx.x - CONSUMERS);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
    consume<InT, OutT>(p, smem, base, full, empty, threadIdx.x);
  }
}

// --- host side ---------------------------------------------------------------

// The SMs of the current device, read once per device.
inline int sm_count(int* count) {
  static int cached[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 64 && cached[dev] > 0) {
    *count = cached[dev];
    return 0;
  }
  e = cudaDeviceGetAttribute(count, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 64) cached[dev] = *count;
  return 0;
}

// The tensor maps: the two operator views as fold_split.cuh encodes them,
// and the raw lines (n_in samples x lines, Raw<InT>'s box and swizzle).
template <typename InT>
int encode(const Params& p, Maps* maps) {
  split::Maps m = {};
  const int rc = split::encode_maps(p, 2, 1, &m);  // checks the encoder too
  if (rc != 0) return rc;
  maps->op[0] = m.m[0][0];
  maps->op[1] = m.m[1][0];
  using R = Raw<InT>;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(p.n_in), static_cast<cuuint64_t>(p.lines)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(p.n_in) * sizeof(InT)};
  const cuuint32_t box[2] = {R::SAMPLES, LINES};
  const cuuint32_t unit[2] = {1, 1};
  const CUtensorMapDataType type = sizeof(InT) == 1   ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                   : sizeof(InT) == 2 ? CU_TENSOR_MAP_DATA_TYPE_UINT16
                                                      : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const CUresult r = split::encoder()(
      &maps->raw, type, 2, const_cast<void*>(p.raw), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      sizeof(InT) == 1 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The checks, tensor maps and launch of fold_bf16<InT, OutT>: one block per
// SM, or one per tile where there are fewer tiles.
template <typename InT, typename OutT>
int launch(Params p, cudaStream_t stream) {
  using Kernel = void (*)(Params, Maps);
  if (p.lines <= 0 || p.width <= 0 || p.n_in <= 0) return 0;
  const Kernel kernel = fold_bf16<InT, OutT>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<InT>::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  bool tma = p.ld % 8 == 0 && (static_cast<long long>(p.n_in) * sizeof(InT)) % 16 == 0 &&
             split::aligned16(p.raw) && split::aligned16(p.w[0][0]) &&
             split::aligned16(p.w[1][0]);
  Maps maps = {};
  if (tma) {
    const int rc = encode<InT>(p, &maps);
    if (rc != 0) return rc;
  }
  p.tma = tma ? 1 : 0;
  int sms = 0;
  const int rc = sm_count(&sms);
  if (rc != 0) return rc;
  const long long count = tiles(p);
  const long long grid = count < sms ? count : sms;
  fold_bf16<InT, OutT><<<static_cast<unsigned>(grid), THREADS, Layout<InT>::SMEM, stream>>>(
      p, maps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bf16
}  // namespace
