// The one-term kernel of compute_dtype="bfloat16" on Hopper (sm_90a): a
// persistent kernel written for one product term, beside the shared
// pipeline of fold_split.cuh that the three-part and split rungs run.  This
// header holds its producer, consumer mainloop and host side, templated on
// the epilogue; fold_bf16.cu instantiates the scaled fold's, prep_bf16.cu
// the prep families':
//
//   one_term<InT, Scale<OutT>>   _kernel_depth_scale         (octproz_tpu/pallas/fused_prep.py:375-419,
//                                                             call :736; fold_bf16.cu)
//   one_term<InT, Scale<OutT>>   _kernel_depth_scale_concat  (:337-351, call :721; two views of
//                                                             the one rounded wide part)
//   one_term<InT, Prep<PHASE>>   _kernel_phase               (:228-235, call :535; prep_bf16.cu)
//   one_term<InT, Prep<REAL>>    _kernel_real                (:238-242, call :551; prep_bf16.cu)
//
// It computes what the Pallas kernels compute at compute_dtype="bfloat16":
// x decoded (>> 4 with bitshift) and rounded to nearest-even bf16 (:231,
// :240, :344, :401/:409), the operator rounded to bf16 on the host
// (:470-472), the product accumulated in float32, then the epilogue: FPN
// mean subtraction, p = re^2 + im^2 and the dynamic-range scale (Scale), or
// (y cos, y sin) into complex64 (PHASE) or float32 y (REAL).  InT in
// {uint8, uint16, float}.
//
// What bounds it, on one H100 (H100 80GB HBM3, 700 W: 989 TFLOP/s dense
// bf16, 3.35 TB/s): at the main path's geometry (131072 lines x 1024
// samples -> 512 bins re and im, or 1024 prep columns) the one term is 275
// GFLOP, 0.278 ms of tensor-core work, against ~0.54 GB of raw lines,
// operator and image for the scaled fold and the float32 y of REAL, but
// 1.34 GB for PHASE's complex64: 0.401 ms of bytes.  The shared pipeline
// ran these at 1.0-1.19 ms: 8192 short-lived blocks (62 waves and a tail),
// each paying its barrier set-up and ring fill, an epilogue in the ring's
// shared memory with no load in flight, and the raw buffer read and decoded
// once per column tile (8 times).
//
// Design.
// * Persistent grid: one block per SM walks the tiles t = blockIdx.x,
//   blockIdx.x + gridDim.x, ... of 128 lines x Epilogue::COLS output
//   columns (128 bins of the fold, 256 prep columns), column tile fastest,
//   so the SMs working at one time share a few row tiles and each raw tile
//   comes from device memory once and from L2 for its other column tiles.
//   The ring's stage counter and mbarrier phases run on across tiles: the
//   producer starts the next tile's stages while the consumers finish the
//   last one, and the ring never drains.
// * Per 64-sample stage one producer thread (its warpgroup released to 56
//   registers by setmaxnreg) starts four 64 x 64 operator boxes (32 KB;
//   Epilogue::map/offset place box q: the fold's re bins n0..n0+63,
//   n0+64..n0+127, then im likewise; the prep operator's columns n0 + 64 q;
//   a box wholly past the operator's width is not loaded, its columns are
//   never stored) and the raw tile, 128 lines x 64 samples, all by TMA into
//   swizzled rows, with one arrival carrying their bytes: no address
//   arithmetic and no per-thread arrivals.  Out-of-range lines, samples and
//   columns arrive as zeros.  At 1024 samples -> 512 bins or 1024 columns
//   the raw buffer is read and decoded 4 times, once per column tile,
//   instead of 8.  Where TMA cannot describe the operator or the raw lines
//   (the concat kernel's im view at half % 8 != 0, a row pitch not a
//   multiple of 8, rows not 16-byte aligned), the producer warpgroup stores
//   the same layout element by element.
// * Two consumer warpgroups (setmaxnreg up to 224) of 64 lines each decode
//   their rows of the stage's raw tile once into wgmma's A fragments (x
//   rounded to nearest bf16) and run one group of two m64n128k16 chains
//   (boxes 0-1 and 2-3) against the stage, wait for it and release the
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
// * The epilogue runs in the registers that hold the sums (Epilogue::store:
//   sums d0 and d1 of chains 0 and 1, wgmma's n128 layout) and stores
//   straight to device memory, every 32-byte sector written whole by one
//   warp instruction.  It uses no shared memory of the ring, so the
//   producer refills the ring with the next tile's stages meanwhile.  What
//   it reads besides the sums (the phasor rows of PHASE) the consumers put
//   in shared memory beside the ring once per block (Epilogue::prepare).
//
// Diagnostic builds (kernels/diagnose.py, -DFOLD_SPLIT_VARIANT as in
// fold_split.cuh): 2 refills no stage after the ring's first fill, 4 runs
// no wgmma, 16 skips the scaled fold's epilogue arithmetic, 32 the decode,
// 64 the stores (their values still computed) -- timing only; 1 and 8 (one
// chain, no turns) change nothing here.
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
constexpr int DEPTH = split::DEPTH;
constexpr int BOX = 64;                     // operator columns per TMA box
constexpr int B_TILE = DEPTH * BOX * 2;     // one box: 64 samples x 64 bf16 columns
constexpr int B_BYTES = 4 * B_TILE;         // the stage's four boxes
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

// The ring: STAGES stages, then a full and an empty mbarrier per stage,
// then what the epilogue keeps in shared memory (its extra bytes).
template <typename InT>
struct Layout {
  static constexpr int STAGE = B_BYTES + Raw<InT>::BYTES;  // a multiple of 1024
  static constexpr int FIT = (SMEM_MAX - 1024 - 2 * MAX_STAGES * 8) / STAGE;
  static constexpr int STAGES = FIT > MAX_STAGES ? MAX_STAGES : FIT;
  static constexpr int EXTRA = STAGES * STAGE + 2 * STAGES * 8;  // from the aligned base
  static constexpr int SMEM = 1024 + EXTRA;
  static_assert(STAGE % 1024 == 0, "stages keep the 1024-byte swizzle alignment");
  static_assert(STAGES >= 2, "at least a double buffer");
};

struct Maps {
  CUtensorMap op[2];  // Epilogue::map 0 and 1: 64 columns x 64 samples, 128-byte swizzle
  CUtensorMap raw;    // SAMPLES x 128 lines (Raw<InT>)
};

template <class Epilogue>
__host__ __device__ __forceinline__ int col_tiles(const Params& p) {
  return (p.width + Epilogue::COLS - 1) / Epilogue::COLS;
}
template <class Epilogue>
__host__ __device__ __forceinline__ long long tiles(const Params& p) {
  return (p.lines + LINES - 1) / LINES * col_tiles<Epilogue>(p);
}

// Diagnostic (FOLD_SPLIT_VARIANT & 64): false for every value, so the
// store is skipped but the value computed; true otherwise.
__device__ __forceinline__ bool keep(float v) {
  return !split::NO_STORES || __float_as_uint(v) == 0x7FBADBADu;
}

// --- the producer warpgroup --------------------------------------------------

// With TMA one thread runs the ring: per stage the operator boxes inside
// the operator's width and the raw tile's boxes, one arrival with their
// bytes.  Without (p.tma = 0) the whole group stores the same layout
// element by element and its thread 0 arrives.
template <typename InT, class Epilogue>
__device__ __forceinline__ void produce(const Params& p, const Maps& maps, uint8_t* smem,
                                        uint32_t base, uint32_t full, uint32_t empty,
                                        int ptid) {
  using L = Layout<InT>;
  using R = Raw<InT>;
  using E = Epilogue;
  using namespace split;
  if (p.tma && ptid != 0) return;
  const InT* raw = static_cast<const InT*>(p.raw);
  const int cols = bf16::col_tiles<E>(p);
  const long long count = bf16::tiles<E>(p);
  const int nkb = (p.n_in + DEPTH - 1) / DEPTH;
  uint32_t it = 0;  // the ring's stage counter, across tiles
  for (long long t = blockIdx.x; t < count; t += gridDim.x) {
    const long long m0 = t / cols * LINES;
    const int n0 = static_cast<int>(t % cols) * E::COLS;
    int boxes = 0;  // the boxes inside the operator (box 0 always is)
#pragma unroll
    for (int q = 0; q < 4; ++q) boxes += n0 + E::offset(q) < p.width;
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
        mbar_expect_tx(full + 8 * s, boxes * B_TILE + R::BYTES);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (n0 + E::offset(q) < p.width)
            tma_load(stage + q * B_TILE, &maps.op[E::map(q)], n0 + E::offset(q), k0,
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
          const int c = n0 + E::offset(q) + n;
          const __nv_bfloat16 v = k < p.n_in && c < p.width
                                      ? p.w[E::map(q)][0][static_cast<long long>(k) * p.ld + c]
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

// One chain (two boxes at addr: 128 columns) of a stage: four m64n128k16
// over its 64 samples; the first overwrites d unless accumulate is set.
__device__ __forceinline__ void chain(float (&d)[64], const uint32_t (&x)[4][4], uint32_t addr,
                                      bool accumulate) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    if (!split::NO_MMA)
      split::wgmma_n128(d, x[kk], split::b_desc<1>(addr + kk * 2048), accumulate || kk > 0);
}

// The stage's wgmma group: both chains (boxes 0-1 into d0, 2-3 into d1)
// from one set of fragments.
__device__ __forceinline__ void stage_group(float (&d0)[64], float (&d1)[64],
                                            const uint32_t (&x)[4][4], uint32_t stage,
                                            bool accumulate) {
  split::pin(d0);
  split::pin(d1);
  split::wgmma_fence();
  chain(d0, x, stage, accumulate);
  chain(d1, x, stage + 2 * B_TILE, accumulate);
  split::wgmma_commit();
  split::pin(d0);
  split::pin(d1);
}

// A consumer warpgroup: 64 lines of every tile of the block, one stage's
// group on the tensor cores at a time (the other warpgroup's runs while
// this one decodes).  Stage k + 1's fragments are not decoded under stage
// k's group: ptxas reallocates the registers of an issued wgmma's A
// fragments, and a second fragment set decoded while the group ran was
// found overwriting the first on the card (lines 16-23, 32-39 and 48-55 of
// every 64 wrong).
template <typename InT, class Epilogue>
__device__ __forceinline__ void consume(const Params& p, uint8_t* smem, uint32_t base,
                                        uint32_t full, uint32_t empty, int ctid) {
  using L = Layout<InT>;
  using E = Epilogue;
  using namespace split;
  const int warp = ctid / 32;
  const int lane = ctid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int row0 = warp * 16 + g;  // this thread's tile rows: row0, row0 + 8
  const int cols = bf16::col_tiles<E>(p);
  const long long count = bf16::tiles<E>(p);
  const int nkb = (p.n_in + DEPTH - 1) / DEPTH;
  const auto ctx = E::template prepare<InT>(p, smem + L::EXTRA, ctid);
  uint32_t it = 0;
  for (long long tl = blockIdx.x; tl < count; tl += gridDim.x) {
    const long long m0 = tl / cols * LINES;
    const int n0 = static_cast<int>(tl % cols) * E::COLS;
    float d0[64], d1[64];  // chains 0 and 1 of lines row0 and row0 + 8
    for (int kb = 0; kb < nkb; ++kb, ++it) {
      const int s = it % L::STAGES;
      mbar_wait(full + 8 * s, (it / L::STAGES) & 1);
      uint32_t x[4][4];
      fragments<InT>(smem + s * L::STAGE + B_BYTES, row0, t, p.bitshift, x);
      stage_group(d0, d1, x, base + s * L::STAGE, kb > 0);
      wgmma_wait_all();
      pin(d0);
      pin(d1);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }
    E::store(p, ctx, d0, d1, m0 + row0, n0, t);
  }
}

// --- the kernel ----------------------------------------------------------------

template <typename InT, class Epilogue>
__global__ void __launch_bounds__(THREADS, 1)
    one_term(const __grid_constant__ Params p, const __grid_constant__ Maps maps) {
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
    produce<InT, Epilogue>(p, maps, smem, base, full, empty, threadIdx.x - CONSUMERS);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
    consume<InT, Epilogue>(p, smem, base, full, empty, threadIdx.x);
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

// The tensor maps: the operator's MAPS views as fold_split.cuh encodes them,
// and the raw lines (n_in samples x lines, Raw<InT>'s box and swizzle).
template <typename InT, int MAPS>
int encode(const Params& p, Maps* maps) {
  split::Maps m = {};
  const int rc = split::encode_maps(p, MAPS, 1, &m);  // checks the encoder too
  if (rc != 0) return rc;
  for (int c = 0; c < MAPS; ++c) maps->op[c] = m.m[c][0];
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

// The checks, tensor maps and launch of one_term<InT, Epilogue>: one block
// per SM, or one per tile where there are fewer tiles; the ring's shared
// memory and the epilogue's extra bytes.
template <typename InT, class Epilogue>
int launch(Params p, cudaStream_t stream) {
  using Kernel = void (*)(Params, Maps);
  if (p.lines <= 0 || p.width <= 0 || p.n_in <= 0) return 0;
  const Kernel kernel = one_term<InT, Epilogue>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  bool tma = p.ld % 8 == 0 && (static_cast<long long>(p.n_in) * sizeof(InT)) % 16 == 0 &&
             split::aligned16(p.raw);
  for (int c = 0; c < Epilogue::MAPS; ++c) tma = tma && split::aligned16(p.w[c][0]);
  Maps maps = {};
  if (tma) {
    const int rc = encode<InT, Epilogue::MAPS>(p, &maps);
    if (rc != 0) return rc;
  }
  p.tma = tma ? 1 : 0;
  int sms = 0;
  const int rc = sm_count(&sms);
  if (rc != 0) return rc;
  const long long count = tiles<Epilogue>(p);
  const long long grid = count < sms ? count : sms;
  const int smem = Layout<InT>::SMEM + Epilogue::template extra<InT>(p);
  one_term<InT, Epilogue><<<static_cast<unsigned>(grid), THREADS, smem, stream>>>(p, maps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bf16
}  // namespace
