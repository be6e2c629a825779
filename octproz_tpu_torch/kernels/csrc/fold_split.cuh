// The split rungs on Hopper's bf16 tensor cores (sm_90a): decode -> x_hi/
// x_lo split -> the pass terms of _dot_split against bf16 operator parts
// with bf16 wgmma and float32 accumulation -> an epilogue.  This header
// holds the pipeline the split kernels share (mainloop()) and the fold
// kernel with its planar store or fused FPN-subtract + dynamic-range-scale
// epilogue; fold_split.cu and prep_split.cu launch them:
//
//   fold_split<EPI=PLANAR>  _kernel_depth_split        (octproz_tpu/pallas/fused_prep.py:271-280)
//   fold_split<EPI=SCALE>   _kernel_depth_scale_split  (:422-438)
//   fold_split<EPI=SCALE>   _kernel_depth_scale_concat_split  (:354-372, two views of one
//                           wide part per part: row pitch ld = 2 * half, fold_split.cu)
//   prep_split<EPI=PHASE>   _kernel_phase_split        (:245-251, prep_split.cu)
//   prep_split<EPI=REAL>    _kernel_real_split         (:254-258, prep_split.cu)
//
// and, on uint8/uint16 lines, the one-pass rung of every family, whose
// float32 operator arrives as three bf16 parts (terms()):
//
//   fold_split<EPI=PLANAR, PARTS=3>  _kernel_depth        (:261-268)
//   fold_split<EPI=SCALE,  PARTS=3>  _kernel_depth_scale  (:375-419)
//   fold_split<EPI=SCALE,  PARTS=3>  _kernel_depth_scale_concat  (:337-351, two views)
//   prep_split<EPI=PHASE,  PARTS=3>  _kernel_phase        (:228-235, prep_split.cu)
//   prep_split<EPI=REAL,   PARTS=3>  _kernel_real         (:238-242, prep_split.cu)
//
// and, on every input type, B1 at compute_dtype="bfloat16" with PARTS=1:
// the operator rounded to one bf16 part on the host, x rounded to nearest
// bf16 in the kernel (the JAX package's astype on both operands, :264 and
// :643-644), one product term accumulated in float32.  B2, B5, B7 and B8 at
// bf16 (:344, :401/:409, :231, :240) run the persistent one-term kernel of
// fold_bf16.cuh instead.  The float32-FMA template of
// fold_gemm.cuh and prep_gemm.cu serves the one pass of float32 compute on
// float32 lines alone (samples above 16 bits).
//
// What bounds them, on one H100 (H100 80GB HBM3, 700 W: 989 TFLOP/s of
// dense bf16, 3.35 TB/s): at the main path's geometry (131072 lines x 1024
// samples -> 512 bins re and im, or 1024 prep columns) each pass term is a
// bf16 GEMM of 275 GFLOP against ~0.54-1.3 GB of raw input, operator parts
// and output: compute bound, 0.56 ms for the two terms "high" needs on
// shifted 12-bit samples (x_lo being zero), 0.83 ms for the three of the
// one-pass rung (1.39 ms for its five where x_lo is not zero), 0.28 ms for
// B1's one term at compute_dtype="bfloat16".
//
// Design.  A block owns 128 lines and two halves of 64 operator columns,
// each a (tensor map, column offset) pair: the fold kernels take
// (W_re, n0) and (W_im, n0) -- bin n0 + j's re and im meet in one thread,
// COLS = 64 columns per block; for the concat kernel W_re and W_im are the
// two halves of one wide [W_re | W_im] part, views at W and W + half with
// the wide row pitch --, the prep kernels (P, n0) and (P, n0 + 64) --
// COLS = 128.  It walks n_in in stages of 64:
// * one producer warp fills a ring of STAGES shared-memory stages: the
//   operator parts (2 halves x 2-3 parts, (n_in, width) bf16 at row pitch
//   ld, i.e. MN-major for wgmma) by TMA into 128-byte-swizzled 64 x 64 tiles,
//   and the raw integer tile (uint8/uint16/float32, 128 lines x 64
//   samples) by 16-byte cp.async into padded rows, both signalling one
//   mbarrier per stage; out-of-range lines, samples and columns arrive as
//   zeros, and a half that lies wholly past the operator's width is not
//   loaded at all (its columns are never stored).  The warp starts a
//   stage's 512-2048 raw copies itself, so their loop is kept to the copy
//   and two adds: a lane keeps its chunk and walks down the rows (with
//   the row, chunk and bounds worked out per copy, the producer warp and
//   not the memory system set the pace of every kernel here).  Where TMA
//   cannot describe the operator (a row pitch not a multiple of 8 elements,
//   or a part or view not 16-byte aligned: the concat kernel's im view when
//   half % 8 != 0) or the raw rows are not 16-byte aligned, the producer
//   stores the same layout element by element (slow; no shape of the main
//   path takes it);
// * two consumer warpgroups of 64 lines each decode their rows of the raw
//   tile straight into the register fragment of wgmma's A operand (>> 4
//   when bitshift is set), split it there into x_hi (mask) and
//   x_lo = bf16_rn(x - x_hi) -- or, with one part (PARTS = 1, the bf16
//   compute route), round it to nearest bf16 and stop there: no x_lo, no
//   vote --, and run bf16 wgmma against the
//   stage's operator tiles -- one m64n128k16 per part and 16 samples, its
//   128 columns the part's two half tiles -- so the decoded x never leaves
//   registers;
// * the terms of a stage go low-order first into one float32 partial sum
//   -- [x_lo w_(P-2), ..., x_lo w_0, x_hi w_(P-1), ..., x_hi w_0] -- which
//   is then added to the running sum with ordinary float32 adds.  The
//   tensor cores sum inside one wgmma chain with their own alignment and
//   truncation; folding every stage bounds that error to a stage's 64
//   samples (summed across n_in in one chain instead, the fold kernel
//   missed the planar bound by up to 3x on the card);
// * a warpgroup skips a stage's x_lo terms when every integer sample of
//   its tile is below 256, or every float sample exact in bf16 (a vote over
//   its 128 threads): x_lo is then zero, and adding exact zeros changes no
//   sum.  Shifted 12-bit samples fit, so the main path runs 2 of the 3
//   "high" terms.  A stage with x_lo runs its x_lo group first and then
//   decodes x_hi again, so only one set of A fragments is ever live (with
//   the two 64-float sums, the block's 288 threads -- sized by ptxas as
//   384, 168 registers each -- leave no room for two);
// * the two warpgroups take turns starting a stage's wgmma (named barriers
//   4 and 5; the turn passes once the group is committed, not when it is
//   done), which staggers them: one decodes, votes and folds while the
//   other's terms run, instead of both reaching the tensor cores at once
//   and both leaving them idle afterwards;
// * the epilogue stages each warp's 16 x 128 sums in shared memory
//   (stage_sums) and walks them with one lane per column: FPN subtraction,
//   p = re^2 + im^2, log / lin / fast log and the float32 or bf16 store (or
//   the planar float32 store) run there with few registers live, and every
//   store is a whole 128-byte line.
//
// Launch contract: the kernels run on the caller's stream, allocate
// nothing and do not synchronise; launch() returns cudaGetLastError() (or
// the error of encoding a tensor map or raising the dynamic shared memory
// limit).  Built without --use_fast_math: log10f(0) is -inf on the exact
// path, as in the JAX package.  The operator parts' tensor maps are encoded
// on the host for every launch (a few microseconds); cuTensorMapEncodeTiled
// is reached through the runtime's driver entry point, so the library does
// not link libcuda.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only; no libcuda link)
#include <cudaTypedefs.h>

#include "fold_gemm.cuh"

namespace {
namespace split {

constexpr int LINES = 128;  // lines per block: two consumer warpgroups of 64
constexpr int BINS = 64;    // operator columns per half
constexpr int DEPTH = 64;   // samples (n_in) per stage: one 128-byte bf16 row
constexpr int CONSUMERS = 256;
constexpr int THREADS = CONSUMERS + 32;  // + the producer warp
constexpr int B_TILE = DEPTH * BINS * 2;  // one operator part of one half
constexpr int SMEM_BUDGET = 220 * 1024;   // the pipeline's stages
constexpr int EPI_ROW = BINS + 8;         // floats per staged output row

// Diagnostic builds only (kernels/diagnose.py; build.py never sets it):
// 1 sums all of n_in in one wgmma chain instead of folding every stage --
// the same terms, other rounding; 8 lets the warpgroups start their wgmma
// without taking turns -- the same output; 2 refills no stage after the
// ring's first fill and 4 runs no wgmma -- timing only, the output is
// wrong.  16, 32 and 64 (no epilogue arithmetic, no decode, no stores) are
// read by the one-term kernel of fold_bf16.cuh alone.
#ifndef FOLD_SPLIT_VARIANT
#define FOLD_SPLIT_VARIANT 0
#endif
constexpr bool ONE_CHAIN = FOLD_SPLIT_VARIANT & 1;
constexpr bool NO_LOADS = FOLD_SPLIT_VARIANT & 2;
constexpr bool NO_MMA = FOLD_SPLIT_VARIANT & 4;
constexpr bool TURNS = !(FOLD_SPLIT_VARIANT & 8);
constexpr bool NO_STORES = FOLD_SPLIT_VARIANT & 64;

// The raw tile's row pitch: 64 samples plus 16 bytes, so the A-fragment
// reads of a warp (8 rows x 4 column pairs) hit 32 different banks.
template <typename InT>
struct RawTile {
  static constexpr int ROW = sizeof(InT) == 1 ? 80 : sizeof(InT) == 2 ? 144 : 288;
  static constexpr int BYTES = LINES * ROW;
};

template <typename InT, int PARTS>
struct Layout {
  static constexpr int B_BYTES = 2 * PARTS * B_TILE;
  static constexpr int STAGE = B_BYTES + RawTile<InT>::BYTES;  // a multiple of 1024
  static constexpr int FIT = SMEM_BUDGET / STAGE;
  static constexpr int STAGES = FIT > 4 ? 4 : FIT;
  static constexpr int SMEM = 1024 + STAGES * STAGE + 2 * STAGES * 8;
  static_assert(STAGE % 1024 == 0, "stages keep the 1024-byte swizzle alignment");
  static_assert(STAGES >= 2, "at least a double buffer");
  static_assert(STAGES * STAGE >= 2 * LINES * EPI_ROW * 4, "the epilogue reuses the stages");
};

struct Params {
  const void* raw;
  const __nv_bfloat16* w[2][3];  // [map][part], (n_in, width) row-major; prep: map 0 only
  const float* mean2;            // SCALE: (2, width), re then im
  const float* cos_row;          // PHASE: (width,)
  const float* sin_row;          // PHASE: (width,)
  float* re_out;                 // PLANAR
  float* im_out;                 // PLANAR
  void* out;                     // SCALE, PHASE, REAL
  long long lines;
  int n_in;
  int width;  // the operator's columns: half (fold) or n_out (prep)
  int ld;     // its row pitch in elements: width, or 2 * half for two views of a wide part
  int bitshift;
  int mode;
  float a;
  float b;
  int tma;  // 1: TMA operator tiles and cp.async raw tiles
};

struct Maps {
  CUtensorMap m[2][3];  // [map][part]: 64 columns x 64 samples, 128-byte swizzle
};

// The block's tile: lines m0 .. m0 + LINES - 1, operator columns n0 ..
// n0 + COLS - 1.  Half c of it is map c % n_maps at column n0 +
// c * (COLS - BINS): the fold kernels' two maps at n0, or the prep
// kernels' one map at n0 and n0 + 64.
template <int COLS>
__host__ __device__ __forceinline__ constexpr int n_maps() {
  return COLS == BINS ? 2 : 1;
}

template <int COLS>
__host__ __device__ __forceinline__ int col_tiles(const Params& p) {
  return (p.width + COLS - 1) / COLS;
}

// --- PTX wrappers ----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int x, int y,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

// 16 bytes global -> shared; src_bytes = 0 fills zeros without reading.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// The barrier counts one arrival when this thread's cp.asyncs so far land.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Counts this warp at the named barrier without waiting there.
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// True on every thread of a warpgroup if v is true on any of its 128.
__device__ __forceinline__ bool warpgroup_any(bool v, int bar_id) {
  uint32_t r;
  asm volatile(
      "{\n.reg .pred p, q;\n"
      "setp.ne.u32 q, %1, 0;\n"
      "bar.red.or.pred p, %2, 128, q;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(r)
      : "r"(static_cast<uint32_t>(v)), "r"(bar_id)
      : "memory");
  return r != 0;
}

// Shared-memory matrix descriptor of a part's MN-major operator tiles as
// one 16 x 128 B operand: 64 columns (128 bytes) per sample row, 128-byte
// swizzle, the next 8 sample rows 1024 bytes on (SBO), and the next 64
// columns -- the same part's second half tile -- PARTS tiles on (LBO).
template <int PARTS>
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(PARTS * B_TILE >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accumulator registers across the
// asynchronous wgmma window.
__device__ __forceinline__ void pin(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D(64x128, f32) (+)= A(64x16, bf16 registers) B(16x128, bf16 shared,
// MN-major): columns 0-63 of D are the first half (d[0..31]), 64-127 the
// second (d[32..63]).
__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// --- decode and split ------------------------------------------------------

// An integer below 2^23 as a float: its bits OR'ed into those of 2^23,
// minus 2^23 -- exact, and two full-rate instructions in place of a
// quarter-rate conversion.
__device__ __forceinline__ float int_to_float(uint32_t v) {
  return __uint_as_float(0x4B000000u | v) - 8388608.f;
}

// Two neighbouring samples of a raw row in shared memory, decoded as the
// wrappers' _decode_block does (uint -> (>> 4) -> float).  wide collects a nonzero bit
// if either sample may have a nonzero x_lo: an integer sample of 256 or more
// (below 256 it is exact in bf16), a float whose x - x_hi is not zero.
template <typename InT>
__device__ __forceinline__ void load_pair(const uint8_t* p, int bitshift, float& v0, float& v1,
                                          uint32_t& wide);
template <>
__device__ __forceinline__ void load_pair<uint16_t>(const uint8_t* p, int bitshift, float& v0,
                                                    float& v1, uint32_t& wide) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  const uint32_t i0 = bitshift ? (w >> 4) & 0xFFFu : w & 0xFFFFu;
  const uint32_t i1 = bitshift ? w >> 20 : w >> 16;
  wide |= (i0 | i1) >> 8;
  v0 = int_to_float(i0);
  v1 = int_to_float(i1);
}
template <>
__device__ __forceinline__ void load_pair<uint8_t>(const uint8_t* p, int bitshift, float& v0,
                                                   float& v1, uint32_t&) {
  const uint32_t w = *reinterpret_cast<const uint16_t*>(p);
  const int s = bitshift ? 4 : 0;
  v0 = int_to_float((w & 0xFFu) >> s);
  v1 = int_to_float((w >> 8) >> s);
}
template <>
__device__ __forceinline__ void load_pair<float>(const uint8_t* p, int, float& v0, float& v1,
                                                 uint32_t& wide) {
  const float2 f = *reinterpret_cast<const float2*>(p);
  v0 = f.x;
  v1 = f.y;
  wide |= __float_as_uint(v0 - x_hi(v0)) | __float_as_uint(v1 - x_hi(v1));
}

// x_hi of two samples as one bf16x2 register (the low half holds v0): the
// upper halves of their float32 bits.
__device__ __forceinline__ uint32_t pack_hi(float v0, float v1) {
  return __byte_perm(__float_as_uint(v0), __float_as_uint(v1), 0x7632);
}
// Two samples rounded to nearest (even) bf16: the bf16 compute route.
__device__ __forceinline__ uint32_t pack_rn(float v0, float v1) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(v0, v1);
  return *reinterpret_cast<const uint32_t*>(&r);
}
__device__ __forceinline__ uint32_t pack_lo(float v0, float v1) {
  return pack_rn(v0 - x_hi(v0), v1 - x_hi(v1));
}

// What a fragment register holds: x_hi, x_lo, or x rounded to nearest.
enum Pack { X_HI, X_LO, X_RN };

// --- the producer warp -----------------------------------------------------

template <typename InT, int PARTS, int COLS>
__device__ __forceinline__ void produce(const Params& p, const Maps& maps, uint8_t* smem,
                                        uint32_t base, uint32_t full, uint32_t empty,
                                        long long m0, int n0, int nkb, int lane) {
  using L = Layout<InT, PARTS>;
  constexpr int ELEMS = 16 / static_cast<int>(sizeof(InT));  // samples per 16-byte chunk
  constexpr int CHUNKS = DEPTH / ELEMS;                      // per raw row
  constexpr int ROW = RawTile<InT>::ROW;
  const InT* raw = static_cast<const InT*>(p.raw);
  static_assert(COLS == BINS || COLS == 2 * BINS, "COLS: 64 or 128");
  constexpr int OFF = COLS - BINS;  // the second half's column offset
  constexpr int MAPS = n_maps<COLS>();
  // the first half always starts inside the operator; the second may not
  const bool second = OFF == 0 || n0 + OFF < p.width;
  for (int kb = 0; kb < nkb; ++kb) {
    const int s = kb % L::STAGES;
    mbar_wait(empty + 8 * s, ((kb / L::STAGES) & 1) ^ 1);
    const uint32_t stage = base + s * L::STAGE;
    const uint32_t tile = stage + L::B_BYTES;
    const int k0 = kb * DEPTH;
    if (NO_LOADS && kb >= L::STAGES) {
      mbar_arrive(full + 8 * s);
      if (lane == 0) mbar_arrive(full + 8 * s);
      continue;
    }
    if (p.tma) {
      if (lane == 0) {
        mbar_expect_tx(full + 8 * s, second ? L::B_BYTES : L::B_BYTES / 2);
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int q = 0; q < PARTS; ++q)
            if (c == 0 || second)
              tma_load(stage + (c * PARTS + q) * B_TILE, &maps.m[c % MAPS][q], n0 + c * OFF,
                       k0, full + 8 * s);
      }
      // A pass of the warp covers PASS rows: lane -> (row lane / CHUNKS,
      // chunk lane % CHUNKS), so only the row moves inside the loop; ok
      // counts this lane's copies that lie inside the input.
      constexpr int PASS = 32 / CHUNKS;
      const int r0 = lane / CHUNKS;
      const int col = k0 + (lane % CHUNKS) * ELEMS;
      const long long left = p.lines - m0 - r0;  // lines from this lane's first row on
      const int ok = col >= p.n_in || left <= 0 ? 0
                     : left > LINES - PASS      ? LINES / PASS
                                                : static_cast<int>((left + PASS - 1) / PASS);
      const InT* const src = raw + (m0 + r0) * p.n_in + col;
      const uint32_t dst = tile + r0 * ROW + (lane % CHUNKS) * 16;
      const long long step = static_cast<long long>(PASS) * p.n_in;
      if (ok == LINES / PASS) {
#pragma unroll 8
        for (int i = 0; i < LINES / PASS; ++i)
          cp_async16(dst + i * PASS * ROW, src + i * step, 16);
      } else {
        for (int i = 0; i < LINES / PASS; ++i)
          cp_async16(dst + i * PASS * ROW, i < ok ? src + i * step : raw, i < ok ? 16 : 0);
      }
      cp_async_arrive(full + 8 * s);
    } else {
      // The operator tiles as TMA would write them: column n of sample row
      // r at r*128 + ((n/8) ^ (r%8))*16 + (n%8)*2.
      uint8_t* st = smem + (stage - base);
      for (int e = lane; e < DEPTH * BINS; e += 32) {
        const int r = e / BINS;
        const int n = e % BINS;
        const int k = k0 + r;
        const int off = r * 128 + ((((n >> 3) ^ (r & 7)) << 4) | ((n & 7) * 2));
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = n0 + c * OFF + n;
          const bool ok = k < p.n_in && col < p.width;
#pragma unroll
          for (int q = 0; q < PARTS; ++q) {
            const __nv_bfloat16* const w = p.w[c % MAPS][q];
            const __nv_bfloat16 v =
                ok ? w[static_cast<long long>(k) * p.ld + col] : __float2bfloat16_rn(0.f);
            *reinterpret_cast<__nv_bfloat16*>(st + (c * PARTS + q) * B_TILE + off) = v;
          }
        }
      }
      uint8_t* rt = st + L::B_BYTES;
      for (int e = lane; e < LINES * DEPTH; e += 32) {
        const int r = e / DEPTH;
        const int k = k0 + e % DEPTH;
        const long long line = m0 + r;
        const InT v = (line < p.lines && k < p.n_in) ? raw[line * p.n_in + k] : InT(0);
        *reinterpret_cast<InT*>(rt + r * ROW + (e % DEPTH) * sizeof(InT)) = v;
      }
      // wgmma reads the operator tiles through the async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(full + 8 * s);
      if (lane == 0) mbar_arrive(full + 8 * s);  // in place of the expect_tx arrival
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// --- one stage of a consumer warpgroup -------------------------------------

// The A fragments (m64nNk16) of this thread for the stage: register i of
// chunk kk holds line row0 + 8*(i&1), samples 16*kk + 2t + 8*(i>>1) and the
// next one -- x_hi (X_HI), x_lo = bf16_rn(x - x_hi) (X_LO) or bf16_rn(x)
// (X_RN);
// wide as in load_pair.
template <typename InT, Pack PACK>
__device__ __forceinline__ void fragments(const uint8_t* tile, int row0, int t, int bitshift,
                                          uint32_t (&x)[4][4], uint32_t& wide) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + 8 * (i & 1);
      const int col = 16 * kk + 2 * t + 8 * (i >> 1);
      float v0, v1;
      load_pair<InT>(tile + r * RawTile<InT>::ROW + col * sizeof(InT), bitshift, v0, v1,
                     wide);
      x[kk][i] = PACK == X_HI   ? pack_hi(v0, v1)
                 : PACK == X_LO ? pack_lo(v0, v1)
                                : pack_rn(v0, v1);
    }
}

// One group of a stage's pass terms into d: x_hi w_j for j = P-1 .. 0
// (HI; with P = 1 the one term of the rounded x), or x_lo w_j for
// j = P-2 .. 0 -- low-order first.  The group's
// first instruction overwrites d unless accumulate is set.  Once the group
// is committed, named barrier committed (if not negative) is told so.
template <int PARTS, bool HI>
__device__ __forceinline__ void stage_terms(float (&d)[64], const uint32_t (&x)[4][4],
                                            uint32_t stage, bool accumulate,
                                            int committed = -1) {
  pin(d);
  wgmma_fence();
#pragma unroll
  for (int j = HI ? PARTS - 1 : PARTS - 2; j >= 0; --j)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      if (!NO_MMA)
        wgmma_n128(d, x[kk], b_desc<PARTS>(stage + j * B_TILE + kk * 2048),
                   accumulate || j != (HI ? PARTS - 1 : PARTS - 2) || kk > 0);
  wgmma_commit();
  if (committed >= 0) named_arrive(committed, CONSUMERS);
  wgmma_wait_all();
  pin(d);
}

// --- the pipeline ------------------------------------------------------------

// The shared pipeline of the split kernels: sets up the ring in the
// block's dynamic shared memory (aligned to 1024 bytes at smem), runs the
// producer warp, which returns false, and gives each consumer thread its
// share of the block's 128 x (2 x 64) sums in acc (wgmma's n128 layout:
// the first half's columns in acc[0..31], the second's in acc[32..63]) and
// returns true.  PARTS = 1 is the bf16 compute route: x rounded to nearest,
// one term per stage, no x_lo group and no vote.
template <typename InT, int PARTS, int COLS>
__device__ __forceinline__ bool mainloop(const Params& p, const Maps& maps, uint8_t* smem,
                                         long long m0, int n0, float (&acc)[64]) {
  using L = Layout<InT, PARTS>;
  const uint32_t base = smem_u32(smem);
  const uint32_t full = base + L::STAGES * L::STAGE;  // one mbarrier per stage
  const uint32_t empty = full + 8 * L::STAGES;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int nkb = (p.n_in + DEPTH - 1) / DEPTH;

  if (tid == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(full + 8 * s, 33);  // 32 raw-tile arrivals + the operator tiles'
      mbar_init(empty + 8 * s, CONSUMERS / 32);  // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {
    produce<InT, PARTS, COLS>(p, maps, smem, base, full, empty, m0, n0, nkb, lane);
    return false;
  }

  const int wg = warp / 4;  // consumer warpgroup: lines 64*wg .. 64*wg + 63
  const int w4 = warp % 4;  // its warp: 16 of those lines
  const int g = lane / 4;
  const int t = lane % 4;
  const int row0 = wg * 64 + w4 * 16 + g;  // this thread's lines: row0, row0 + 8

  float part[64];  // one stage's terms
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;

  // Named barrier 4 + wg is warpgroup wg's turn to start a stage's wgmma
  // (128 threads wait there, the other 128 arrive); warpgroup 0 has the
  // first.
  if (TURNS && wg == 1) named_arrive(4, CONSUMERS);

  for (int kb = 0; kb < nkb; ++kb) {
    const int s = kb % L::STAGES;
    mbar_wait(full + 8 * s, (kb / L::STAGES) & 1);
    const uint8_t* tile = smem + s * L::STAGE + L::B_BYTES;
    const uint32_t stage = base + s * L::STAGE;
    uint32_t x[4][4];
    uint32_t wide = 0;
#if FOLD_SPLIT_VARIANT & 1
    float(&sum)[64] = acc;
#else
    float(&sum)[64] = part;  // the stage's terms, folded into acc below
#endif
    constexpr bool RN_ONLY = PARTS == 1;
    fragments<InT, RN_ONLY ? X_RN : X_HI>(tile, row0, t, p.bitshift, x, wide);
    // uint8 samples are exact in bf16: x_lo is zero by construction; the
    // bf16 route has no x_lo at all
    const bool lo = !RN_ONLY && sizeof(InT) != 1 && warpgroup_any(wide != 0, 1 + wg);
    // the turn passes with this stage's last group, but for warpgroup 1's
    // last stage: nobody waits for that one
    const int next = TURNS && !(wg == 1 && kb == nkb - 1) ? 4 + (wg ^ 1) : -1;
    if (TURNS) named_sync(4 + wg, CONSUMERS);
    if (!lo) {
      stage_terms<PARTS, true>(sum, x, stage, ONE_CHAIN, next);
    } else {
      // x_lo's group first, then x_hi decoded again: the two fragment sets
      // are never live together
      fragments<InT, X_LO>(tile, row0, t, p.bitshift, x, wide);
      stage_terms<PARTS, false>(sum, x, stage, ONE_CHAIN);
      fragments<InT, X_HI>(tile, row0, t, p.bitshift, x, wide);
      stage_terms<PARTS, true>(sum, x, stage, true, next);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
    if (!ONE_CHAIN) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += part[i];
    }
  }
  return true;
}

// Once both warpgroups are past the pipeline, its shared memory takes each
// warp's 16 x 128 sums: columns 0-63 (the first half) at the returned
// tile, 64-127 16 * EPI_ROW floats on, row pitch EPI_ROW.  A warp then
// walks its 16 lines with one lane per column, so each epilogue runs with
// few registers live and every store is a whole line.
__device__ __forceinline__ const float* stage_sums(uint8_t* smem, const float (&acc)[64]) {
  const int warp = threadIdx.x / 32;
  const int g = threadIdx.x % 32 / 4;
  const int t = threadIdx.x % 4;
  named_sync(3, CONSUMERS);
  float* const tile = reinterpret_cast<float*>(smem) + warp * 2 * 16 * EPI_ROW;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * t;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float* const tl = tile + c * 16 * EPI_ROW;
      const float* const z = acc + 32 * c + 4 * j;
      *reinterpret_cast<float2*>(tl + g * EPI_ROW + col) = make_float2(z[0], z[1]);
      *reinterpret_cast<float2*>(tl + (g + 8) * EPI_ROW + col) = make_float2(z[2], z[3]);
    }
  }
  __syncwarp();
  return tile;
}

// The block's first line, first column and 1024-byte aligned dynamic
// shared memory.
struct Block {
  uint8_t* smem;
  long long m0;
  int n0;
};

template <int COLS>
__device__ __forceinline__ Block block_of(const Params& p, uint8_t* smem_raw) {
  const uint32_t raw_addr = smem_u32(smem_raw);
  const uint32_t base = (raw_addr + 1023u) & ~1023u;
  const int n_tiles = col_tiles<COLS>(p);
  return {smem_raw + (base - raw_addr),
          static_cast<long long>(blockIdx.x / n_tiles) * LINES,
          static_cast<int>(blockIdx.x % n_tiles) * COLS};
}

// --- the fold kernel ---------------------------------------------------------

template <typename InT, int PARTS, int EPI, typename OutT>
__global__ void __launch_bounds__(THREADS, 1)
    fold_split(const __grid_constant__ Params p, const __grid_constant__ Maps maps) {
  extern __shared__ uint8_t smem_raw[];
  const Block blk = block_of<BINS>(p, smem_raw);
  float acc[64];  // re in 0-31, im in 32-63
  if (!mainloop<InT, PARTS, BINS>(p, maps, blk.smem, blk.m0, blk.n0, acc)) return;

  const float* const tile_re = stage_sums(blk.smem, acc);
  const float* const tile_im = tile_re + 16 * EPI_ROW;
  const int half = p.width;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float mean[2][2];  // [axis][h] of bin n0 + lane + 32h
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int bin = blk.n0 + lane + 32 * h;
    const bool in = EPI == SCALE && bin < half;
    mean[0][h] = in ? p.mean2[bin] : 0.f;
    mean[1][h] = in ? p.mean2[half + bin] : 0.f;
  }
  const long long line0 = blk.m0 + warp * 16;
#pragma unroll 4
  for (int rr = 0; rr < 16; ++rr) {
    const long long line = line0 + rr;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int bin = blk.n0 + lane + 32 * h;
      if (line >= p.lines || bin >= half) continue;
      const float zr = tile_re[rr * EPI_ROW + lane + 32 * h];
      const float zi = tile_im[rr * EPI_ROW + lane + 32 * h];
      const long long o = line * half + bin;
      if constexpr (EPI == PLANAR) {
        p.re_out[o] = zr;
        p.im_out[o] = zi;
      } else {
        const float re = zr - mean[0][h];
        const float im = zi - mean[1][h];
        const float pw = re * re + im * im;
        float v;
        if (p.mode == MODE_LOG)
          v = p.a * log10f(pw) + p.b;
        else if (p.mode == MODE_LIN)
          v = p.a * sqrtf(pw) + p.b;
        else
          v = p.a * fast_log2(pw) + p.b;
        static_cast<OutT*>(p.out)[o] = store_cast<OutT>(v);
      }
    }
  }
}

// --- host side ---------------------------------------------------------------

PFN_cuTensorMapEncodeTiled_v12000 encoder() {
  static const PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(f)
               : nullptr;
  }();
  return fn;
}

// TMA describes an operator part when its row pitch is a 16-byte multiple
// and it starts 16-byte aligned; the raw rows likewise for the cp.async
// path.  A view of width columns at pitch ld > width (half of a wide part)
// keeps dims = width: columns past it arrive as zeros, never as the other
// view's.
inline bool aligned16(const void* q) { return (reinterpret_cast<uintptr_t>(q) & 15) == 0; }

inline int encode_maps(const Params& p, int n, int parts, Maps* maps) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  for (int c = 0; c < n; ++c)
    for (int q = 0; q < parts; ++q) {
      const cuuint64_t dims[2] = {static_cast<cuuint64_t>(p.width),
                                  static_cast<cuuint64_t>(p.n_in)};
      const cuuint64_t strides[1] = {static_cast<cuuint64_t>(p.ld) * 2};
      const cuuint32_t box[2] = {BINS, DEPTH};
      const cuuint32_t unit[2] = {1, 1};
      const CUresult r = encode(&maps->m[c][q], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                                const_cast<__nv_bfloat16*>(p.w[c][q]), dims, strides, box, unit,
                                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
      if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
    }
  return 0;
}

using Kernel = void (*)(Params, Maps);

// Above 48 KB the dynamic shared memory is opt-in: once per kernel (the
// caller keeps the result in a function-local static).
template <typename InT, int PARTS>
cudaError_t opt_in(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Layout<InT, PARTS>::SMEM);
}

// The checks, tensor maps and launch of one split kernel of COLS columns
// per block; attr is its opt_in result.
template <typename InT, int PARTS, int COLS>
int launch(Params p, Kernel kernel, cudaError_t attr, cudaStream_t stream) {
  if (p.lines <= 0 || p.width <= 0 || p.n_in <= 0) return 0;
  const long long blocks = ((p.lines + LINES - 1) / LINES) * col_tiles<COLS>(p);
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  bool tma = p.ld % 8 == 0 && (static_cast<long long>(p.n_in) * sizeof(InT)) % 16 == 0 &&
             aligned16(p.raw);
  for (int c = 0; c < n_maps<COLS>(); ++c)
    for (int q = 0; q < PARTS; ++q) tma = tma && aligned16(p.w[c][q]);
  Maps maps = {};
  if (tma) {
    const int rc = encode_maps(p, n_maps<COLS>(), PARTS, &maps);
    if (rc != 0) return rc;
  }
  p.tma = tma ? 1 : 0;
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<static_cast<unsigned>(blocks), THREADS, Layout<InT, PARTS>::SMEM, stream>>>(p, maps);
  return static_cast<int>(cudaGetLastError());
}

// The operator parts given: the leading non-null pointers of w.
inline int parts_of(const void* const w[3]) { return !w[0] ? 0 : !w[1] ? 1 : !w[2] ? 2 : 3; }

// The pass terms a launch runs: those of its passes; at one pass (three
// parts, integer lines only) the five of "highest"; at BF16_PASS (one
// part, any input type) the one term of x rounded to nearest; 0 for a
// launch the split kernels do not take.  An integer sample of at most 16
// bits is exactly x_hi + x_lo and the float32 operator's three parts carry
// ~24 mantissa bits, so x_hi w_2, x_hi w_1, x_hi w_0 and (where a stage
// holds a sample of 256 or more) x_lo w_1, x_lo w_0 give the one-pass
// float32 product at float32 grade; float32 lines (above 16 bits) are
// refused at one pass.
inline int terms(int in_kind, int passes, int parts) {
  if (passes == BF16_PASS) return parts == 1 ? 1 : 0;
  if (passes != 1) return passes;
  return parts == 3 && (in_kind == IN_U8 || in_kind == IN_U16) ? 5 : 0;
}

// The launch of K<InT, PARTS>::run (a struct template of the including
// file) for in_kind (0 uint8, 1 uint16, 2 float32).
template <template <typename, int> class K, int PARTS>
int dispatch_input(int in_kind, const Params& p, cudaStream_t stream) {
  switch (in_kind) {
    case IN_U8: return K<uint8_t, PARTS>::run(p, stream);
    case IN_U16: return K<uint16_t, PARTS>::run(p, stream);
    case IN_FLOAT: return K<float, PARTS>::run(p, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// ... and n_terms (terms(): 1, 3 or 5 with 1, 2 or 3 parts); without
// ONE_TERM the one-term instantiation is left out and such a launch refused.
template <template <typename, int> class K, bool ONE_TERM = true>
int dispatch(int in_kind, int n_terms, const Params& p, cudaStream_t stream) {
  switch (n_terms) {
    case 1:
      if constexpr (ONE_TERM) return dispatch_input<K, 1>(in_kind, p, stream);
      break;
    case 3: return dispatch_input<K, 2>(in_kind, p, stream);
    case 5: return dispatch_input<K, 3>(in_kind, p, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace split
}  // namespace
