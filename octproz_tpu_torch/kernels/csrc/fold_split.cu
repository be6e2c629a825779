// The split-rung fold kernels on bf16 tensor cores (template and design
// notes in fold_split.cuh): the launches behind fold_gemm_planar and
// fold_gemm_scale at 3 and 5 passes (fold_gemm.cu keeps the one-pass rung).
//
//   fold_split<EPI=PLANAR>  _kernel_depth_split        (octproz_tpu/pallas/fused_prep.py:271-280)
//   fold_split<EPI=SCALE>   _kernel_depth_scale_split  (:422-438)
//
// with InT in {uint8, uint16, float} and OutT in {float, bf16} for SCALE.
// The operator parts' tensor maps are encoded on the host for every launch
// (a few microseconds); cuTensorMapEncodeTiled is reached through the
// runtime's driver entry point, so the library does not link libcuda.

#include <cudaTypedefs.h>

#include "fold_split.cuh"

namespace {
namespace split {

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

// TMA describes an operator part when its rows are 16-byte multiples and
// it starts 16-byte aligned; the raw rows likewise for the cp.async path.
bool aligned16(const void* q) { return (reinterpret_cast<uintptr_t>(q) & 15) == 0; }

int encode_maps(const Params& p, int parts, Maps* maps) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  for (int c = 0; c < 2; ++c)
    for (int q = 0; q < parts; ++q) {
      const cuuint64_t dims[2] = {static_cast<cuuint64_t>(p.half),
                                  static_cast<cuuint64_t>(p.n_in)};
      const cuuint64_t strides[1] = {static_cast<cuuint64_t>(p.half) * 2};
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

template <typename InT, int PARTS, int EPI, typename OutT>
int launch(Params p, cudaStream_t stream) {
  using L = Layout<InT, PARTS>;
  if (p.lines <= 0 || p.half <= 0 || p.n_in <= 0) return 0;
  const long long blocks = ((p.lines + LINES - 1) / LINES) * ((p.half + BINS - 1) / BINS);
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  bool tma = p.half % 8 == 0 && (static_cast<long long>(p.n_in) * sizeof(InT)) % 16 == 0 &&
             aligned16(p.raw);
  for (int c = 0; c < 2; ++c)
    for (int q = 0; q < PARTS; ++q) tma = tma && aligned16(p.w[c][q]);
  Maps maps = {};
  if (tma) {
    const int rc = encode_maps(p, PARTS, &maps);
    if (rc != 0) return rc;
  }
  p.tma = tma ? 1 : 0;
  auto kernel = fold_split<InT, PARTS, EPI, OutT>;
  // once per instantiation: above 48 KB the dynamic shared memory is opt-in
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<static_cast<unsigned>(blocks), THREADS, L::SMEM, stream>>>(p, maps);
  return static_cast<int>(cudaGetLastError());
}

template <int EPI, typename OutT, typename InT>
int by_parts(int passes, const Params& p, cudaStream_t stream) {
  switch (passes) {
    case 3: return launch<InT, 2, EPI, OutT>(p, stream);
    case 5: return launch<InT, 3, EPI, OutT>(p, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int EPI, typename OutT>
int by_input(int in_kind, int passes, const Params& p, cudaStream_t stream) {
  switch (in_kind) {
    case 0: return by_parts<EPI, OutT, uint8_t>(passes, p, stream);
    case 1: return by_parts<EPI, OutT, uint16_t>(passes, p, stream);
    case 2: return by_parts<EPI, OutT, float>(passes, p, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

Params params(const void* raw, int bitshift, const void* const wre[3], const void* const wim[3],
              long long lines, int n_in, int half) {
  Params p = {};
  p.raw = raw;
  for (int q = 0; q < 3; ++q) {
    p.w[0][q] = static_cast<const __nv_bfloat16*>(wre[q]);
    p.w[1][q] = static_cast<const __nv_bfloat16*>(wim[q]);
  }
  p.lines = lines;
  p.n_in = n_in;
  p.half = half;
  p.bitshift = bitshift;
  return p;
}

}  // namespace split
}  // namespace

extern "C" {

// The 3/5-pass launches of fold_gemm_planar / fold_gemm_scale (fold_gemm.cu),
// with the same arguments.
int fold_split_planar(const void* raw, int in_kind, int bitshift, int passes,
                      const void* const wre[3], const void* const wim[3], float* re_out,
                      float* im_out, long long lines, int n_in, int half, void* stream) {
  split::Params p = split::params(raw, bitshift, wre, wim, lines, n_in, half);
  p.re_out = re_out;
  p.im_out = im_out;
  return split::by_input<PLANAR, float>(in_kind, passes, p, static_cast<cudaStream_t>(stream));
}

int fold_split_scale(const void* raw, int in_kind, int bitshift, int passes,
                     const void* const wre[3], const void* const wim[3], const float* mean2,
                     void* out, int out_bf16, int mode, float a, float b, long long lines,
                     int n_in, int half, void* stream) {
  split::Params p = split::params(raw, bitshift, wre, wim, lines, n_in, half);
  p.mean2 = mean2;
  p.out = out;
  p.mode = mode;
  p.a = a;
  p.b = b;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_bf16 ? split::by_input<SCALE, __nv_bfloat16>(in_kind, passes, p, s)
                  : split::by_input<SCALE, float>(in_kind, passes, p, s);
}

}  // extern "C"
