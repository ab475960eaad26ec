// What the tiled Hopper (sm_90a) kernels share: bf16 packing, the 128-byte
// swizzle that wgmma's shared-memory descriptors read, mbarriers, cp.async
// groups, TMA and the tensor map of A, the sum of the partial products of a
// contraction split on grid.z, and the occupancy query of a launch shape.
//
// Included by fused_sketch.cu (K1, K2), saso_sketch.cu (K4) and ell_spmm.cu
// (K5). Nothing here depends on a kernel's tiles: A's box comes in as
// template parameters. Each source is a translation unit of its own with a
// plain C interface, so the helpers sit in an anonymous namespace, as the
// kernels do.

#pragma once

#include <cstdint>
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// how the consumers read A: with plain loads, or from the staging tile
// that TMA fills, laid out [k][n] (A row-major) or [n][k] (column-major)
constexpr int kLoadDirect = 0;
constexpr int kTmaRows = 1;
constexpr int kTmaCols = 2;

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ __nv_bfloat16 to_bf16(float x) {
  return __float2bfloat16_rn(x);
}
__device__ __forceinline__ __nv_bfloat16 to_bf16(__nv_bfloat16 x) { return x; }

// four values of A as four bf16, rounded to nearest even
__device__ __forceinline__ uint2 four_bf16(const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  return make_uint2(pack_bf16(to_bf16(v.x), to_bf16(v.y)),
                    pack_bf16(to_bf16(v.z), to_bf16(v.w)));
}
__device__ __forceinline__ uint2 four_bf16(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint2*>(p);
}

// byte offset of 16-byte chunk `chunk` of row `row` in a K-major tile of
// 128-byte rows under the 128-byte swizzle (chunk ^= row % 8 inside each
// 1024-byte atom of eight rows), the layout wgmma's descriptors read
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return (uint32_t)row * 128 + ((uint32_t)(chunk ^ (row & 7)) << 4);
}

// byte offset of element (k, j) in an MN-major bf16 data tile of TK rows:
// blocks of 64 columns, each TK rows of 128 bytes under the 128-byte
// swizzle
template <int TK>
__device__ __forceinline__ uint32_t mn_off(int k, int j) {
  return (uint32_t)(j >> 6) * (TK * 128) + swz(k, (j & 63) >> 3) +
         (uint32_t)(j & 7) * 2;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// spin until the barrier's phase differs from `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" :: "r"(bar), "r"(parity) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect(uint32_t bar,
                                                   uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's newest groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// TMA: the box of `map` (half of A's TK x TN tile) at (c0, c1) into this
// CTA's shared memory, completing its bytes on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(bar)
      : "memory");
}

// wgmma descriptor of a 128-byte-swizzled tile at `addr` (atoms of eight
// 128-byte rows): `lbo` bytes between 64-element blocks along M or N (an
// MN-major tile only), `sbo` bytes between atoms along the other dimension
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)1 << 62);
}

// cuTensorMapEncodeTiled, looked up at run time so that the library need
// not link libcuda
inline PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
    }
  }
  return fn;
}

// The TMA map of the halves of A's (TK x TN) tiles where A's layout allows
// one (one unit stride, the other a multiple of 16 bytes, a 16-byte-aligned
// base): kTmaRows for row-major A, kTmaCols for column-major A; else
// kLoadDirect and the consumers load A themselves.
template <typename TA, int TN, int TK>
int a_map(const void* a, int64_t sk, int64_t sn, int64_t m, int64_t n,
          CUtensorMap* map) {
  const int64_t es = (int64_t)sizeof(TA);
  const bool rows = sn == 1 && (sk * es) % 16 == 0;
  const bool cols = !rows && sk == 1 && (sn * es) % 16 == 0;
  auto encode = encode_tiled();
  if (!(rows || cols) || reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
      m <= 0 || m >= (1LL << 31) || n >= (1LL << 31) || encode == nullptr) {
    return kLoadDirect;
  }
  const cuuint64_t dims[2] = {(cuuint64_t)(rows ? n : m),
                              (cuuint64_t)(rows ? m : n)};
  const cuuint64_t strides[1] = {(cuuint64_t)((rows ? sk : sn) * es)};
  // a box is half a tile: each consumer warpgroup loads the half it
  // converts
  const cuuint32_t box[2] = {(cuuint32_t)(rows ? TN : TK),
                             (cuuint32_t)(rows ? TK / 2 : TN / 2)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, sizeof(TA) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                           : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      2, const_cast<void*>(a), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? (rows ? kTmaRows : kTmaCols) : kLoadDirect;
}

// out = alpha * the sum of the `splits` partial products in ws, `count`
// values each, in split order (deterministic; no atomics). A template so
// that only a source that launches it compiles it.
template <typename T>
__global__ void split_reduce_kernel(const T* __restrict__ ws,
                                    T* __restrict__ out, int64_t count,
                                    int splits, T alpha) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += (int64_t)gridDim.x * blockDim.x) {
    T sum = ws[i];
    for (int z = 1; z < splits; ++z) sum += ws[z * count + i];
    out[i] = alpha * sum;
  }
}

// A sketch kernel, `launch(dst, scale)`, into `out` with alpha; or, split,
// into the partial slices of `ws` (`count` values each) and then their sum
// into `out`
template <typename Launch>
cudaError_t launch_split(Launch launch, int splits, float* ws, float* out,
                         int64_t count, float alpha, cudaStream_t stream) {
  if (splits == 1) return launch(out, alpha);
  cudaError_t e = launch(ws, 1.0f);
  if (e != cudaSuccess) return e;
  const int64_t want = (count + 255) / 256;
  const unsigned blocks = (unsigned)(want < 132 * 16 ? want : 132 * 16);
  split_reduce_kernel<float><<<blocks, 256, 0, stream>>>(ws, out, count,
                                                         splits, alpha);
  return cudaGetLastError();
}

// `smem` bytes of dynamic shared memory for `kernel`, and clusters past the
// portable 8 CTAs
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int smem, int cluster) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && cluster > 8) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  return e;
}

// a launch of `grid` CTAs of `threads` threads and `smem` bytes of dynamic
// shared memory on `stream`, in clusters of `cluster` CTAs along x (`attr`
// holds the cluster's shape)
inline cudaLaunchConfig_t cluster_config(dim3 grid, int threads, int smem,
                                         int cluster, cudaStream_t stream,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// cudaOccupancyMaxActiveClusters of `kernel` with `threads` threads and
// `smem` bytes of shared memory in clusters of `cluster` CTAs: how many
// such clusters the current device runs at once
template <typename Kernel>
int max_active_clusters(Kernel kernel, int threads, int smem, int cluster,
                        int* count) {
  cudaError_t e = prepare(kernel, smem, cluster);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(
      dim3((unsigned)cluster, 1, 1), threads, smem, cluster, nullptr, &attr);
  return (int)cudaOccupancyMaxActiveClusters(count, (void*)kernel, &cfg);
}

}  // namespace
