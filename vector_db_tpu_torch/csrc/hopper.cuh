// Hopper building blocks shared by the port's tensor-core kernels
// (l2_topk.cu, block_select.cu): mbarriers, 2-D TMA copies and their tensor
// maps, the 128-byte-swizzle layout and its wgmma descriptor, and the
// element-load fill for rows that TMA cannot take.
//
// A "chunk" is 128 bytes of columns (64 bf16 or 32 f32) of up to 256 rows
// of a row-major matrix, stored 128-byte swizzled: row r at r * 128 bytes,
// its 16-byte piece c at (c ^ (r & 7)) * 16. That is the layout TMA writes
// with CU_TENSOR_MAP_SWIZZLE_128B and the one a K-major wgmma operand reads
// through desc_sw128; a chunk's base must be 1024-byte aligned.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vdb {

constexpr int kSwz = 128;  // bytes of a swizzled row chunk

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

// make the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
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
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// one arrival on bar that also expects `bytes` of TMA traffic
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// shared memory written through the generic proxy (st.shared), to be read
// through the async proxy (wgmma)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// TMA: the box at (column c0, row c1) of a 2-D tensor map into shared
// memory, counted on bar
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// K-major operand, 128-byte swizzle: 8-row atoms of 1024 bytes
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3ffff) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// byte offset of 16-byte piece c of row r in a 128-byte-swizzled chunk
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * kSwz + ((c ^ (r & 7)) << 4));
}

// keep the compiler from moving accesses to wgmma accumulators across an
// asynchronous wgmma's issue or wait
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Fill without TMA (rows not 16-byte aligned, or narrower than one chunk):
// rows [row0, row0 + nrows) x the 128 bytes of chunk kc of a row-major
// [*, d] matrix into a swizzled chunk, by the 32 lanes of a warp with
// element loads; zeros at rows >= rlim and columns >= d.
template <typename T>
__device__ __forceinline__ void fill(uint8_t* tile, const T* __restrict__ src,
                                     int64_t row0, int nrows, int64_t rlim,
                                     int d, int kc, int lane) {
  constexpr int kPer = 16 / sizeof(T);  // elements per 16-byte piece
  for (int e = lane; e < nrows * 8; e += 32) {
    const int r = e >> 3, c = e & 7;
    const int64_t row = row0 + r;
    const int col = kc * (kSwz / (int)sizeof(T)) + c * kPer;
    uint4 pack = make_uint4(0u, 0u, 0u, 0u);
    T* v = reinterpret_cast<T*>(&pack);
#pragma unroll
    for (int u = 0; u < kPer; ++u)
      if (row < rlim && col + u < d) v[u] = src[row * d + col + u];
    *reinterpret_cast<uint4*>(tile + swz(r, c)) = pack;
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the runtime (the
// library does not link libcuda)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &res);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &res);
#endif
    if (res == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// a [rows, d] row-major matrix in boxes of 128 bytes of columns x box_rows
// rows, 128-byte swizzled, zeros outside
inline int make_map(CUtensorMap* map, const void* base, bool f32,
                    int64_t rows, int d, int box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return (int)cudaErrorNotSupported;
  const int el = f32 ? 4 : 2;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)d * el};
  const cuuint32_t box[2] = {(cuuint32_t)(kSwz / el), (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = enc(
      map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
               : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      2, const_cast<void*>(base), dims, strides, box, step,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// TMA takes a matrix whose rows are 16-byte aligned and at least one chunk
// wide (narrower rows, or rows at other alignments, take fill())
inline bool tma_ok(const void* base, int d, int el) {
  return (d * el) % 16 == 0 && d * el >= kSwz &&
         (uintptr_t)base % 16 == 0;
}

}  // namespace vdb
