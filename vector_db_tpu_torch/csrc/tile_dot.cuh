// Shared core of the port's corpus-scan kernels (l2_topk.cu, block_select.cu).
//
// A CTA of 8 warps scores one tile of 128 corpus rows against a group of
// queries. Both operands are staged into shared memory as f32, 64 columns at
// a time, and every product is an f32 FMA on the CUDA cores: no tensor
// cores, so no TF32 rounding. A bf16 operand is widened exactly on staging,
// so bf16 x bf16 products are exact in f32.
//
// Register tile: lane l of warp w holds rows {l, l+32, l+64, l+96} of the
// tile for queries w*QPW .. w*QPW+QPW-1. Per 4 columns it reads 4 row
// float4s (distinct lanes, conflict-free at a row stride of 68 floats) and
// QPW query float4s (one broadcast address), then issues 16*QPW FMAs.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vdb {

constexpr int kRows = 128;            // corpus rows per tile = one JAX block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 64;            // columns staged per pass
constexpr int kStride = kChunk + 4;   // f32 row stride in shared memory
constexpr float kBig = 3.0e38f;       // the JAX masking sentinel
constexpr float kPadRow = 2.0e38f;    // what a JAX padding row scores

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Stage rows [row0, row0 + nrows) x columns [c0, c0 + kChunk) of a
// row-major [n, d] matrix into dst as f32; zero outside [0, n) x [0, d).
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      int64_t row0, int nrows, int64_t n,
                                      int d, int c0) {
  for (int i = threadIdx.x; i < nrows * kChunk; i += kThreads) {
    const int r = i / kChunk;
    const int c = i % kChunk;
    const int64_t row = row0 + r;
    const int col = c0 + c;
    float v = 0.f;
    if (row < n && col < d) v = to_f32(src[row * d + col]);
    dst[r * kStride + c] = v;
  }
}

// acc[qi][r] += sum over the staged chunk of q[warp*QPW + qi][c] * x[lane + 32r][c]
template <int QPW>
__device__ __forceinline__ void tile_dot(const float* xs, const float* qs,
                                         float (&acc)[QPW][4]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll 4
  for (int c = 0; c < kChunk; c += 4) {
    float4 x[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      x[r] = *reinterpret_cast<const float4*>(xs + (lane + 32 * r) * kStride + c);
#pragma unroll
    for (int qi = 0; qi < QPW; ++qi) {
      const float4 qv =
          *reinterpret_cast<const float4*>(qs + (warp * QPW + qi) * kStride + c);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float a = acc[qi][r];
        a = fmaf(qv.x, x[r].x, a);
        a = fmaf(qv.y, x[r].y, a);
        a = fmaf(qv.z, x[r].z, a);
        a = fmaf(qv.w, x[r].w, a);
        acc[qi][r] = a;
      }
    }
  }
}

}  // namespace vdb
