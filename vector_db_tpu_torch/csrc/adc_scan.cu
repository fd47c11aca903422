// Full-corpus ADC (asymmetric distance) scan with a running top-k per query:
// dist[b, n] = sum_j lut[b, j, codes[n, j]] over the valid rows n.
//
// Replaces the Pallas TPU kernel vector_db_tpu/ops/pallas/adc_scan.py:
// adc_topk. The TPU kernel turns the LUT gather into a [tile, m * ksub]
// one-hot matmul on the MXU and carries its top-k across a sequential grid
// by k serial min-extractions. Here the design is l2_topk.cu's: each CTA
// owns one (query group, corpus split) pair and keeps a private top-k list
// per query (topk_list.cuh); the wrapper merges the [B, splits * k] partial
// lists with one torch.topk. The LUT "gather" is a shared-memory lookup:
// the CTA holds its queries' f32 LUTs (m * ksub * 4 bytes each, 16 KiB at
// m = 16, ksub = 256) in shared memory, stages one tile of codes at a time,
// and each warp scores the tile's rows for its own query, lane = row, with
// m lookups and f32 adds in subspace order (the exact f32 sum, no bf16).
//
// What bounds it on the H100: shared-memory lookups, B * N * m of them
// (2.1e9 at B = 128, N = 2^20, m = 16), at random banks within each
// subspace's table; the code table itself (N * m bytes) is read once per
// query group. Selection is cheap by construction, as in l2_topk.cu.
//
// Codes are uint8 or int32 [N, m], read as given (no widening or narrowing
// copy of the table); a code outside [0, ksub) is clamped, as a JAX gather
// clamps an index out of range. Ties: rows arrive in ascending order within
// a split, so the lower row wins.

#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_list.cuh"

using namespace vdb;

namespace {

constexpr int kTile = 256;  // corpus rows staged per pass

__host__ __device__ __forceinline__ int row_words(int m) {
  const int w = (m + 3) / 4;
  return w | 1;  // odd stride: lanes reading consecutive rows hit distinct banks
}

__device__ __forceinline__ int clamp_code(uint8_t c, int ksub) {
  return min((int)c, ksub - 1);
}
__device__ __forceinline__ int clamp_code(int32_t c, int ksub) {
  return min(max(c, 0), ksub - 1);
}

template <typename C>
__global__ void adc_topk_kernel(const float* __restrict__ lut,
                                const C* __restrict__ codes,
                                const uint8_t* __restrict__ valid, int B,
                                int64_t N, int m, int ksub, int k, int qgroups,
                                int64_t rows_per_split, float* __restrict__ out_v,
                                int* __restrict__ out_i, int splits) {
  const int QG = blockDim.x >> 5;  // one query per warp
  const int table = m * ksub;
  const int rs = row_words(m);
  extern __shared__ float4 smem4[];
  float* luts = reinterpret_cast<float*>(smem4);
  uint32_t* cs = reinterpret_cast<uint32_t*>(luts + QG * table);
  uint8_t* cb = reinterpret_cast<uint8_t*>(cs);
  float* topv = reinterpret_cast<float*>(cs + kTile * rs);
  int* topi = reinterpret_cast<int*>(topv + QG * k);

  const int qgi = blockIdx.x % qgroups;
  const int64_t split = blockIdx.x / qgroups;
  const int q0 = qgi * QG;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int qg = q0 + warp;
  const int64_t lo = split * rows_per_split;
  const int64_t hi = lo + rows_per_split < N ? lo + rows_per_split : N;

  for (int i = threadIdx.x; i < QG * table; i += blockDim.x) {
    const int q = q0 + i / table;
    luts[i] = q < B ? lut[(int64_t)q * table + i % table] : 0.f;
  }
  float* lv = topv + warp * k;
  int* li = topi + warp * k;
  list_init(lv, li, k, lane);
  float thr = kBig;
  const float* L = luts + warp * table;

  for (int64_t row0 = lo; row0 < hi; row0 += kTile) {
    const int rows = (int)(hi - row0 < kTile ? hi - row0 : kTile);
    __syncthreads();  // the previous tile is consumed (and the LUTs staged)
    const C* src = codes + row0 * m;
    for (int i = threadIdx.x; i < rows * m; i += blockDim.x) {
      const int r = i / m;
      cb[r * rs * 4 + (i - r * m)] = (uint8_t)clamp_code(src[i], ksub);
    }
    __syncthreads();
    if (qg >= B) continue;  // uniform across the warp
    for (int r0 = 0; r0 < rows; r0 += 32) {
      const int r = r0 + lane;
      float d = kBig;
      if (r < rows && valid[row0 + r]) {
        const uint32_t* w = cs + r * rs;
        d = 0.f;
        for (int j = 0; j < m; j += 4) {
          const uint32_t v = w[j >> 2];
#pragma unroll
          for (int s = 0; s < 4; ++s)
            if (j + s < m) d += L[(j + s) * ksub + ((v >> (8 * s)) & 0xffu)];
        }
      }
      thr = list_offer(lv, li, k, thr, d, (int)(row0 + r0), lane);
    }
  }

  if (qg >= B) return;
  const int64_t at = ((int64_t)qg * splits + split) * k;
  for (int e = lane; e < k; e += 32) {
    out_v[at + e] = lv[e];
    out_i[at + e] = li[e];
  }
}

template <typename C>
int launch(const float* lut, const void* codes, const uint8_t* valid, int B,
           int64_t N, int m, int ksub, int k, int warps,
           int64_t rows_per_split, int splits, float* out_v, int* out_i,
           cudaStream_t stream) {
  const int qgroups = (B + warps - 1) / warps;
  const int64_t grid = (int64_t)qgroups * splits;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)warps * m * ksub * sizeof(float) +
                      (size_t)kTile * row_words(m) * sizeof(uint32_t) +
                      (size_t)warps * k * (sizeof(float) + sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      adc_topk_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  adc_topk_kernel<C><<<(unsigned)grid, warps * 32, smem, stream>>>(
      lut, static_cast<const C*>(codes), valid, B, N, m, ksub, k, qgroups,
      rows_per_split, out_v, out_i, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// lut: f32 [B, m, ksub]; codes: uint8 (is_u8) or int32 [N, m]; valid: bool
// [N] as bytes; out_v / out_i: f32 / int32 [B, splits * k], split s covering
// rows [s * rows_per_split, ...). One warp per query, `warps` (1..8) queries
// per CTA; the CTA's dynamic shared memory is warps * (m * ksub * 4 + k * 8)
// + 256 * row_words(m) * 4 bytes. k <= 256, ksub <= 256. Returns the CUDA
// error code of the launch (0 on success).
extern "C" int vdb_adc_topk(const float* lut, const void* codes,
                            const uint8_t* valid, int B, long long N, int m,
                            int ksub, int k, int warps,
                            long long rows_per_split, int splits, int is_u8,
                            float* out_v, int* out_i, void* stream) {
  if (k < 1 || k > kMaxK || ksub < 1 || ksub > 256 || m < 1 || warps < 1 ||
      warps > 8)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  return is_u8 ? launch<uint8_t>(lut, codes, valid, B, N, m, ksub, k, warps,
                                 rows_per_split, splits, out_v, out_i, s)
               : launch<int32_t>(lut, codes, valid, B, N, m, ksub, k, warps,
                                 rows_per_split, splits, out_v, out_i, s);
}
