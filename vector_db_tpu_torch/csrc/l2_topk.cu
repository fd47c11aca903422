// Fused exact L2 scan with a running top-k per query.
//
// Replaces the Pallas TPU kernel vector_db_tpu/ops/pallas/l2_topk.py:l2_topk.
// The TPU kernel carries the top-k lists across its sequential grid; a CUDA
// grid runs its blocks in no order, so here each CTA owns one (query group,
// corpus split) pair, keeps a private top-k list per query, and writes it
// to [B, splits * k]. The wrapper merges those partial lists (a small
// torch.topk, as the JAX callers run lax.top_k after their kernels). The
// per-row scoring and the selection stay in this kernel; the [B, N]
// distance matrix never exists in device memory.
//
// Table dtype selects the formula:
//   f32  (exact_search): q_sq - 2 q.x + x_sq, clamped at 0
//        (vector_db_tpu/ops/distance.py:59-63), true f32 FMAs;
//   bf16 (approx_search_tiled): the query is cast to bf16, q_sq comes from
//        the f32 query, x_sq is supplied, no clamp
//        (vector_db_tpu/ops/exact.py:138-151).
// The Pallas dot at l2_topk.py:40 has no precision=HIGHEST and so truncated
// to bf16 on the TPU; this kernel does not: every product is an f32 FMA.
//
// What bounds it on the H100: f32 FMA issue. At B = 1000, N = 2^20,
// d = 768 the scan is 1.6e12 FMA-flops, ~24 ms at the CUDA cores' 67
// TFLOP/s, against a 3.2 GB (f32) or 1.6 GB (bf16) table read that takes
// ~1 ms; the register tile (tile_dot.cuh) reuses each staged value across
// 4 rows x QPW queries to keep shared-memory traffic under the FMA rate.
// Selection is cheap by construction: a candidate is tested against the
// list's current k-th value in registers, and only the few that pass
// (about k * ln(rows / k) per query and split) enter the warp-parallel
// sorted insertion. Tensor-core scoring is later work.
//
// Ties: within a split rows arrive in ascending order and an equal value is
// inserted after the entries already held, so the lower row wins.

#include "tile_dot.cuh"

using namespace vdb;

namespace {

constexpr int kMaxK = 256;
constexpr int kPerLane = kMaxK / 32;

// Insert (v, id) into the warp's ascending list of k entries, v < lv[k-1].
// Returns the new k-th value.
__device__ __noinline__ float insert(float* lv, int* li, int k, float v,
                                     int id, int lane) {
  float ov[kPerLane];
  int oi[kPerLane];
  int cnt = 0;
#pragma unroll
  for (int s = 0; s < kPerLane; ++s) {
    const int e = lane + 32 * s;
    if (e < k) {
      ov[s] = lv[e];
      oi[s] = li[e];
      cnt += ov[s] <= v;
    }
  }
  const int p = __reduce_add_sync(0xffffffffu, cnt);  // p < k
  __syncwarp();
#pragma unroll
  for (int s = 0; s < kPerLane; ++s) {
    const int e = lane + 32 * s;
    if (e >= p && e < k - 1) {
      lv[e + 1] = ov[s];
      li[e + 1] = oi[s];
    }
  }
  if (lane == 0) {
    lv[p] = v;
    li[p] = id;
  }
  __syncwarp();
  return lv[k - 1];
}

template <typename T, int QPW>
__global__ void __launch_bounds__(kThreads)
l2_topk_kernel(const T* __restrict__ q, const T* __restrict__ emb,
               const float* __restrict__ qsq, const float* __restrict__ xsq,
               const uint8_t* __restrict__ valid, int B, int64_t N, int d,
               int k, int qgroups, int64_t rows_per_split, int splits,
               float* __restrict__ out_v, int* __restrict__ out_i) {
  constexpr int QG = kWarps * QPW;
  constexpr bool kClamp = sizeof(T) == sizeof(float);
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float* qs = xs + kRows * kStride;
  float* topv = qs + QG * kStride;
  int* topi = reinterpret_cast<int*>(topv + QG * k);

  const int qgi = blockIdx.x % qgroups;
  const int64_t split = blockIdx.x / qgroups;
  const int q0 = qgi * QG;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t lo = split * rows_per_split;
  const int64_t hi = lo + rows_per_split < N ? lo + rows_per_split : N;

  // each warp owns the lists of its QPW queries: no CTA-wide sync on them
  float qsq_r[QPW];
  float thr[QPW];
#pragma unroll
  for (int qi = 0; qi < QPW; ++qi) {
    const int qg = q0 + warp * QPW + qi;
    qsq_r[qi] = qg < B ? qsq[qg] : 0.f;
    thr[qi] = kBig;
    for (int e = lane; e < k; e += 32) {
      topv[(warp * QPW + qi) * k + e] = kBig;
      topi[(warp * QPW + qi) * k + e] = -1;
    }
  }
  __syncwarp();

  for (int64_t row0 = lo; row0 < hi; row0 += kRows) {
    float acc[QPW][4];
#pragma unroll
    for (int qi = 0; qi < QPW; ++qi)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[qi][r] = 0.f;

    for (int c0 = 0; c0 < d; c0 += kChunk) {
      __syncthreads();
      stage(xs, emb, row0, kRows, hi, d, c0);
      stage(qs, q, q0, QG, B, d, c0);
      __syncthreads();
      tile_dot<QPW>(xs, qs, acc);
    }

    float xr[4];
    bool ok[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int64_t row = row0 + lane + 32 * r;
      ok[r] = row < hi && valid[row] != 0;
      xr[r] = ok[r] ? xsq[row] : 0.f;
    }

#pragma unroll
    for (int qi = 0; qi < QPW; ++qi) {
      const int qg = q0 + warp * QPW + qi;
      if (qg >= B) continue;  // uniform across the warp
      float* lv = topv + (warp * QPW + qi) * k;
      int* li = topi + (warp * QPW + qi) * k;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float dist = qsq_r[qi] - 2.f * acc[qi][r] + xr[r];
        if (kClamp) dist = fmaxf(dist, 0.f);
        if (!ok[r]) dist = kBig;
        unsigned want = __ballot_sync(0xffffffffu, dist < thr[qi]);
        while (want) {  // candidates in ascending row order
          const int src = __ffs(want) - 1;
          want &= want - 1;
          const float v = __shfl_sync(0xffffffffu, dist, src);
          if (v < thr[qi])
            thr[qi] = insert(lv, li, k, v, (int)(row0 + src + 32 * r), lane);
        }
      }
    }
  }

  const int64_t width = (int64_t)splits * k;
#pragma unroll
  for (int qi = 0; qi < QPW; ++qi) {
    const int qg = q0 + warp * QPW + qi;
    if (qg >= B) continue;
    for (int e = lane; e < k; e += 32) {
      const int64_t at = (int64_t)qg * width + split * k + e;
      out_v[at] = topv[(warp * QPW + qi) * k + e];
      out_i[at] = topi[(warp * QPW + qi) * k + e];
    }
  }
}

template <typename T, int QPW>
int launch(const void* q, const void* emb, const float* qsq, const float* xsq,
           const uint8_t* valid, int B, int64_t N, int d, int k,
           int64_t rows_per_split, int splits, float* out_v, int* out_i,
           cudaStream_t stream) {
  constexpr int QG = kWarps * QPW;
  const int qgroups = (B + QG - 1) / QG;
  const int64_t grid = (int64_t)qgroups * splits;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)(kRows + QG) * kStride * sizeof(float) +
                      (size_t)QG * k * (sizeof(float) + sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      l2_topk_kernel<T, QPW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  l2_topk_kernel<T, QPW><<<(unsigned)grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(emb), qsq, xsq, valid,
      B, N, d, k, qgroups, rows_per_split, splits, out_v, out_i);
  return (int)cudaGetLastError();
}

}  // namespace

// q: [B, d] in the table dtype; emb: [N, d]; qsq: f32[B] from the f32
// query; xsq: f32[N]; valid: bool[N] as bytes; out_v / out_i: f32 / int32
// [B, splits * k], split s covering rows [s * rows_per_split, ...).
// k <= 256. Returns the CUDA error code of the launch (0 on success).
extern "C" int vdb_l2_topk(const void* q, const void* emb, const float* qsq,
                           const float* xsq, const uint8_t* valid, int B,
                           long long N, int d, int k,
                           long long rows_per_split, int splits, int is_bf16,
                           float* out_v, int* out_i, void* stream) {
  if (k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  // 8 queries per warp while the lists are small; 4 above k = 64 keeps the
  // lists (QG * k * 8 bytes) within shared memory
  if (is_bf16) {
    return k <= 64
        ? launch<__nv_bfloat16, 8>(q, emb, qsq, xsq, valid, B, N, d, k, rows_per_split, splits, out_v, out_i, s)
        : launch<__nv_bfloat16, 4>(q, emb, qsq, xsq, valid, B, N, d, k, rows_per_split, splits, out_v, out_i, s);
  }
  return k <= 64
      ? launch<float, 8>(q, emb, qsq, xsq, valid, B, N, d, k, rows_per_split, splits, out_v, out_i, s)
      : launch<float, 4>(q, emb, qsq, xsq, valid, B, N, d, k, rows_per_split, splits, out_v, out_i, s);
}
