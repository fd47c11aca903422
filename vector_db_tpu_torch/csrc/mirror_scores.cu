// Mirror scores of gathered rows, the wide beam's candidate scoring:
// out[b, j] = sum over d of bf16 aug[idx[b, j], d] (widened to f32) times
// f32 qa[b, d], summed in the fixed halving order of the plain version.
//
// Replaces no Pallas kernel: the JAX package scores these rows with an
// XLA-fused jnp.einsum over the gathered rows
// (vector_db_tpu/index/wide_beam.py:285). The plain PyTorch chain (gather,
// widening copy, product, seven halving adds) writes and reads every row
// again at each step: ~28 GB of traffic for the 1.9 GB of rows a wide-beam
// step at B = 1024, K = 7,168 candidates, dpa = 128 gathers.
//
// The contract is bit-identity with mirror_scores_plain
// (ops/cuda/mirror_scores.py), not a tolerance: the wide beam's window
// dedup voids duplicate copies of a slot by their adjacent, equal scores,
// so a row must get the same bits in any step, chunk or batch shape, on the
// card and on the CPU. So: each product is one __fmul_rn of the widened
// bf16 value and qa's f32 value, each sum one __fadd_rn (no FMA
// contraction, no flush of denormals: the build has no fast-math flag),
// and the pairs are the plain version's: at width w, h = w / 2, s[i] =
// p[i] + p[i + h] for i < h, then s[0] += p[2h] when w is odd, down to one
// value. An id outside [0, N) (the callers' -1) scores row 0, as the plain
// version's clamp does for -1; the callers mask those scores. The ids'
// rows are read at any row stride: 0 reads one row for the whole batch,
// the wide beam's seed set broadcast over its queries, with no copy.
//
// What bounds it on the H100: device memory. Each gathered row is read
// once (256 B at dpa = 128) and each score written once: 1.94 GB a step at
// the shape above, 0.58 ms at 3.35 TB/s. That is the rate of the gathered
// bytes, not a floor: a row gathered again may come from L2, and the
// distinct rows, ids and scores of that step are ~0.33 GB. The work is a random gather at
// ~1 flop a byte, so the design is about bytes and loads in flight:
// - dpa = 128, both tables 16-byte aligned (the wide beam's mirror): four
//   lanes a row, each lane loading four 16-byte chunks (chunk 4m + l for
//   lane l, m = 0..3), so one warp load instruction takes 64 contiguous
//   bytes of each of 8 rows. The column index splits as 32m + 8l + e, and
//   the halving order maps onto it: +64 and +32 pair chunks inside a lane,
//   +16 and +8 pair lanes l and l + 2, then l and l + 1 (two shuffles), +4,
//   +2 and +1 pair values inside lane 0. qa's 32 columns of a lane live in
//   registers for the CTA's whole tile of one query; ids are read as int32
//   one round ahead, and each warp keeps two groups of 8 rows (32 KiB a
//   CTA) in flight;
// - any other width (or unaligned tables): one warp a row; the first
//   level is taken straight from the row (p[i] + p[i + h] as products),
//   the rest of the halving runs in the warp's w / 2 floats of shared
//   memory. Every width the port makes (dims + 8: 128, 136, 392, 776,
//   the PQ mirror's own) is served by the one schedule, read from dpa.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

// the dpa = 128 path
constexpr int kWidth = 128;
constexpr int kLanesRow = 4;                 // lanes a row
constexpr int kRowsGroup = 32 / kLanesRow;   // rows a warp load instruction
constexpr int kInFlight = 2;                 // groups a warp keeps in flight
constexpr int kRound = kWarps * kRowsGroup * kInFlight;  // rows a CTA round
constexpr int kTile = 4 * kRound;            // rows of one query a CTA

// the generic path
constexpr int kTileAny = 64;                 // rows of one query a CTA
constexpr size_t kMaxSmem = 232448;          // a CTA's shared memory

__device__ __forceinline__ long long row_of(int id, long long n) {
  return (id >= 0 && id < n) ? id : 0;
}

// the bf16 in the low / high half of a word, widened exactly
__device__ __forceinline__ float lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ float bf16_at(const uint16_t* row, int d) {
  return __uint_as_float(static_cast<uint32_t>(__ldg(row + d)) << 16);
}

// the 8 columns of one 16-byte chunk, each times its query value
__device__ __forceinline__ void products(const uint4& v, const float* q,
                                         float* p) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    p[2 * i] = __fmul_rn(lo(w[i]), q[2 * i]);
    p[2 * i + 1] = __fmul_rn(hi(w[i]), q[2 * i + 1]);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
mirror128_kernel(const uint4* __restrict__ aug, long long n,
                 const int* __restrict__ idx, long long idx_stride,
                 const float* __restrict__ qa, int K, int tiles,
                 float* __restrict__ out) {
  const int b = blockIdx.x / tiles;
  const int t0 = (blockIdx.x % tiles) * kTile;
  const int end = min(t0 + kTile, K);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int l = lane & (kLanesRow - 1), r = lane / kLanesRow;

  // this lane's query columns: chunk 4m + l, 8 values each
  float q[4][8];
  const float4* qrow =
      reinterpret_cast<const float4*>(qa + (long long)b * kWidth);
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const float4 a = __ldg(qrow + 2 * (4 * m + l));
    const float4 c = __ldg(qrow + 2 * (4 * m + l) + 1);
    q[m][0] = a.x; q[m][1] = a.y; q[m][2] = a.z; q[m][3] = a.w;
    q[m][4] = c.x; q[m][5] = c.y; q[m][6] = c.z; q[m][7] = c.w;
  }
  const int* ids_b = idx + b * idx_stride;
  float* out_b = out + (long long)b * K;

  // warp-uniform loop: lane (r, l) takes rows g + u * 8 + r
  int g = t0 + warp * kRowsGroup * kInFlight;
  int ids[kInFlight];
#pragma unroll
  for (int u = 0; u < kInFlight; ++u) {
    const int j = g + u * kRowsGroup + r;
    ids[u] = j < end ? __ldg(ids_b + j) : 0;
  }
  for (; g < end; g += kRound) {
    uint4 v[kInFlight][4];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const uint4* row = aug + row_of(ids[u], n) * (kWidth / 8);
#pragma unroll
      for (int m = 0; m < 4; ++m) v[u][m] = __ldg(row + 4 * m + l);
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {  // the next round's ids
      const int j = g + kRound + u * kRowsGroup + r;
      ids[u] = j < end ? __ldg(ids_b + j) : 0;
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      float p[4][8], s[8];
#pragma unroll
      for (int m = 0; m < 4; ++m) products(v[u][m], q[m], p[m]);
#pragma unroll
      for (int e = 0; e < 8; ++e)  // +64 (chunk m + 2), then +32 (m + 1)
        s[e] = __fadd_rn(__fadd_rn(p[0][e], p[2][e]),
                         __fadd_rn(p[1][e], p[3][e]));
#pragma unroll
      for (int e = 0; e < 8; ++e)  // +16: lane l + 2
        s[e] = __fadd_rn(s[e], __shfl_down_sync(0xffffffffu, s[e], 2,
                                                kLanesRow));
#pragma unroll
      for (int e = 0; e < 8; ++e)  // +8: lane l + 1
        s[e] = __fadd_rn(s[e], __shfl_down_sync(0xffffffffu, s[e], 1,
                                                kLanesRow));
#pragma unroll
      for (int e = 0; e < 4; ++e) s[e] = __fadd_rn(s[e], s[e + 4]);  // +4
#pragma unroll
      for (int e = 0; e < 2; ++e) s[e] = __fadd_rn(s[e], s[e + 2]);  // +2
      s[0] = __fadd_rn(s[0], s[1]);                                  // +1
      const int j = g + u * kRowsGroup + r;
      if (l == 0 && j < end) out_b[j] = s[0];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
mirror_any_kernel(const uint16_t* __restrict__ aug, long long n, int dpa,
                  const int* __restrict__ idx, long long idx_stride,
                  const float* __restrict__ qa, int K, int tiles,
                  float* __restrict__ out) {
  extern __shared__ float buf[];
  const int b = blockIdx.x / tiles;
  const int t0 = (blockIdx.x % tiles) * kTileAny;
  const int end = min(t0 + kTileAny, K);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int h0 = dpa >> 1;
  float* p = buf + (size_t)warp * (h0 > 0 ? h0 : 1);
  const float* q = qa + (long long)b * dpa;
  const int* ids_b = idx + b * idx_stride;

  for (int j = t0 + warp; j < end; j += warps) {
    const uint16_t* row = aug + row_of(__ldg(ids_b + j), n) * dpa;
    if (h0 == 0) {  // one column: the score is its product
      if (lane == 0)
        out[(long long)b * K + j] = __fmul_rn(bf16_at(row, 0), __ldg(q));
      continue;
    }
    // the first level, from the row: p[i] + p[i + h], and p[2h] into s[0]
    // when the width is odd
    for (int i = lane; i < h0; i += 32) {
      float s = __fadd_rn(__fmul_rn(bf16_at(row, i), __ldg(q + i)),
                          __fmul_rn(bf16_at(row, i + h0), __ldg(q + i + h0)));
      if (i == 0 && (dpa & 1))
        s = __fadd_rn(s, __fmul_rn(bf16_at(row, 2 * h0), __ldg(q + 2 * h0)));
      p[i] = s;
    }
    // in place: level w writes [0, h) and reads [h, 2h], so no lane reads
    // what another writes within a level
    for (int w = h0; w > 1; w >>= 1) {
      __syncwarp();
      const int h = w >> 1;
      for (int i = lane; i < h; i += 32) {
        float s = __fadd_rn(p[i], p[i + h]);
        if (i == 0 && (w & 1)) s = __fadd_rn(s, p[2 * h]);
        p[i] = s;
      }
    }
    __syncwarp();
    if (lane == 0) out[(long long)b * K + j] = p[0];
    __syncwarp();  // the next row overwrites p
  }
}

}  // namespace

// aug: bf16 [n, dpa]; idx: int32 [B, K], row b at idx + b * idx_stride;
// qa: f32 [B, dpa]; out: f32 [B, K].
extern "C" int vdb_mirror_scores(const void* aug, long long n, int dpa,
                                 const int* idx, long long idx_stride,
                                 const float* qa, int B, int K, float* out,
                                 void* stream) {
  if (n < 1 || dpa < 1 || B < 0 || K < 0 || idx_stride < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || K == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const bool aligned = (uintptr_t)aug % 16 == 0 && (uintptr_t)qa % 16 == 0;
  if (dpa == kWidth && aligned) {
    const int tiles = (K + kTile - 1) / kTile;
    if ((long long)tiles * B > 0x7fffffffLL)
      return (int)cudaErrorInvalidValue;
    mirror128_kernel<<<tiles * B, kThreads, 0, s>>>(
        static_cast<const uint4*>(aug), n, idx, idx_stride, qa, K, tiles,
        out);
    return (int)cudaGetLastError();
  }
  const size_t per_warp = sizeof(float) * (size_t)(dpa / 2 > 0 ? dpa / 2 : 1);
  int warps = kWarps;
  while (warps > 1 && warps * per_warp > kMaxSmem) --warps;
  const size_t smem = warps * per_warp;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mirror_any_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int tiles = (K + kTileAny - 1) / kTileAny;
  if ((long long)tiles * B > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  mirror_any_kernel<<<tiles * B, 32 * warps, smem, s>>>(
      static_cast<const uint16_t*>(aug), n, dpa, idx, idx_stride, qa, K,
      tiles, out);
  return (int)cudaGetLastError();
}
