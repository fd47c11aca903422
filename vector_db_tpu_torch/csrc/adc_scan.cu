// Full-corpus ADC (asymmetric distance) scan with a running top-k per query:
// dist[b, n] = sum_j lut[b, j, codes[n, j]] over the valid rows n, plus two
// optional additive terms: row_bias[n] and group_bias[b, n / group]. The
// full-scan residual IVF-PQ (IvfIndex.search_batch at n_probe = k) runs on
// them: its rows are the cells' padded slots, flattened, row_bias the
// stored residual scalar and group_bias the (query, cell) coarse term, the
// cell's padded length being the group.
//
// Replaces the Pallas TPU kernel vector_db_tpu/ops/pallas/adc_scan.py:
// adc_topk. The TPU kernel turns the LUT gather into a [tile, m * ksub]
// one-hot matmul on the MXU and carries its top-k across a sequential grid
// by k serial min-extractions. On Hopper the gather is a shared-memory
// lookup, and what bounds the scan is the lookups themselves: B * N * m of
// them (2.1e9 at B = 128, N = 2^20, m = 16), 4 bytes each, at 128 bytes a
// clock per SM (the lookup floor); random codes add bank conflicts. The
// design:
//
// - LUTs interleaved. A CTA holds the f32 LUTs of Q queries (Q = 8 at
//   m = 16, ksub = 256: 128 KiB) as [m][ksub][Q]: one code's entries for
//   all Q queries are contiguous, so a lane reads its row's entry for 2
//   queries with one 8-byte load, and the 4 lanes of a row cover the 8
//   queries. A row's codes come into registers once (one uint4 at m = 16)
//   and are scored against every query the CTA holds. In a half-warp (4
//   rows x 4 lanes) each row reads 8 consecutive banks picked by its code
//   mod 4: two rows conflict only when those agree (2.1 wavefronts per 64
//   lookups on average, where the [Q][m][ksub] layout with a row per lane
//   takes ~3.5 per 32). Query slots past B read +inf: no row passes them.
// - m as a template constant (4, 8, 16, 32, 64; any other m takes the
//   generic instantiation): the lookup loop unrolls.
// - Codes as uint8 in [0, ksub). int32 codes, uint8 codes that may lie at
//   or above ksub (ksub < 256) and uint8 codes off the 16-byte alignment
//   are narrowed by a first pass (narrow_kernel: clamped into [0, ksub),
//   never wrapped) into a uint8 table of N * m bytes (16 MiB at N = 2^20),
//   which stays in L2 while the query groups re-read it; no lookup clamps.
// - A ring of tiles. Thread 0 keeps the next tiles of up to 512 rows (their
//   codes and mask bytes) in flight with 1-D bulk copies (cp.async.bulk)
//   completing on mbarriers; the lookups never read global memory.
// - Selection off the lookup path. A row at or under its query's k-th
//   value so far (the threshold) goes to a per-query candidate buffer (one
//   shared atomic per warp and query). Once a buffer holds more than a
//   list, the CTA merges every buffer into its list: a bitonic sort of
//   the buffer's (value, row) keys, then a bitonic merge with the
//   ascending list. About 8 short merges per split replace the
//   ~k ln(rows / k) serial inserts of a per-candidate list, and the
//   threshold stays fresh.
// - One CTA per SM (its LUTs fill shared memory), 16 warps, one wave:
//   each CTA owns one (query group, corpus split) pair; the wrapper merges
//   the [B, splits * k] lists. make_plan picks Q (up to 8, no more than B
//   needs, fewer where long lists take the room: k runs to 2048), the tile
//   (512 rows, down to 64 where m is large) and the ring's depth (4 tiles
//   down to 1) that fit in shared memory.
//
// Ties: keys order by (value, row), so equal values keep row order within
// a split; the wrapper's stable merge of the per-split lists keeps split
// order, so the lower row wins across splits too.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "topk_list.cuh"  // kBig

using namespace vdb;

namespace {

constexpr int kThreads = 512;  // 16 warps
// the longest list: at m = 16, ksub = 256 a CTA then holds 2 queries' LUTs
// beside their lists and buffers (make_plan halves Q until they fit)
constexpr int kMaxAdcK = 2048;
constexpr int kMaxTile = 512;  // rows a CTA scores between two barriers
static_assert(kMaxTile == kThreads, "a tile is one row per thread's step");

// queries a lane scores with one load (a float2), and lanes a row takes
__host__ __device__ constexpr int lane_queries(int q) {
  return q >= 2 ? 2 : q;
}
__host__ __device__ constexpr int lanes_per_row(int q) {
  return q / lane_queries(q);
}
// the length of a list the merges keep: a power of two >= k (and >= 32)
__host__ __device__ inline int list_len(int k) {
  int kl = 32;
  while (kl < k) kl <<= 1;
  return kl;
}

// A CTA's shape and the layout of its dynamic shared memory, from its base:
// the q LUTs, the ring of `stages` tiles (a tile's codes, then its mask
// bytes), the ring's mbarriers, q lists of kl keys, q candidate buffers of
// cap keys (a buffer holds at most kl entries before a tile adds its rows,
// so cap = 2 * max(kl, tile) never overflows), then the counts and the
// thresholds.
struct Layout {
  int q, m, ksub, tile, stages, kl, cap;
  __host__ __device__ int tile_bytes() const { return tile * (m + 1); }
  __host__ __device__ size_t ring() const {
    return ((size_t)m * ksub * q * sizeof(float) + 15) & ~(size_t)15;
  }
  __host__ __device__ size_t bars() const {
    return ring() + (size_t)stages * tile_bytes();  // 16-byte multiple
  }
  __host__ __device__ size_t list() const { return bars() + 4 * 8; }
  __host__ __device__ size_t buf() const {
    return list() + (size_t)q * kl * 8;
  }
  __host__ __device__ size_t misc() const {
    return buf() + (size_t)q * cap * 8;
  }
  __host__ __device__ size_t total() const { return misc() + 2 * q * 4; }
};

// A (value, row) pair as one 64-bit key in (value, row) order: the value's
// bits mapped to an order-preserving uint32 above the row as uint32, so a
// pad (kBig, -1) sorts after every real row of the same value
__device__ __forceinline__ uint64_t make_key(float v, int row) {
  const uint32_t u = __float_as_uint(v);
  const uint32_t o = (u & 0x80000000u) ? ~u : u | 0x80000000u;
  return ((uint64_t)o << 32) | (uint32_t)row;
}
__device__ __forceinline__ float key_value(uint64_t key) {
  const uint32_t o = (uint32_t)(key >> 32);
  return __uint_as_float((o & 0x80000000u) ? o & 0x7fffffffu : ~o);
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// A CTA-wide bitonic step on Q arrays of n keys, `pitch` apart: compare-
// exchange at distance `stride` within sequences of `size` (ascending where
// (index & size) == 0, so all ascending at size = n).
template <int Q>
__device__ __forceinline__ void bitonic_step(uint64_t* key, int pitch, int n,
                                             int size, int stride) {
  const int lg = __ffs(n) - 2;  // log2(n / 2); n is a power of two
  for (int t = threadIdx.x; t < Q << lg; t += kThreads) {
    const int q = t >> lg, i = t & ((1 << lg) - 1);
    const int lo = 2 * i - (i & (stride - 1));
    uint64_t* kq = key + q * pitch;
    const uint64_t a = kq[lo], b = kq[lo + stride];
    if ((b < a) == ((lo & size) == 0)) {
      kq[lo] = b;
      kq[lo + stride] = a;
    }
  }
  __syncthreads();
}

// Merge every query's candidate buffer into its ascending list of kl keys
// (a power of two >= k); reset the buffers and refresh the thresholds.
template <int Q>
__device__ void merge_buffers(uint64_t* list, uint64_t* buf, int* cnt,
                              float* thr, int k, int kl, int cap) {
  int most = 0;
#pragma unroll
  for (int q = 0; q < Q; ++q) most = max(most, cnt[q]);
  int n = kl;
  while (n < most) n <<= 1;  // <= cap
  const int lg = __ffs(n) - 1;
  for (int t = threadIdx.x; t < Q << lg; t += kThreads) {
    const int q = t >> lg, i = t & (n - 1);
    if (i >= cnt[q]) buf[q * cap + i] = ~0ull;
  }
  __syncthreads();
  for (int size = 2; size <= n; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1)
      bitonic_step<Q>(buf, cap, n, size, stride);
  // the kl smallest of list + buffer, as one bitonic sequence
  const int lgl = __ffs(kl) - 1;
  for (int t = threadIdx.x; t < Q << lgl; t += kThreads) {
    const int q = t >> lgl, i = t & (kl - 1);
    const uint64_t b = buf[q * cap + kl - 1 - i];
    uint64_t* l = list + q * kl + i;
    if (b < *l) *l = b;
  }
  __syncthreads();
  for (int stride = kl >> 1; stride > 0; stride >>= 1)  // all ascending
    bitonic_step<Q>(list, kl, kl, kl, stride);
  if (threadIdx.x < Q) {
    const uint64_t kth = list[threadIdx.x * kl + k - 1];
    cnt[threadIdx.x] = 0;
    thr[threadIdx.x] = key_value(kth);
  }
  __syncthreads();
}

// The lane's row codes and lookups: G consecutive queries of Q.
template <int M, int Q, int G>
__device__ __forceinline__ void score_row(const float* __restrict__ lut_s,
                                          const uint8_t* row_codes, int m,
                                          int ksub, int qoff,
                                          float (&acc)[G]) {
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.f;
  auto add = [&](int j, uint32_t c) {
    const float* e = lut_s + ((j * ksub + (int)c) * Q + qoff);
    if constexpr (G == 2) {
      const float2 v = *reinterpret_cast<const float2*>(e);
      acc[0] += v.x;
      acc[1] += v.y;
    } else {
      acc[0] += *e;
    }
  };
  if constexpr (M == 0) {
    for (int j = 0; j < m; ++j) add(j, row_codes[j]);
  } else if constexpr (M == 4) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(row_codes);
#pragma unroll
    for (int s = 0; s < 4; ++s) add(s, (w >> (8 * s)) & 0xffu);
  } else if constexpr (M == 8) {
    const uint2 w = *reinterpret_cast<const uint2*>(row_codes);
#pragma unroll
    for (int s = 0; s < 4; ++s) add(s, (w.x >> (8 * s)) & 0xffu);
#pragma unroll
    for (int s = 0; s < 4; ++s) add(4 + s, (w.y >> (8 * s)) & 0xffu);
  } else {
#pragma unroll
    for (int c16 = 0; c16 < M / 16; ++c16) {
      const uint4 w = reinterpret_cast<const uint4*>(row_codes)[c16];
      const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int s = 0; s < 4; ++s)
          add(c16 * 16 + u * 4 + s, (words[u] >> (8 * s)) & 0xffu);
    }
  }
}

template <int M, int Q>
__global__ void __launch_bounds__(kThreads, 1)
adc_scan_kernel(const float* __restrict__ lut,
                const uint8_t* __restrict__ codes,
                const uint8_t* __restrict__ valid,
                const float* __restrict__ row_bias,
                const float* __restrict__ group_bias, int64_t group,
                int64_t ngroups, int B, int64_t N, const Layout L, int k,
                int qgroups, int64_t rows_per_split,
                float* __restrict__ out_v, int* __restrict__ out_i,
                int splits) {
  constexpr int G = lane_queries(Q);
  constexpr int kLanesPerRow = lanes_per_row(Q);
  constexpr int kRowsPerWarp = 32 / kLanesPerRow;
  constexpr int kRowsPerStep = kThreads / kLanesPerRow;
  const int m = M ? M : L.m;
  const int ksub = L.ksub, tile = L.tile, stages = L.stages;
  const int kl = L.kl, cap = L.cap;

  extern __shared__ __align__(128) uint8_t smem[];
  float* lut_s = reinterpret_cast<float*>(smem);
  uint8_t* ring = smem + L.ring();
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars());
  uint64_t* list = reinterpret_cast<uint64_t*>(smem + L.list());
  uint64_t* buf = reinterpret_cast<uint64_t*>(smem + L.buf());
  int* cnt = reinterpret_cast<int*>(smem + L.misc());
  float* thr = reinterpret_cast<float*>(cnt + Q);

  const int qg = blockIdx.x % qgroups;
  const int64_t split = blockIdx.x / qgroups;
  const int q0 = qg * Q;
  const int64_t lo = split * rows_per_split;
  const int64_t hi = lo + rows_per_split < N ? lo + rows_per_split : N;
  const int ntiles = (int)((hi - lo + tile - 1) / tile);
  const int tid = threadIdx.x;

  // the ring's producer: tile u of the split (its codes, then its mask
  // bytes) into slot u % stages; a tail that is not a multiple of 16 bytes
  // is copied by this thread's stores
  auto issue = [&](int u) {
    const int s = u % stages;
    const int64_t r0 = lo + (int64_t)u * tile;
    const int rows = (int)(hi - r0 < tile ? hi - r0 : tile);
    uint8_t* dst = ring + (size_t)s * L.tile_bytes();
    const uint32_t bar = smem_u32(full + s);
    const uint8_t* src[2] = {codes + r0 * m, valid + r0};
    uint8_t* to[2] = {dst, dst + tile * m};
    const uint32_t bytes[2] = {(uint32_t)(rows * m), (uint32_t)rows};
    uint32_t tx = 0;
    for (int a = 0; a < 2; ++a) {
      const uint32_t bulk = bytes[a] & ~15u;
      for (uint32_t b = bulk; b < bytes[a]; ++b) to[a][b] = src[a][b];
      tx += bulk;
    }
    mbar_expect_tx(bar, tx);
    for (int a = 0; a < 2; ++a)
      if (bytes[a] & ~15u)
        bulk_copy(smem_u32(to[a]), src[a], bytes[a] & ~15u, bar);
  };

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(smem_u32(full + s), 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0)
    for (int u = 0; u < stages && u < ntiles; ++u) issue(u);

  // LUTs, interleaved [m][ksub][Q]; query slots past B read +inf, so their
  // rows never pass a threshold (and their lists are never written)
  for (int e = tid; e < m * ksub * Q; e += kThreads) {
    const int q = e % Q, jc = e / Q;  // jc = j * ksub + c
    const int b = q0 + q;
    lut_s[e] = b < B ? lut[(int64_t)b * m * ksub + jc]
                     : __int_as_float(0x7f800000);
  }
  for (int e = tid; e < Q * kl; e += kThreads) list[e] = make_key(kBig, -1);
  if (tid < Q) {
    cnt[tid] = 0;
    thr[tid] = kBig;
  }
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5;
  const int r_local = warp * kRowsPerWarp + lane / kLanesPerRow;
  // the lanes of the warp that score the same queries as this one
  constexpr unsigned kEvery = kLanesPerRow == 1   ? 0xffffffffu
                             : kLanesPerRow == 2 ? 0x55555555u
                             : kLanesPerRow == 4 ? 0x11111111u
                                                 : 0x01010101u;
  const unsigned same = kEvery << (lane % kLanesPerRow);
  const int qoff = (lane % kLanesPerRow) * G;
  const bool biased = row_bias != nullptr || group_bias != nullptr;
  for (int u = 0; u < ntiles; ++u) {
    const int s = u % stages;
    const int64_t r0 = lo + (int64_t)u * tile;
    const int rows = (int)(hi - r0 < tile ? hi - r0 : tile);
    mbar_wait(smem_u32(full + s), (uint32_t)((u / stages) & 1));
    float t[G];
#pragma unroll
    for (int g = 0; g < G; ++g) t[g] = thr[qoff + g];
    const uint8_t* slot = ring + (size_t)s * L.tile_bytes();
#pragma unroll
    for (int st = 0; st < kLanesPerRow; ++st) {
      if (st * kRowsPerStep >= rows) break;  // uniform across the CTA
      const int rl = st * kRowsPerStep + r_local;
      const bool in = rl < rows;
      const int64_t row = r0 + rl;
      float acc[G];
      const bool ok = in && slot[tile * m + rl] != 0;
      if (in) score_row<M, Q, G>(lut_s, slot + rl * m, m, ksub, qoff, acc);
      // the additive terms, in the plain version's order: the LUT sum, then
      // the row's term, then the group's (slots past B stay +inf)
      if (biased && ok) {
        const float rb = row_bias ? __ldg(row_bias + row) : 0.f;
        const int64_t grp = row / group;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int b = q0 + qoff + g;
          const float gb = group_bias && b < B
                               ? __ldg(group_bias + (int64_t)b * ngroups + grp)
                               : 0.f;
          acc[g] = (acc[g] + rb) + gb;
        }
      }
      // candidates at or under the threshold into the buffers: one shared
      // atomic per (warp, query) gives each lane its place
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const bool pass = ok && acc[g] <= t[g];
        const unsigned mine = __ballot_sync(0xffffffffu, pass) & same;
        const int leader = __ffs(mine) - 1;
        int at = 0;
        if (lane == leader) at = atomicAdd(cnt + qoff + g, __popc(mine));
        at = __shfl_sync(0xffffffffu, at, leader < 0 ? lane : leader) +
             __popc(mine & ((1u << lane) - 1u));
        if (pass) buf[(qoff + g) * cap + at] = make_key(acc[g], (int)row);
      }
    }
    const bool last = u + 1 == ntiles;
    __syncthreads();  // slot s consumed; the buffers hold this tile's rows
    if (tid == 0 && u + stages < ntiles) {
      fence_async_smem();
      issue(u + stages);
    }
    // merge once a buffer holds more than a list (at most kl + tile
    // entries then: it never overflows), so thresholds stay fresh and each
    // sort stays short
    if (__syncthreads_or(tid < Q && cnt[tid] > (last ? 0 : kl)))
      merge_buffers<Q>(list, buf, cnt, thr, k, kl, cap);
  }

  for (int e = tid; e < Q * k; e += kThreads) {
    const int q = e / k, i = e - q * k;
    if (q0 + q >= B) continue;
    const int64_t at = ((int64_t)(q0 + q) * splits + split) * k + i;
    const uint64_t key = list[q * kl + i];
    out_v[at] = key_value(key);
    out_i[at] = (int)(uint32_t)key;
  }
}

// codes (int32, or uint8) [N, m] -> uint8 [N, m], clamped into [0, ksub)
template <typename C>
__global__ void narrow_kernel(const C* __restrict__ src,
                              uint8_t* __restrict__ dst, int64_t count,
                              int ksub) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += step) {
    const int c = (int)src[i];
    dst[i] = (uint8_t)min(max(c, 0), ksub - 1);
  }
}

// What one call launches: the CTA's layout, the corpus splits, and whether
// the codes (narrowed) and the mask (copied) go through the scratch.
struct Plan {
  Layout L;
  int64_t rows_per_split;
  int splits;  // 0: one query's LUT and list do not fit in shared memory
  bool narrow, copy_mask;
  int64_t scratch;  // bytes: the narrowed table, then the mask copy
};

int make_plan(int B, int64_t N, int m, int ksub, int k, const void* codes,
              int is_u8, const void* valid, Plan* p) {
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  *p = Plan{};
  // most queries a CTA holds first (fewest LUT stagings), then the longest
  // tile, then the deepest ring
  int q = 1;
  while (q < B && q < 8) q <<= 1;
  const int kl = list_len(k);
  bool fits = false;
  for (; q >= 1 && !fits; q >>= 1)
    for (int tile = kMaxTile; tile >= 64 && !fits; tile >>= 1)
      for (int stages = 4; stages >= 1 && !fits; --stages) {
        const int cap = 2 * (kl > tile ? kl : tile);
        p->L = Layout{q, m, ksub, tile, stages, kl, cap};
        fits = p->L.total() <= (size_t)optin;
      }
  if (!fits) return 0;
  const int64_t tile = p->L.tile;
  const int64_t groups = (B + p->L.q - 1) / p->L.q;
  const int64_t tiles = (N + tile - 1) / tile;
  // one wave of one CTA per SM: long splits warm up few candidate lists
  int64_t splits = sms / groups > 1 ? sms / groups : 1;
  if (splits > tiles) splits = tiles;
  p->rows_per_split = (tiles + splits - 1) / splits * tile;
  p->splits = (int)((N + p->rows_per_split - 1) / p->rows_per_split);
  // the scan reads codes in [0, ksub) by 16-byte bulk copies, and the mask
  // the same way
  p->narrow = !is_u8 || ksub < 256 || (uintptr_t)codes % 16 != 0;
  p->copy_mask = (uintptr_t)valid % 16 != 0;
  p->scratch = (p->narrow ? (N * m + 15) / 16 * 16 : 0) +
               (p->copy_mask ? N : 0);
  return 0;
}

// the optional additive terms of a launch (null pointers: none)
struct Bias {
  const float* row;
  const float* group_v;
  int64_t group, ngroups;
};

template <int M, int Q>
int launch_scan(const float* lut, const uint8_t* codes, const uint8_t* valid,
                const Bias& bias, int B, int64_t N, int k, const Plan& p,
                float* out_v, int* out_i, cudaStream_t stream) {
  const int qgroups = (B + Q - 1) / Q;
  const int64_t grid = (int64_t)qgroups * p.splits;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = p.L.total();
  static size_t granted = 48 * 1024;  // needs no attribute up to 48 KiB
  if (smem > granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        adc_scan_kernel<M, Q>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    granted = smem;
  }
  adc_scan_kernel<M, Q><<<(unsigned)grid, kThreads, smem, stream>>>(
      lut, codes, valid, bias.row, bias.group_v, bias.group, bias.ngroups, B,
      N, p.L, k, qgroups, p.rows_per_split, out_v, out_i, p.splits);
  return (int)cudaGetLastError();
}

template <int Q>
int launch_m(const float* lut, const uint8_t* codes, const uint8_t* valid,
             const Bias& bias, int B, int64_t N, int k, const Plan& p,
             float* out_v, int* out_i, cudaStream_t s) {
#define VDB_SCAN(MM) \
  launch_scan<MM, Q>(lut, codes, valid, bias, B, N, k, p, out_v, out_i, s)
  switch (p.L.m) {
    case 4: return VDB_SCAN(4);
    case 8: return VDB_SCAN(8);
    case 16: return VDB_SCAN(16);
    case 32: return VDB_SCAN(32);
    case 64: return VDB_SCAN(64);
    default: return VDB_SCAN(0);
  }
#undef VDB_SCAN
}

bool bad_args(int B, long long N, int m, int ksub, int k) {
  return B < 0 || N < 0 || k < 1 || k > kMaxAdcK || ksub < 1 || ksub > 256 ||
         m < 1;
}

}  // namespace

// The launch vdb_adc_topk makes for these arguments: *splits corpus splits
// (its outputs are [B, splits * k]; 0 when one query's LUT, list and
// buffer do not fit in shared memory) and *scratch bytes of uint8 scratch
// it needs (0: none). codes and valid are the pointers that call will get
// (their alignment decides the scratch). Returns a CUDA error code (0 on
// success).
extern "C" int vdb_adc_topk_plan(int B, long long N, int m, int ksub, int k,
                                 const void* codes, int is_u8,
                                 const void* valid, int* splits,
                                 long long* scratch) {
  if (bad_args(B, N, m, ksub, k)) return (int)cudaErrorInvalidValue;
  Plan p;
  const int err = make_plan(B, N, m, ksub, k, codes, is_u8, valid, &p);
  *splits = p.splits;
  *scratch = p.scratch;
  return err;
}

// lut: f32 [B, m, ksub]; codes: int32 [N, m] (is_u8 = 0) or uint8 [N, m]
// (is_u8 = 1); valid: bool [N] as bytes; row_bias: f32 [N] or null;
// group_bias: f32 [B, ceil(N / group)] or null (group >= 1); scratch: the bytes
// vdb_adc_topk_plan asked for; out_v / out_i: f32 / int32 [B, splits * k],
// split s the lists of rows [s * N_s, (s + 1) * N_s) for N_s =
// ceil(N / splits) rounded up to a tile. k <= 2048, ksub <= 256. Returns the
// CUDA error code of the launches (0 on success).
extern "C" int vdb_adc_topk(const float* lut, const void* codes, int is_u8,
                            const uint8_t* valid, const float* row_bias,
                            const float* group_bias, long long group, int B,
                            long long N, int m, int ksub, int k,
                            uint8_t* scratch, float* out_v, int* out_i,
                            void* stream) {
  if (bad_args(B, N, m, ksub, k) || group < 1)
    return (int)cudaErrorInvalidValue;
  const Bias bias{row_bias, group_bias, group, (N + group - 1) / group};
  if (B == 0 || N == 0) return 0;
  Plan p;
  int err = make_plan(B, N, m, ksub, k, codes, is_u8, valid, &p);
  if (err != 0) return err;
  if (p.splits == 0) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const uint8_t* table = static_cast<const uint8_t*>(codes);
  if (p.narrow) {
    const int64_t count = (int64_t)N * m;
    const int64_t want = (count + 4 * 256 - 1) / (4 * 256);
    const int blocks = want < 4096 ? (int)want : 4096;
    if (is_u8)
      narrow_kernel<uint8_t><<<blocks, 256, 0, s>>>(
          static_cast<const uint8_t*>(codes), scratch, count, ksub);
    else
      narrow_kernel<int32_t><<<blocks, 256, 0, s>>>(
          static_cast<const int32_t*>(codes), scratch, count, ksub);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
    table = scratch;
  }
  if (p.copy_mask) {
    uint8_t* mask = scratch + (p.narrow ? (N * m + 15) / 16 * 16 : 0);
    err = (int)cudaMemcpyAsync(mask, valid, N, cudaMemcpyDeviceToDevice, s);
    if (err != 0) return err;
    valid = mask;
  }
  switch (p.L.q) {
#define VDB_Q(QQ) \
  launch_m<QQ>(lut, table, valid, bias, B, N, k, p, out_v, out_i, s)
    case 8: return VDB_Q(8);
    case 4: return VDB_Q(4);
    case 2: return VDB_Q(2);
    default: return VDB_Q(1);
#undef VDB_Q
  }
}
