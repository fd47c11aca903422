// Per-block selection scan: phase 1 of the block-select searches.
//
// Replaces two Pallas TPU kernels:
//   vector_db_tpu/ops/pallas/block_topm.py:block_topm_scan (m smallest per
//     128-row block, with their global rows)  -> kIdx = true
//   vector_db_tpu/ops/pallas/block_min.py:block_min_scan (the block
//     minimum only)                            -> kIdx = false, m = 1
// Both score xsq_eff[row] + (-2 q) . x[row]; the caller folds row validity
// into xsq_eff (~2e38 for an invalid row) and the wrapper pre-scales the
// query by -2 and casts it to the table dtype, as block_topm.py:113 does.
// Only [B, N/128 * m] leaves the chip: the [B, N] score panel never exists
// in device memory.
//
// What bounds it on the H100: tensor-core issue. At B = 1000, N = 2^20,
// ds = 128 (FlatIndex's PCA mirror, always bf16) the scan is 2.68e11 flop:
// 0.271 ms at the bf16 rate (989 TFLOP/s); one read of the 256 MB table
// takes 0.08 ms and the m = 2 outputs (131 MB) 0.04 ms. In practice three
// things set its time, in this order: the selection after each tile
// (about 600 compares and selects per thread at m = 2), the copies from L2
// into shared memory (each of the 8 query groups reads every tile), and
// the products, whose issue stalls the issuing warp while the tensor
// cores are busy.
//
// bf16 table, ds <= 256 (block_select_tc):
//   * products: wgmma.mma_async m64n128k16, bf16 operands, f32
//     accumulators. The CTA's 128 queries are A (the M side, 64 for each of
//     two consumer warpgroups), one 128-row corpus tile (one block) is B
//     (the N side); both are read from 128-byte-swizzled shared memory
//     through descriptors, the table row-major [N, ds], which is K-major
//     for B. bf16 x bf16 products are exact in f32; the sum runs in the
//     tensor core's order. Each warpgroup keeps two accumulators and issues
//     the next tile's group in two halves with the selection of the
//     previous tile between and after them. The accumulators are only read:
//     a non-wgmma write to one while a group is in flight makes ptxas
//     serialize the wgmmas. The producer warpgroup gives up registers
//     (setmaxnreg) so that the consumers hold both accumulators;
//   * copies: the query group is copied once and stays resident; the
//     corpus tiles stream through a ring of 2-8 stages, each the tile's
//     chunks of 128 bytes of columns plus its 128 xsq_eff values. One
//     producer warp fills a stage: the lanes write the xsq_eff slice (2e38
//     past N), one thread issues the 2-D TMA copies (zeros past N and past
//     ds, so a padding row scores exactly 2e38 + 0), and all arrive on the
//     stage's mbarrier. Rows that TMA cannot take (not 16-byte aligned, or
//     narrower than 128 bytes) are filled with element loads instead;
//   * selection in registers: in the accumulator layout a thread holds two
//     queries and, for each, columns 8c + 2t + {0, 1} of the tile (lane
//     4g + t), so one query's 128 scores of one block sit in the four
//     lanes of a quad, 32 per thread. Each round, each thread reduces its
//     32 scores by a tree to its best (block_min: its minimum, once), with
//     the earlier rounds' winners read as 3e38, and the quad's candidates
//     merge with two __shfl_xor_sync steps (over 1 and 2). On equal values
//     the lower row wins (the first-match rule of block_topm.py:56-59);
//   * outputs: each warp stages its 16 queries' results in shared memory
//     and stores them 16 entries (64 bytes) per query at a time: one
//     query's results of consecutive blocks are contiguous in the output;
//   * grid: (corpus split, query group) pairs, query groups fastest, about
//     four CTAs per SM in all: the query groups of one split run together
//     and share its tiles through the 50 MB L2, so HBM sees about one read
//     of the table.
//
// f32 table, and bf16 rows wider than 256 columns (whose query group and
// two tiles do not fit shared memory): block_select_kernel, f32 FMAs on
// the CUDA cores (tile_dot.cuh), true f32 products with no TF32 rounding;
// 67 TFLOP/s sets its floor (~4 ms at the shape above).
//
// Output layout is the JAX function's returned one: [B, NB*m], entry
// b_i*m + j is the j-th best of block b_i; rows are global, and rows >= N
// score exactly 2e38, which is what the JAX padding rows score.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "hopper.cuh"
#include "tile_dot.cuh"

using namespace vdb;

namespace {

// ---- CUDA-core path: one CTA per (128-row block, 64-query tile) ----

constexpr int kQpw = 8;                  // queries per warp
constexpr int kQTile = kWarps * kQpw;    // queries per CTA

template <typename T, bool kIdx>
__global__ void __launch_bounds__(kThreads)
block_select_kernel(const T* __restrict__ q, const T* __restrict__ tab,
                    const float* __restrict__ xsq_eff, int B, int64_t N,
                    int ds, int m, int qtiles, float* __restrict__ vals,
                    int* __restrict__ rows) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float* qs = xs + kRows * kStride;

  const int qt = blockIdx.x % qtiles;
  const int64_t blk = blockIdx.x / qtiles;
  const int64_t row0 = blk * kRows;
  const int q0 = qt * kQTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float acc[kQpw][4];
#pragma unroll
  for (int qi = 0; qi < kQpw; ++qi)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[qi][r] = 0.f;

  for (int c0 = 0; c0 < ds; c0 += kChunk) {
    __syncthreads();
    stage(xs, tab, row0, kRows, N, ds, c0);
    stage(qs, q, q0, kQTile, B, ds, c0);
    __syncthreads();
    tile_dot<kQpw>(xs, qs, acc);
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int64_t row = row0 + lane + 32 * r;
    const float xr = row < N ? xsq_eff[row] : 0.f;
#pragma unroll
    for (int qi = 0; qi < kQpw; ++qi)
      acc[qi][r] = row < N ? xr + acc[qi][r] : kPadRow;
  }

  const int64_t nblocks = (N + kRows - 1) / kRows;
  const int64_t width = nblocks * m;
#pragma unroll
  for (int qi = 0; qi < kQpw; ++qi) {
    const int qg = q0 + warp * kQpw + qi;
    if (qg >= B) continue;  // uniform across the warp
    for (int j = 0; j < m; ++j) {
      // lane-local best of rows lane + 32r, ascending rows: strict < keeps
      // the lower row on ties
      float bv = acc[qi][0];
      int brow = lane;
#pragma unroll
      for (int r = 1; r < 4; ++r)
        if (acc[qi][r] < bv) {
          bv = acc[qi][r];
          brow = lane + 32 * r;
        }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int orow = __shfl_xor_sync(0xffffffffu, brow, off);
        if (ov < bv || (ov == bv && orow < brow)) {
          bv = ov;
          brow = orow;
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (brow == lane + 32 * r) acc[qi][r] = kBig;
      if (lane == 0) {
        const int64_t at = (int64_t)qg * width + blk * m + j;
        vals[at] = bv;
        if (kIdx) rows[at] = (int)(row0 + brow);
      }
    }
  }
}

template <typename T, bool kIdx>
int launch_fma(const void* q, const void* tab, const float* xsq_eff, int B,
               int64_t N, int ds, int m, float* vals, int* rows,
               cudaStream_t stream) {
  const int qtiles = (B + kQTile - 1) / kQTile;
  const int64_t nblocks = (N + kRows - 1) / kRows;
  const int64_t grid = nblocks * qtiles;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)(kRows + kQTile) * kStride * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      block_select_kernel<T, kIdx>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  block_select_kernel<T, kIdx><<<(unsigned)grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(tab), xsq_eff, B, N,
      ds, m, qtiles, vals, rows);
  return (int)cudaGetLastError();
}

// ---- tensor-core path (bf16 table) ----

constexpr int kNQ = 128;                        // queries per CTA: the M side
constexpr int kTcConsumers = 256;               // two warpgroups of 64
constexpr int kTcThreads = kTcConsumers + 128;  // + the producer warpgroup
constexpr int kChunkBytes = kRows * kSwz;       // one chunk of a tile (= kNQ * kSwz)
constexpr int kOut = 16;                        // results staged per query
constexpr int kOutStride = kOut + 1;            // (floats; no bank conflicts)
constexpr int kMaxStages = 8;
constexpr int kSmemLimit = 232448;              // H100: opt-in bytes per block
constexpr int kNoFit = -1;                      // not a CUDA error code

// byte offsets in shared memory: the resident query chunks, the stages
// (a tile's chunks, then its xsq_eff slice padded to keep 1024-byte
// alignment), the staged results, the mbarriers
struct TcLayout {
  size_t stage_bytes, ring, out_v, out_i, bars, total;
};

__host__ __device__ inline TcLayout tc_layout(int kc_n, int stages) {
  TcLayout L;
  L.stage_bytes = (size_t)kc_n * kChunkBytes + 1024;
  L.ring = (size_t)kc_n * kChunkBytes;
  L.out_v = L.ring + L.stage_bytes * stages;
  L.out_i = L.out_v + (size_t)kNQ * kOutStride * 4;
  L.bars = L.out_i + (size_t)kNQ * kOutStride * 4;
  L.total = L.bars + (2 * kMaxStages + 1) * 8 + 1024;  // + alignment slack
  return L;
}

// d[64 x 128] (+)= A[64 x 16] * B[16 x 128], both K-major in 128-byte-
// swizzled shared memory; accumulate = 0 overwrites d. The accumulator of
// row 16 w + g + 8 i and column 8 c + 2 t + j (warp w of the warpgroup,
// lane 4 g + t) is d[4 c + 2 i + j].
#define F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define F16(d, i) F4(d, i), F4(d, i + 4), F4(d, i + 8), F4(d, i + 12)

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : F16(d, 0), F16(d, 16), F16(d, 32), F16(d, 48)
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef F16
#undef F4

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Score e of query i (0 or 1) of a thread: acc[4 (e / 2) + 2 i + e % 2] +
// xv[e], the column 8 (e / 2) + 2 t + e % 2. The scores are formed as they
// are read and never written back: a non-wgmma write to an accumulator
// while the other tile's group is in flight makes ptxas serialize the
// wgmmas. The reductions are trees, for independent instructions.
__device__ __forceinline__ float block_min_of(const float (&acc)[64],
                                              const float (&xv)[32], int i) {
  float v[16];
#pragma unroll
  for (int k = 0; k < 16; ++k)
    v[k] = fminf(acc[4 * k + 2 * i] + xv[2 * k],
                 acc[4 * k + 2 * i + 1] + xv[2 * k + 1]);
#pragma unroll
  for (int w = 1; w < 16; w *= 2)
#pragma unroll
    for (int k = 0; k < 16; k += 2 * w) v[k] = fminf(v[k], v[k + w]);
  return v[0];
}

// The smallest score of query i and its index e, scores whose bit is set in
// `taken` reading as 3e38; on equal values the lower e (the lower row)
// wins, as the left operand of every comparison holds the lower indices.
__device__ __forceinline__ void best_of(const float (&acc)[64],
                                        const float (&xv)[32], int i,
                                        uint32_t taken, float& bv, int& be) {
  float v[16];
  int ix[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    float a = acc[4 * k + 2 * i] + xv[2 * k];
    float b = acc[4 * k + 2 * i + 1] + xv[2 * k + 1];
    a = (taken >> (2 * k)) & 1u ? kBig : a;
    b = (taken >> (2 * k + 1)) & 1u ? kBig : b;
    const bool p = b < a;
    v[k] = p ? b : a;
    ix[k] = p ? 2 * k + 1 : 2 * k;
  }
#pragma unroll
  for (int w = 1; w < 16; w *= 2)
#pragma unroll
    for (int k = 0; k < 16; k += 2 * w) {
      const bool p = v[k + w] < v[k];
      v[k] = p ? v[k + w] : v[k];
      ix[k] = p ? ix[k + w] : ix[k];
    }
  bv = v[0];
  be = ix[0];
}

// KC: the chunks of 128 bytes in a row, 1 to 4 (ds <= 256); a constant, so
// that each tile's wgmma group is straight-line code
template <bool kIdx, int KC>
__global__ void __launch_bounds__(kTcThreads, 1)
block_select_tc(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ tab,
                const float* __restrict__ xsq_eff, int B, int64_t N, int ds,
                int m, int qgroups, int64_t tiles_per_split, int stages,
                bool tma, const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_x,
                float* __restrict__ vals, int* __restrict__ rows) {
  constexpr int kc_n = KC;
  const TcLayout L = tc_layout(kc_n, stages);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* out_v = reinterpret_cast<float*>(smem + L.out_v);
  int* out_i = reinterpret_cast<int*>(smem + L.out_i);
  const uint32_t full0 = smem_u32(smem + L.bars);
  const uint32_t empty0 = full0 + 8 * kMaxStages;
  const uint32_t qbar = empty0 + 8 * kMaxStages;

  const int q0 = (blockIdx.x % qgroups) * kNQ;
  const int64_t nblocks = (N + kRows - 1) / kRows;
  const int64_t t_lo = (int64_t)(blockIdx.x / qgroups) * tiles_per_split;
  const int64_t left = nblocks - t_lo;
  const int ntiles = (int)(left < tiles_per_split ? left : tiles_per_split);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 32);                 // the producer's lanes
      mbar_init(empty0 + 8 * s, kTcConsumers / 32);  // one per consumer warp
    }
    mbar_init(qbar, 32);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= kTcConsumers / 32) {
    // ---- producer: its warpgroup hands registers to the consumers, and
    // one warp copies the query group once, then fills the ring ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (warp != kTcConsumers / 32) return;
    constexpr int kCols = kSwz / 2;  // bf16 columns per chunk
    if (tma) {
      if (lane == 0) {
        mbar_expect_tx(qbar, (uint32_t)(kc_n * kChunkBytes));
        for (int kc = 0; kc < kc_n; ++kc)
          tma_2d(smem_u32(smem + kc * kChunkBytes), &tm_q, qbar, kc * kCols,
                 q0);
      } else {
        mbar_arrive(qbar);
      }
    } else {
      for (int kc = 0; kc < kc_n; ++kc)
        fill<__nv_bfloat16>(smem + kc * kChunkBytes, q, q0, kNQ, B, ds, kc,
                            lane);
      fence_async_smem();
      mbar_arrive(qbar);
    }
    for (int it = 0; it < ntiles; ++it) {
      const int s = it % stages;
      const uint32_t full = full0 + 8 * s;
      mbar_wait(empty0 + 8 * s, ((it / stages) & 1) ^ 1);
      uint8_t* st = smem + L.ring + L.stage_bytes * s;
      float* xs = reinterpret_cast<float*>(st + kc_n * kChunkBytes);
      const int64_t row0 = (t_lo + it) * kRows;
      for (int e = lane; e < kRows; e += 32)
        xs[e] = row0 + e < N ? xsq_eff[row0 + e] : kPadRow;
      if (tma) {
        if (lane == 0) {
          mbar_expect_tx(full, (uint32_t)(kc_n * kChunkBytes));
          for (int kc = 0; kc < kc_n; ++kc)
            tma_2d(smem_u32(st + kc * kChunkBytes), &tm_x, full, kc * kCols,
                   (int)row0);
        } else {
          mbar_arrive(full);
        }
      } else {
        for (int kc = 0; kc < kc_n; ++kc)
          fill<__nv_bfloat16>(st + kc * kChunkBytes, tab, row0, kRows, N, ds,
                              kc, lane);
        fence_async_smem();
        mbar_arrive(full);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg holds queries [64 wg, 64 wg + 64) ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
  const int wg = warp >> 2;
  const int t = lane & 3;
  const int qw = 64 * wg + 16 * (warp & 3);  // the warp's 16 queries
  const int ql = qw + (lane >> 2);           // this thread's: ql, ql + 8
  const uint32_t qa = smem_u32(smem) + wg * 64 * kSwz;
  const uint32_t st0 = smem_u32(smem + L.ring);
  const int64_t width = nblocks * m;
  int64_t pos = t_lo * m;  // output column of the first unstored result
  int staged = 0;          // results staged per query (uniform)

  float acc0[64], acc1[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc0[e] = acc1[e] = 0.f;

  mbar_wait(qbar, 0);
  if (!tma) fence_async_smem();

  // half h of tile `it`'s products into acc (its stage has landed): the
  // group is issued in two halves with the previous tile's selection
  // between and after them, as a warp stalls on wgmma issue while the
  // tensor cores are busy
  auto issue = [&](float(&acc)[64], int it, auto half) {
    constexpr int h = decltype(half)::value;
    const int s = it % stages;
    const uint32_t xt = st0 + (uint32_t)(L.stage_bytes * s);
    if constexpr (h == 0) {
      mbar_wait(full0 + 8 * s, (it / stages) & 1);
      if (!tma) fence_async_smem();
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
    }
#pragma unroll
    for (int n = 2 * kc_n * h; n < 2 * kc_n * (h + 1); ++n)
      wgmma_ss(acc, desc_sw128(qa + (n >> 2) * kChunkBytes + (n & 3) * 32),
               desc_sw128(xt + (n >> 2) * kChunkBytes + (n & 3) * 32), n);
    if constexpr (h == 1)
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  };

  // the warp's staged results to vals / rows: 16 queries x `staged`
  auto flush = [&]() {
    __syncwarp();
    for (int e = lane; e < 16 * staged; e += 32) {
      const int r = e / staged, c = e - r * staged;
      const int qq = q0 + qw + r;
      if (qq < B) {
        const int64_t at = (int64_t)qq * width + pos + c;
        vals[at] = out_v[(qw + r) * kOutStride + c];
        if (kIdx) rows[at] = out_i[(qw + r) * kOutStride + c];
      }
    }
    pos += staged;
    staged = 0;
    __syncwarp();
  };

  // The selection of a tile whose group has completed, in two parts. The
  // first takes its xsq_eff slice into registers, hands the stage back to
  // the producer and reduces query 0 of the thread; the second reduces
  // query 1, then merges over the quad (m rounds) and stages the results.
  float xv[32];  // xsq_eff of the thread's columns 8 (e / 2) + 2 t + e % 2
  float lv[2];  // each query's best score of the thread in the coming round
  int le[2];    // (block_min: its minimum), and its index e
  auto pick_a = [&](float(&acc)[64], int it) {
    const int s = it % stages;
    const float* xs = reinterpret_cast<const float*>(
        smem + L.ring + L.stage_bytes * s + kc_n * kChunkBytes);
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const float2 x = *reinterpret_cast<const float2*>(xs + 8 * c + 2 * t);
      xv[2 * c] = x.x;
      xv[2 * c + 1] = x.y;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
    if constexpr (kIdx)
      best_of(acc, xv, 0, 0u, lv[0], le[0]);
    else
      lv[0] = block_min_of(acc, xv, 0);
  };
  auto pick_b = [&](float(&acc)[64], int it) {
    const bool last = it == ntiles - 1;
    if constexpr (!kIdx) {
      lv[1] = block_min_of(acc, xv, 1);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        lv[i] = fminf(lv[i], __shfl_xor_sync(0xffffffffu, lv[i], 1));
        lv[i] = fminf(lv[i], __shfl_xor_sync(0xffffffffu, lv[i], 2));
      }
      if (t == 0) {
        out_v[ql * kOutStride + staged] = lv[0];
        out_v[(ql + 8) * kOutStride + staged] = lv[1];
      }
      if (++staged == kOut || last) flush();
    } else {
      best_of(acc, xv, 1, 0u, lv[1], le[1]);
      const int row0 = (int)((t_lo + it) * kRows);
      // bit e of taken[i]: the thread's e-th score of query i has won a
      // round; each later round rescans with the winners read as 3e38
      uint32_t taken[2] = {0u, 0u};
      for (int j = 0; j < m; ++j) {
        float bv[2];
        int bc[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (j > 0) best_of(acc, xv, i, taken[i], lv[i], le[i]);
          bv[i] = lv[i];
          bc[i] = 8 * (le[i] >> 1) + 2 * t + (le[i] & 1);  // the column
#pragma unroll
          for (int off = 1; off <= 2; off <<= 1) {
            const float ov = __shfl_xor_sync(0xffffffffu, bv[i], off);
            const int oc = __shfl_xor_sync(0xffffffffu, bc[i], off);
            if (ov < bv[i] || (ov == bv[i] && oc < bc[i])) {
              bv[i] = ov;
              bc[i] = oc;
            }
          }
          const int own = bc[i] - 2 * t;  // 8c + jj if this thread holds it
          if (own >= 0 && (own & 6) == 0)
            taken[i] |= 1u << (((own >> 3) << 1) | (own & 1));
        }
        if (t == 0) {
          out_v[ql * kOutStride + staged] = bv[0];
          out_v[(ql + 8) * kOutStride + staged] = bv[1];
          out_i[ql * kOutStride + staged] = row0 + bc[0];
          out_i[(ql + 8) * kOutStride + staged] = row0 + bc[1];
        }
        if (++staged == kOut || (last && j + 1 == m)) flush();
      }
    }
  };

  // select tile `it` from cur while tile it + 1 goes into nxt
  auto step = [&](float(&cur)[64], float(&nxt)[64], int it) {
    wgmma_wait<0>();
    fence_acc(cur);
    const bool more = it + 1 < ntiles;
    if (more) issue(nxt, it + 1, std::integral_constant<int, 0>());
    pick_a(cur, it);
    if (more) issue(nxt, it + 1, std::integral_constant<int, 1>());
    pick_b(cur, it);
  };

  if (ntiles > 0) {
    issue(acc0, 0, std::integral_constant<int, 0>());
    issue(acc0, 0, std::integral_constant<int, 1>());
  }
  for (int it = 0; it < ntiles; it += 2) {
    step(acc0, acc1, it);
    if (it + 1 < ntiles) step(acc1, acc0, it + 1);
  }
}

template <bool kIdx>
int launch_tc(const void* q, const void* tab, const float* xsq_eff, int B,
              int64_t N, int ds, int m, float* vals, int* rows,
              cudaStream_t stream) {
  const int kc_n = (ds * 2 + kSwz - 1) / kSwz;
  const TcLayout one = tc_layout(kc_n, 0);
  const int64_t fit =
      ((int64_t)kSmemLimit - (int64_t)one.total) / (int64_t)one.stage_bytes;
  const int stages = (int)std::min<int64_t>(kMaxStages, fit);
  if (stages < 2 || kc_n > 4) return kNoFit;  // two tiles are in use at once
  const size_t smem = tc_layout(kc_n, stages).total;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int qgroups = (B + kNQ - 1) / kNQ;
  const int64_t nblocks = (N + kRows - 1) / kRows;
  // about four CTAs per SM in all; every split holds at least one tile
  int64_t splits = std::max<int64_t>(
      1, std::min<int64_t>(nblocks, (4 * sms + qgroups / 2) / qgroups));
  const int64_t per = (nblocks + splits - 1) / splits;
  splits = (nblocks + per - 1) / per;
  const int64_t grid = (int64_t)qgroups * splits;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const bool tma = tma_ok(q, ds, 2) && tma_ok(tab, ds, 2);
  CUtensorMap tm_q{}, tm_x{};
  if (tma) {
    int e = make_map(&tm_q, q, false, B, ds, kNQ);
    if (!e) e = make_map(&tm_x, tab, false, N, ds, kRows);
    if (e) return e;
  }
  const auto kernel = kc_n == 1   ? block_select_tc<kIdx, 1>
                      : kc_n == 2 ? block_select_tc<kIdx, 2>
                      : kc_n == 3 ? block_select_tc<kIdx, 3>
                                  : block_select_tc<kIdx, 4>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)grid, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(tab), xsq_eff, B, N, ds, m, qgroups,
      per, stages, tma, tm_q, tm_x, vals, rows);
  return (int)cudaGetLastError();
}

}  // namespace

// q: [B, ds] in the table dtype, already scaled by -2; tab: [N, ds];
// xsq_eff: f32[N]; vals: f32[B, ceil(N/128) * m]; rows: int32 of the same
// shape, or null for the block-minimum form (m must then be 1).
// Returns the CUDA error code of the launch (0 on success).
extern "C" int vdb_block_select(const void* q, const void* tab,
                                const float* xsq_eff, int B, long long N,
                                int ds, int m, int is_bf16, float* vals,
                                int* rows, void* stream) {
  if (B < 1 || ds < 1 || m < 1 || m > kRows || (!rows && m != 1))
    return (int)cudaErrorInvalidValue;
  if (N < 1) return 0;  // nothing to write
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const int r =
        rows ? launch_tc<true>(q, tab, xsq_eff, B, N, ds, m, vals, rows, s)
             : launch_tc<false>(q, tab, xsq_eff, B, N, ds, m, vals, rows, s);
    if (r != kNoFit) return r;
    return rows ? launch_fma<__nv_bfloat16, true>(q, tab, xsq_eff, B, N, ds,
                                                  m, vals, rows, s)
                : launch_fma<__nv_bfloat16, false>(q, tab, xsq_eff, B, N,
                                                   ds, m, vals, rows, s);
  }
  return rows ? launch_fma<float, true>(q, tab, xsq_eff, B, N, ds, m, vals,
                                        rows, s)
              : launch_fma<float, false>(q, tab, xsq_eff, B, N, ds, m, vals,
                                         rows, s);
}
