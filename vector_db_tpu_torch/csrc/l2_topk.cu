// Fused exact L2 scan with a running top-k per query, on tensor cores.
//
// Replaces the Pallas TPU kernel vector_db_tpu/ops/pallas/l2_topk.py:l2_topk.
// The TPU kernel carries the top-k lists across its sequential grid; a CUDA
// grid runs its blocks in no order, so here each CTA owns one (query group,
// corpus split) pair, keeps a private top-k list per query, and writes it
// to [B, splits * k]. The wrapper merges those partial lists with a stable
// sort. The [B, N] distance matrix never exists in device memory.
//
// Table dtype selects the formula:
//   f32  (exact_search): q_sq - 2 q.x + x_sq, clamped at 0
//        (vector_db_tpu/ops/distance.py:59-63);
//   bf16 (approx_search_tiled): the query is cast to bf16, q_sq comes from
//        the f32 query, x_sq is supplied, no clamp
//        (vector_db_tpu/ops/exact.py:138-151).
//
// What bounds it on the H100: tensor-core issue. At B = 1000, N = 2^20,
// d = 768 the product is 1.61e12 flop: 1.63 ms at the bf16 rate (989
// TFLOP/s); the f32 table as 3xTF32 is three such products, 9.76 ms at the
// TF32 rate (495 TFLOP/s). One read of the table (1.6 GB bf16, 3.2 GB f32)
// takes 0.48 / 0.96 ms. Next come the shared-memory fill from L2 (each CTA
// reads its query group once per corpus tile) and the selection after each
// tile, during which the tensor cores idle.
//
// Design:
//   * products: wgmma.mma_async m64nNk16 (bf16) or m64nNk8 (tf32) with f32
//     accumulators, N = the query group. A is the corpus (64 rows per
//     consumer warpgroup, from registers), B the query group (from
//     128-byte-swizzled shared memory through a descriptor). bf16: A is
//     loaded with ldmatrix, and bf16 x bf16 products are exact in f32. f32:
//     3xTF32. The wrapper splits each query once into q_hi = rna_tf32(q),
//     q_lo = rna_tf32(q - q_hi) (bit for bit cvt.rna.tf32.f32); the kernel
//     splits each corpus value in registers the same way (cvt.rna: a tf32
//     wgmma fed raw f32 would truncate) and sums q_hi.x_hi + q_lo.x_hi +
//     q_hi.x_lo in f32. Register A keeps one accumulator layout (corpus
//     rows x queries) and one epilogue for both dtypes. Each chunk's group
//     is waited for before the next is issued (ptxas serializes register-A
//     wgmmas whose inputs are written while a group is in flight); for
//     bf16 the next chunk's fragments load while the group runs;
//   * copies: a ring of stages in shared memory, each 128 bytes of columns
//     (64 bf16 or 32 f32) of the query group and of a 128-row corpus tile.
//     One producer thread fills a stage with 2-D TMA copies
//     (cp.async.bulk.tensor, 128-byte swizzle, zeros past the edges) that
//     complete on the stage's mbarrier; two consumer warpgroups wait on it,
//     run the wgmmas and release the stage through a second mbarrier, so
//     copies overlap the products. Rows that are not 16-byte aligned, or
//     narrower than 128 bytes, are copied by the producer warp with element
//     loads instead;
//   * traffic: the grid puts query groups fastest, so the CTAs of one
//     corpus split run together and share its tiles through the 50 MB L2:
//     HBM traffic stays near one read of the table;
//   * selection: after a tile the consumers turn each accumulator into
//     q_sq - 2 acc + x_sq (BIG for an invalid row), store it through
//     shared memory transposed to [query][row], and flag each query with a
//     score below its list's k-th value. Each warp then offers the 128
//     scores of its flagged queries in row order to the query's list: a
//     score is tested against the k-th value and only the few that pass
//     are inserted, by shuffles into a list held in registers (lane e
//     holds entry e; k <= 32) or into one in shared memory (topk_list.cuh;
//     k up to 256). Rows reach each list in ascending order and an equal
//     value goes after the entries held, so the list is ordered by (value,
//     row): a tie resolves to the lower row, across tiles too, and the
//     wrapper's stable merge keeps that across CTAs. No float atomics: the
//     result is the same bits in every run;
//   * k: the query group is 128 for k <= 32 (lists in registers), 64 for
//     k <= 64 and 32 up to 256 (lists of [group, k] values and rows in
//     shared memory), or the smallest of those that holds B;
//   * longer lists, by passes: an optional per-query floor (value, row)
//     drops every row at or before it in (value, row) order (a row as
//     uint32, so a pad's -1 comes after every row). The wrapper runs
//     ceil(k / 256) launches of k = 256, each from the last one's final
//     pair; every launch has the same shape, so each distance is the same
//     bits in each pass, and the passes join into the exact top-k.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "hopper.cuh"
#include "topk_list.cuh"

using namespace vdb;

namespace {

constexpr int kTileRows = 128;            // corpus rows per tile
constexpr int kConsumers = 256;           // two warpgroups of 64 rows each
constexpr int kThreads = kConsumers + 32; // + the producer warp
constexpr int kSRow = kTileRows + 4;      // score tile row stride (floats)
constexpr int kMaxStages = 6;
constexpr int kSmemLimit = 232448;        // H100: opt-in bytes per block

// byte offsets in shared memory: the stages, then the score tile, the
// lists (a group of 128 keeps its lists in registers), q_sq, the flags,
// the k-th values, the floors and the mbarriers
struct Layout {
  size_t q_bytes, stage_bytes, score, lv, li, qsq, cand, kth, fv, fi, bars,
      total;
};

__host__ __device__ inline Layout layout(bool f32, int nq, int k,
                                         int stages) {
  Layout L;
  L.q_bytes = (size_t)nq * kSwz;
  L.stage_bytes = L.q_bytes * (f32 ? 2 : 1) + (size_t)kTileRows * kSwz;
  L.score = L.stage_bytes * stages;
  const size_t list = nq == 128 ? 0 : (size_t)nq * k * 4;
  L.lv = L.score + (size_t)nq * kSRow * 4;
  L.li = L.lv + list;
  L.qsq = L.li + list;
  L.cand = L.qsq + (size_t)nq * 4;
  L.kth = L.cand + (size_t)nq * 4;
  L.fv = L.kth + (size_t)nq * 4;
  L.fi = L.fv + (size_t)nq * 4;
  L.bars = (L.fi + (size_t)nq * 4 + 7) & ~(size_t)7;
  L.total = L.bars + 2 * kMaxStages * 8 + 1024;  // + alignment slack
  return L;
}

__device__ __forceinline__ uint32_t rna_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// d[64 x N] += A[64 x K] (registers) * B[K x N] (shared memory, through a
// descriptor), f32 accumulators: bf16 with K = 16, tf32 with K = 8. The
// accumulator of row 16 w + g + 8 i and column 8 c + 2 t + j (warp w of
// the warpgroup, lane 4 g + t) is d[4 c + 2 i + j].
#define F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define F16(d, i) F4(d, i), F4(d, i + 4), F4(d, i + 8), F4(d, i + 12)

template <int N> struct Wgmma;

template <> struct Wgmma<32> {
  static __device__ __forceinline__ void bf16(float* d, const uint32_t* a,
                                              uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : F16(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
  static __device__ __forceinline__ void tf32(float* d, const uint32_t* a,
                                              uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : F16(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <> struct Wgmma<64> {
  static __device__ __forceinline__ void bf16(float* d, const uint32_t* a,
                                              uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : F16(d, 0), F16(d, 16)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
  static __device__ __forceinline__ void tf32(float* d, const uint32_t* a,
                                              uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : F16(d, 0), F16(d, 16)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <> struct Wgmma<128> {
  static __device__ __forceinline__ void bf16(float* d, const uint32_t* a,
                                              uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : F16(d, 0), F16(d, 16), F16(d, 32), F16(d, 48)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
  static __device__ __forceinline__ void tf32(float* d, const uint32_t* a,
                                              uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : F16(d, 0), F16(d, 16), F16(d, 32), F16(d, 48)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

#undef F16
#undef F4

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// NQ: the query group, 32, 64 or 128.
template <bool kF32, int NQ>
__global__ void __launch_bounds__(kThreads, 1)
l2_topk_kernel(const void* __restrict__ q_in, const float* __restrict__ q_lo,
               const void* __restrict__ emb_in, const float* __restrict__ qsq,
               const float* __restrict__ xsq,
               const uint8_t* __restrict__ valid,
               const float* __restrict__ after_v,
               const int* __restrict__ after_i, int B, int64_t N, int d,
               int k, int qgroups, int64_t rows_per_split, int stages,
               bool tma, const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_qlo,
               const __grid_constant__ CUtensorMap tm_x,
               float* __restrict__ out_v, int* __restrict__ out_i,
               int64_t width) {
  using T = typename std::conditional<kF32, float, __nv_bfloat16>::type;
  const T* q = static_cast<const T*>(q_in);
  const T* emb = static_cast<const T*>(emb_in);
  const Layout L = layout(kF32, NQ, k, stages);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* score = reinterpret_cast<float*>(smem + L.score);
  float* topv = reinterpret_cast<float*>(smem + L.lv);
  int* topi = reinterpret_cast<int*>(smem + L.li);
  float* qsq_s = reinterpret_cast<float*>(smem + L.qsq);
  int* cand = reinterpret_cast<int*>(smem + L.cand);  // query has a candidate
  float* kth_s = reinterpret_cast<float*>(smem + L.kth);  // its k-th value
  float* fv_s = reinterpret_cast<float*>(smem + L.fv);    // its floor
  uint32_t* fi_s = reinterpret_cast<uint32_t*>(smem + L.fi);
  const bool floored = after_v != nullptr;
  const uint32_t full0 = smem_u32(smem + L.bars);
  const uint32_t empty0 = full0 + 8 * kMaxStages;

  const int qgi = blockIdx.x % qgroups;
  const int64_t split = blockIdx.x / qgroups;
  const int q0 = qgi * NQ;
  const int64_t lo = split * rows_per_split;
  const int64_t hi = lo + rows_per_split < N ? lo + rows_per_split : N;
  const int kc_n = (d * (int)sizeof(T) + kSwz - 1) / kSwz;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int e = threadIdx.x; e < (NQ == 128 ? 0 : NQ * k); e += kThreads) {
    topv[e] = kBig;
    topi[e] = -1;
  }
  for (int e = threadIdx.x; e < NQ; e += kThreads) {
    qsq_s[e] = q0 + e < B ? qsq[q0 + e] : 0.f;
    cand[e] = 0;
    kth_s[e] = kBig;
    fv_s[e] = floored && q0 + e < B ? after_v[q0 + e] : 0.f;
    fi_s[e] = floored && q0 + e < B ? (uint32_t)after_i[q0 + e] : 0u;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, tma ? 1 : 32);  // the producer's lanes
      mbar_init(empty0 + 8 * s, kConsumers / 32);  // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // ---- producer warp: fill the ring, stage after stage ----
    if (tma && lane != 0) return;  // one thread issues the TMA copies
    constexpr int kCols = kSwz / (int)sizeof(T);
    int it = 0;
    for (int64_t row0 = lo; row0 < hi; row0 += kTileRows) {
      for (int kc = 0; kc < kc_n; ++kc, ++it) {
        const int s = it % stages;
        const uint32_t full = full0 + 8 * s;
        mbar_wait(empty0 + 8 * s, ((it / stages) & 1) ^ 1);
        uint8_t* st = smem + L.stage_bytes * s;
        uint8_t* xt = st + L.q_bytes * (kF32 ? 2 : 1);
        if (tma) {
          mbar_expect_tx(full, (uint32_t)L.stage_bytes);
          tma_2d(smem_u32(st), &tm_q, full, kc * kCols, q0);
          if (kF32)
            tma_2d(smem_u32(st + L.q_bytes), &tm_qlo, full, kc * kCols, q0);
          tma_2d(smem_u32(xt), &tm_x, full, kc * kCols, (int)row0);
        } else {
          fill<T>(st, q, q0, NQ, B, d, kc, lane);
          if (kF32) fill<float>(st + L.q_bytes, q_lo, q0, NQ, B, d, kc, lane);
          fill<T>(xt, emb, row0, kTileRows, hi, d, kc, lane);
          mbar_arrive(full);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg scores tile rows [64 wg, 64 wg + 64) ----
  const int wg = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int r_lo = 64 * wg + 16 * (warp & 3) + g;  // and r_lo + 8
  // k <= 32 (query group 128): lane e of warp w holds entry e of the lists
  // of queries w + 8 m in registers
  float rv[NQ / 8];
  int ri[NQ / 8];
#pragma unroll
  for (int m = 0; m < NQ / 8; ++m) {
    rv[m] = kBig;
    ri[m] = -1;
  }
  float acc[NQ / 2];
  uint32_t a[2][4][4];               // bf16 A fragments, two chunks
  uint32_t ah[1][4][4], al[1][4][4];  // f32: the hi and lo tf32 parts
  int it = 0;

  // A fragments of chunk `it` into buffer b, once its stage has landed
  auto load_a = [&](auto buf) {
    constexpr int b = decltype(buf)::value;
    const int s = it % stages;
    mbar_wait(full0 + 8 * s, (it / stages) & 1);
    // without TMA the stage was written through the generic proxy, and
    // wgmma reads through the async proxy
    if (!tma) asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    const uint8_t* xt = smem + L.stage_bytes * s + L.q_bytes * (kF32 ? 2 : 1);
    if constexpr (!kF32) {
      const int ar = 64 * wg + 16 * (warp & 3) + (lane & 7) +
                     8 * ((lane >> 3) & 1);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        ldmatrix_x4(a[b][ks], smem_u32(xt + swz(ar, 2 * ks + (lane >> 4))));
    } else {
      // A fragment of k-step ks: (g, t), (g+8, t), (g, t+4), (g+8, t+4)
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int r = r_lo + 8 * (v & 1);
          const int c = 8 * ks + t + 4 * (v >> 1);
          const float x = *reinterpret_cast<const float*>(
              xt + swz(r, c >> 2) + 4 * (c & 3));
          ah[b][ks][v] = rna_tf32(x);
          al[b][ks][v] = rna_tf32(x - __uint_as_float(ah[b][ks][v]));
        }
      }
    }
  };

  // the products of chunk `it` from buffer b; bf16: the next chunk's
  // fragments load while they run (`more`); then the stage goes back to
  // the producer
  auto chunk = [&](auto buf, bool more) {
    constexpr int b = decltype(buf)::value;
    const int s = it % stages;
    const uint32_t qa = smem_u32(smem + L.stage_bytes * s);
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
    if constexpr (!kF32) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        Wgmma<NQ>::bf16(acc, a[b][ks], desc_sw128(qa + ks * 32));
    } else {
      const uint32_t qla = qa + (uint32_t)L.q_bytes;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        Wgmma<NQ>::tf32(acc, ah[b][ks], desc_sw128(qa + ks * 32));
        Wgmma<NQ>::tf32(acc, ah[b][ks], desc_sw128(qla + ks * 32));
        Wgmma<NQ>::tf32(acc, al[b][ks], desc_sw128(qa + ks * 32));
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    ++it;
    if constexpr (!kF32)
      if (more) load_a(std::integral_constant<int, b ^ 1>());
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_acc(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
  };

  for (int64_t row0 = lo; row0 < hi; row0 += kTileRows) {
#pragma unroll
    for (int e = 0; e < NQ / 2; ++e) acc[e] = 0.f;
    // this tile's norms and mask, read while the products run
    float xr[2];
    bool ok[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int64_t row = row0 + r_lo + 8 * i;
      ok[i] = row < hi && valid[row] != 0;
      xr[i] = ok[i] ? xsq[row] : 0.f;
    }

    if constexpr (kF32) {
      // the split fragments of two chunks do not fit the registers a
      // thread has here (168 at 288 threads): load, then multiply
      for (int kc = 0; kc < kc_n; ++kc) {
        load_a(std::integral_constant<int, 0>());
        chunk(std::integral_constant<int, 0>(), false);
      }
    } else {
      load_a(std::integral_constant<int, 0>());
      for (int kc = 0; kc < kc_n; kc += 2) {
        chunk(std::integral_constant<int, 0>(), kc + 1 < kc_n);
        if (kc + 1 < kc_n)
          chunk(std::integral_constant<int, 1>(), kc + 2 < kc_n);
      }
    }

    // scores of this tile, transposed to [query][row] in shared memory;
    // a query whose score beats its k-th value is flagged
    named_sync(1, kConsumers);  // the previous tile's selection is done
#pragma unroll
    for (int c = 0; c < NQ / 8; ++c)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int qq = 8 * c + 2 * t + j;
        const float qs = qsq_s[qq];
        const float kth = kth_s[qq];
        bool pass = false;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float dist = qs - 2.f * acc[4 * c + 2 * i + j] + xr[i];
          if (kF32) dist = fmaxf(dist, 0.f);
          if (!ok[i]) dist = kBig;
          if (floored) {  // at or before the floor: out of this pass
            const float fv = fv_s[qq];
            const uint32_t row = (uint32_t)(row0 + r_lo + 8 * i);
            if (dist < fv || (dist == fv && row <= fi_s[qq])) dist = kBig;
          }
          score[qq * kSRow + r_lo + 8 * i] = dist;
          pass |= dist < kth;
        }
        if (pass) cand[qq] = 1;
      }
    named_sync(1, kConsumers);

    // warp w offers the scores of its flagged queries w + 8 m in row order
#pragma unroll
    for (int m = 0; m < NQ / 8; ++m) {
      const int qq = warp + 8 * m;
      if (q0 + qq >= B || !cand[qq]) continue;  // uniform across the warp
      __syncwarp();
      if (lane == 0) cand[qq] = 0;
      const float* sc = score + qq * kSRow;
      float thr;
      if constexpr (NQ == 128) {
        // register list: an equal value goes after the entries held
        thr = __shfl_sync(0xffffffffu, rv[m], k - 1);
#pragma unroll
        for (int rr = 0; rr < kTileRows / 32; ++rr) {
          const float dist = sc[32 * rr + lane];
          unsigned want = __ballot_sync(0xffffffffu, dist < thr);
          while (want) {
            const int src = __ffs(want) - 1;
            want &= want - 1;
            const float v = __shfl_sync(0xffffffffu, dist, src);
            if (!(v < thr)) continue;
            const int p = __popc(
                __ballot_sync(0xffffffffu, lane < k && rv[m] <= v));
            const float up_v = __shfl_up_sync(0xffffffffu, rv[m], 1);
            const int up_i = __shfl_up_sync(0xffffffffu, ri[m], 1);
            if (lane == p) {
              rv[m] = v;
              ri[m] = (int)(row0 + 32 * rr + src);
            } else if (lane > p) {
              rv[m] = up_v;
              ri[m] = up_i;
            }
            thr = __shfl_sync(0xffffffffu, rv[m], k - 1);
          }
        }
      } else {
        float* lv = topv + qq * k;
        int* li = topi + qq * k;
        thr = lv[k - 1];
#pragma unroll
        for (int rr = 0; rr < kTileRows / 32; ++rr)
          thr = list_offer(lv, li, k, thr, sc[32 * rr + lane],
                           (int)(row0 + 32 * rr), lane);
      }
      if (lane == 0) kth_s[qq] = thr;
    }
  }

#pragma unroll
  for (int m = 0; m < NQ / 8; ++m) {
    const int qq = warp + 8 * m;
    if (q0 + qq >= B) break;
    const int64_t at = (int64_t)(q0 + qq) * width + split * k;
    if constexpr (NQ == 128) {
      if (lane < k) {
        out_v[at + lane] = rv[m];
        out_i[at + lane] = ri[m];
      }
    } else {
      for (int e = lane; e < k; e += 32) {
        out_v[at + e] = topv[qq * k + e];
        out_i[at + e] = topi[qq * k + e];
      }
    }
  }
}

template <bool kF32, int NQ>
int launch(const void* q, const float* q_lo, const void* emb,
           const float* qsq, const float* xsq, const uint8_t* valid,
           const float* after_v, const int* after_i, int B, int64_t N, int d,
           int k, int64_t rows_per_split, int splits, float* out_v,
           int* out_i, cudaStream_t stream) {
  const int qgroups = (B + NQ - 1) / NQ;
  const int64_t grid = (int64_t)qgroups * splits;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const Layout one = layout(kF32, NQ, k, 1);
  const size_t fixed = one.total - one.stage_bytes;
  const int stages = (int)std::min<size_t>(
      kMaxStages, (kSmemLimit - fixed) / one.stage_bytes);
  if (stages < 2) return (int)cudaErrorInvalidValue;
  const size_t smem = layout(kF32, NQ, k, stages).total;
  const int el = kF32 ? 4 : 2;
  const bool tma = tma_ok(q, d, el) && tma_ok(emb, d, el) &&
                   (!kF32 || tma_ok(q_lo, d, el));
  CUtensorMap tm_q{}, tm_qlo{}, tm_x{};
  if (tma) {
    int e = make_map(&tm_q, q, kF32, B, d, NQ);
    if (!e && kF32) e = make_map(&tm_qlo, q_lo, true, B, d, NQ);
    if (!e) e = make_map(&tm_x, emb, kF32, N > 0 ? N : 1, d, kTileRows);
    if (e) return e;
  }
  cudaError_t err = cudaFuncSetAttribute(
      l2_topk_kernel<kF32, NQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  l2_topk_kernel<kF32, NQ><<<(unsigned)grid, kThreads, smem, stream>>>(
      q, q_lo, emb, qsq, xsq, valid, after_v, after_i, B, N, d, k, qgroups,
      rows_per_split,
      stages, tma, tm_q, tm_qlo, tm_x, out_v, out_i, (int64_t)splits * k);
  return (int)cudaGetLastError();
}

template <bool kF32>
int launch_nq(int nq, const void* q, const float* q_lo, const void* emb,
              const float* qsq, const float* xsq, const uint8_t* valid,
              const float* after_v, const int* after_i, int B, int64_t N,
              int d, int k, int64_t rows_per_split, int splits, float* out_v,
              int* out_i, cudaStream_t s) {
  switch (nq) {
    case 32:
      return launch<kF32, 32>(q, q_lo, emb, qsq, xsq, valid, after_v,
                             after_i, B, N, d, k, rows_per_split, splits,
                             out_v, out_i, s);
    case 64:
      return launch<kF32, 64>(q, q_lo, emb, qsq, xsq, valid, after_v,
                             after_i, B, N, d, k, rows_per_split, splits,
                             out_v, out_i, s);
    case 128:
      return launch<kF32, 128>(q, q_lo, emb, qsq, xsq, valid, after_v,
                             after_i, B, N, d, k, rows_per_split, splits,
                             out_v, out_i, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// bf16 table: q bf16 [B, d], q_lo unused. f32 table: q = q_hi and q_lo,
// f32 [B, d], the query's rna-tf32 split. emb: [N, d] in the table dtype;
// qsq: f32[B] from the f32 query; xsq: f32[N]; valid: bool[N] as bytes;
// after_v / after_i: f32 / int32 [B], each query's floor, or both null:
// a row at or before its query's (value, row) floor, the row compared as
// uint32, takes no place in the lists;
// out_v / out_i: f32 / int32 [B, splits * k], split s covering rows
// [s * rows_per_split, ...), each list ascending by (value, row). nq: the
// query group, 32, 64 or 128, with nq * k <= 4096 (8192 for nq = 32);
// rows_per_split a multiple of 128; k <= 256. Returns the CUDA error code
// of the launch (0 on success).
extern "C" int vdb_l2_topk(const void* q, const float* q_lo, const void* emb,
                           const float* qsq, const float* xsq,
                           const uint8_t* valid, const float* after_v,
                           const int* after_i, int B, long long N, int d,
                           int k, int nq, long long rows_per_split,
                           int splits, int is_bf16, float* out_v, int* out_i,
                           void* stream) {
  if (k < 1 || k > kMaxK || d < 1 || B < 1 || rows_per_split % kTileRows)
    return (int)cudaErrorInvalidValue;
  if (nq * k > (nq == 32 ? 8192 : 4096)) return (int)cudaErrorInvalidValue;
  if ((after_v == nullptr) != (after_i == nullptr))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return is_bf16
      ? launch_nq<false>(nq, q, nullptr, emb, qsq, xsq, valid, after_v,
                         after_i, B, N, d, k, rows_per_split, splits, out_v,
                         out_i, s)
      : launch_nq<true>(nq, q, q_lo, emb, qsq, xsq, valid, after_v, after_i,
                        B, N, d, k, rows_per_split, splits, out_v, out_i, s);
}
