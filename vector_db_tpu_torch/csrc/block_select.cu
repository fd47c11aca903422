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
//
// What bounds it on the H100: f32 FMA issue. At B = 1000, N = 2^20,
// ds = 128 the scan is 2.7e11 FMA-flops against a 256 MB bf16 table; the
// CUDA cores reach 67 TFLOP/s in f32, so arithmetic, not the table read,
// sets the floor (~4 ms). The design keeps the [B, N] score panel out of
// device memory entirely: one CTA scores one 128-row block against 64
// queries in registers (tile_dot.cuh) and reduces each query's 128 scores
// to m winners with warp shuffles, so only [B, N/128 * m] leaves the chip.
// Consecutive CTAs share a corpus block, so the block is read from L2 by
// the other query tiles. Tensor-core (wgmma) scoring is later work.
//
// Selection: m rounds of a warp argmin over (value, row); on equal values
// the lower row wins (the first-match rule of block_topm.py:56-59), and the
// winner is then masked to 3e38. Rows >= N score exactly 2e38, which is
// what the JAX padding rows score. Output layout is the JAX function's
// returned one: [B, NB*m], entry b_i*m + j is the j-th best of block b_i.

#include "tile_dot.cuh"

using namespace vdb;

namespace {

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
int launch(const void* q, const void* tab, const float* xsq_eff, int B,
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

}  // namespace

// q: [B, ds] in the table dtype, already scaled by -2; tab: [N, ds];
// xsq_eff: f32[N]; vals: f32[B, ceil(N/128) * m]; rows: int32 of the same
// shape, or null for the block-minimum form (m must then be 1).
// Returns the CUDA error code of the launch (0 on success).
extern "C" int vdb_block_select(const void* q, const void* tab,
                                const float* xsq_eff, int B, long long N,
                                int ds, int m, int is_bf16, float* vals,
                                int* rows, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return rows ? launch<__nv_bfloat16, true>(q, tab, xsq_eff, B, N, ds, m, vals, rows, s)
                : launch<__nv_bfloat16, false>(q, tab, xsq_eff, B, N, ds, m, vals, rows, s);
  }
  return rows ? launch<float, true>(q, tab, xsq_eff, B, N, ds, m, vals, rows, s)
              : launch<float, false>(q, tab, xsq_eff, B, N, ds, m, vals, rows, s);
}
