// ADC (asymmetric distance) scores of each query's gathered IVF-PQ
// candidates: out[b, p] = sum_j lut[b, j, codes[b, p, j]] + corr[b, p], and
// kBig where valid[b, p] is 0.
//
// Replaces the Pallas TPU kernel
// vector_db_tpu/ops/pallas/adc_probe.py:adc_probe_scores. The TPU kernel
// builds a [ksub, tile] one-hot per subspace in VMEM and contracts it on the
// MXU with a bf16 hi/lo pair of the LUT, because the TPU has no fast
// per-element gather. Hopper gathers from shared memory at full rate, so
// here a CTA stages one query's f32 LUT (16 KiB at m = 16, ksub = 256) in
// shared memory and each thread scores candidates with m shared-memory
// lookups and f32 adds: the exact f32 sum, in subspace order.
//
// The codes come in the layout the cell gather produces, uint8 [B, P, m]
// (a candidate's m codes are contiguous), not the transposed int32
// [B, m, P] copy the Mosaic kernel needs. P is ragged: no tile padding.
//
// What bounds it on the H100: bytes. Any implementation reads valid, corr
// and writes out in full (9 bytes a slot), reads the codes of the live
// candidates only (m bytes each) and each query's LUT once; at B = 64,
// P = 16 * 978 that is ~13 MB, a few microseconds. Most slots of the
// padded cell table are dead (a mean list of 244 in cells of 978), so:
// - `valid` is read first, and a dead slot loads no codes and does no
//   lookups: it writes kBig;
// - a live candidate's codes come in one vector load (one uint4 at m = 16;
//   m is a template constant for 4, 8, 16, 32 and 64, any other m, or
//   codes off the vector alignment, take the generic instantiation of byte
//   loads), consecutive threads on consecutive slots, and the stores are
//   coalesced;
// - the grid is about two waves: each query's LUT is staged by
//   ceil(2 * SMs / B) CTAs, each walking a contiguous stretch of P, so LUT
//   bytes stay a small share of the code bytes;
// - at ~1M slots a call the kernel waits on memory latency, not bandwidth:
//   each thread keeps 4 slots in flight (their mask and corr loads go out
//   together, the first group's while the LUT is staged, then the live
//   ones' codes, then the lookups).
//
// A code >= ksub (never written by the encoder) reads the entry of
// ksub - 1, as a JAX gather clamps an index out of range.

#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_list.cuh"  // kBig

using namespace vdb;

namespace {

constexpr int kThreads = 256;

// a candidate's m codes in registers: m / 4 words (m in 4, 8, 16, 32, 64)
template <int M>
struct Row {
  uint32_t w[M / 4];
};

template <int M>
__device__ __forceinline__ Row<M> load_row(const uint8_t* __restrict__ c) {
  Row<M> r;
  if constexpr (M == 4) {
    r.w[0] = __ldg(reinterpret_cast<const uint32_t*>(c));
  } else if constexpr (M == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(c));
    r.w[0] = v.x;
    r.w[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < M / 16; ++i) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(c) + i);
      r.w[4 * i] = v.x;
      r.w[4 * i + 1] = v.y;
      r.w[4 * i + 2] = v.z;
      r.w[4 * i + 3] = v.w;
    }
  }
  return r;
}

template <int M>
__device__ __forceinline__ float lut_sum(const float* __restrict__ lut_s,
                                         const Row<M>& r, int ksub) {
  const uint32_t top = ksub - 1;
  float d = 0.f;
#pragma unroll
  for (int j = 0; j < M; ++j)
    d += lut_s[j * ksub + min((r.w[j >> 2] >> (8 * (j & 3))) & 0xffu, top)];
  return d;
}

constexpr int kU = 4;  // slots a thread has in flight

template <int M>
__global__ void __launch_bounds__(kThreads)
adc_probe_kernel(const float* __restrict__ lut,
                 const uint8_t* __restrict__ codes,
                 const float* __restrict__ corr,
                 const uint8_t* __restrict__ valid, int P, int m_rt, int ksub,
                 int per_cta, float* __restrict__ out) {
  extern __shared__ float lut_s[];
  const int m = M ? M : m_rt;
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * per_cta;
  const int p1 = p0 + per_cta < P ? p0 + per_cta : P;
  const int64_t row0 = (int64_t)b * P;

  bool ok[kU];
  float cr[kU];
  auto fetch = [&](int base) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int p = base + u * kThreads + threadIdx.x;
      ok[u] = p < p1 && valid[row0 + p];
      cr[u] = p < p1 ? corr[row0 + p] : 0.f;
    }
  };
  fetch(p0);  // in flight while the LUT is staged
  for (int e = threadIdx.x; e < m * ksub; e += kThreads)
    lut_s[e] = lut[(int64_t)b * m * ksub + e];
  __syncthreads();

  for (int base = p0; base < p1; base += kU * kThreads) {
    float d[kU];
    if constexpr (M == 0) {
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        d[u] = 0.f;
        if (ok[u]) {
          const uint8_t* c =
              codes + (row0 + base + u * kThreads + threadIdx.x) * m;
          for (int j = 0; j < m; ++j)
            d[u] += lut_s[j * ksub + min((int)c[j], ksub - 1)];
        }
      }
    } else {
      Row<M> r[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u)
        if (ok[u])
          r[u] = load_row<M>(codes +
                             (row0 + base + u * kThreads + threadIdx.x) * M);
#pragma unroll
      for (int u = 0; u < kU; ++u)
        d[u] = ok[u] ? lut_sum<M>(lut_s, r[u], ksub) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int p = base + u * kThreads + threadIdx.x;
      if (p < p1) out[row0 + p] = ok[u] ? d[u] + cr[u] : kBig;
    }
    fetch(base + kU * kThreads);
  }
}

template <int M>
int launch(const float* lut, const uint8_t* codes, const float* corr,
           const uint8_t* valid, int B, int P, int m, int ksub, int ctas,
           float* out, cudaStream_t stream) {
  const size_t smem = (size_t)m * ksub * sizeof(float);
  static size_t granted = 48 * 1024;  // needs no attribute up to 48 KiB
  if (smem > granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        adc_probe_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    granted = smem;
  }
  // a stretch of P per CTA, whole multiples of kU blocks
  const int per_cta = ((P + ctas - 1) / ctas + kU * kThreads - 1) /
                      (kU * kThreads) * (kU * kThreads);
  const dim3 grid((P + per_cta - 1) / per_cta, B);
  adc_probe_kernel<M><<<grid, kThreads, smem, stream>>>(
      lut, codes, corr, valid, P, m, ksub, per_cta, out);
  return (int)cudaGetLastError();
}

}  // namespace

// lut: f32 [B, m, ksub]; codes: uint8 [B, P, m]; corr: f32 [B, P];
// valid: bool [B, P] as bytes; out: f32 [B, P]. 1 <= ksub <= 256,
// B <= 65535, m * ksub * 4 bytes within a CTA's shared memory. Returns the
// CUDA error code of the launch (0 on success).
extern "C" int vdb_adc_probe(const float* lut, const uint8_t* codes,
                             const float* corr, const uint8_t* valid, int B,
                             int P, int m, int ksub, float* out,
                             void* stream) {
  if (ksub < 1 || ksub > 256 || m < 1 || B < 0 || B > 65535 || P < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || P == 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int ctas = (2 * sms + B - 1) / B;  // about two waves
  // the vector loads of m in (4, 8, 16, 32, 64) need min(m, 16)-byte
  // aligned codes
  const bool generic = (uintptr_t)codes % (m < 16 ? m : 16) != 0;
  auto s = static_cast<cudaStream_t>(stream);
#define VDB_PROBE(MM) \
  launch<MM>(lut, codes, corr, valid, B, P, m, ksub, ctas, out, s)
  if (generic) return VDB_PROBE(0);
  switch (m) {
    case 4: return VDB_PROBE(4);
    case 8: return VDB_PROBE(8);
    case 16: return VDB_PROBE(16);
    case 32: return VDB_PROBE(32);
    case 64: return VDB_PROBE(64);
    default: return VDB_PROBE(0);
  }
#undef VDB_PROBE
}
