// ADC (asymmetric distance) scores of each query's gathered IVF-PQ
// candidates: out[b, p] = sum_j lut[b, j, codes[b, p, j]] + corr[b, p], and
// kBig where valid[b, p] is 0.
//
// Replaces the Pallas TPU kernel
// vector_db_tpu/ops/pallas/adc_probe.py:adc_probe_scores. The TPU kernel
// builds a [ksub, tile] one-hot per subspace in VMEM and contracts it on the
// MXU with a bf16 hi/lo pair of the LUT, because the TPU has no fast
// per-element gather. Hopper gathers from shared memory at full rate, so
// here each CTA stages one query's f32 LUT (m * ksub * 4 bytes, 16 KiB at
// m = 16, ksub = 256) in shared memory once and each thread scores
// candidates with m shared-memory lookups and f32 adds: the exact f32 sum,
// in subspace order.
//
// The codes come in the layout the cell gather produces, uint8 [B, P, m]
// (a candidate's m codes are contiguous), not the transposed int32
// [B, m, P] copy the Mosaic kernel needs. P is ragged: no tile padding.
//
// What bounds it on the H100: the reads of the gathered codes (m bytes per
// candidate) and shared-memory lookups (m per candidate, random banks). At
// B = 64, P = 16 * 489, m = 16 that is 8 MB of codes and 8e6 lookups per
// call, a few microseconds at the card's bandwidth; launch and LUT staging
// (16 KiB per CTA) are of the same order.
//
// A code >= ksub (never written by the encoder) is clamped to ksub - 1, as
// a JAX gather clamps an index out of range.

#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_list.cuh"  // kBig

using namespace vdb;

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
adc_probe_kernel(const float* __restrict__ lut,
                 const uint8_t* __restrict__ codes,
                 const float* __restrict__ corr,
                 const uint8_t* __restrict__ valid, int P, int m, int ksub,
                 int per_cta, float* __restrict__ out) {
  extern __shared__ float lut_s[];
  const int b = blockIdx.y;
  const int table = m * ksub;
  for (int i = threadIdx.x; i < table; i += kThreads)
    lut_s[i] = lut[(int64_t)b * table + i];
  __syncthreads();

  const int p0 = blockIdx.x * per_cta;
  const int p1 = p0 + per_cta < P ? p0 + per_cta : P;
  const bool words = (m & 3) == 0;  // rows start 4-byte aligned
  for (int p = p0 + threadIdx.x; p < p1; p += kThreads) {
    const int64_t at = (int64_t)b * P + p;
    const uint8_t* c = codes + at * m;
    float d = 0.f;
    if (words) {
      const uint32_t* w = reinterpret_cast<const uint32_t*>(c);
      for (int j = 0; j < m; j += 4) {
        const uint32_t v = w[j >> 2];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int code = min((int)((v >> (8 * s)) & 0xffu), ksub - 1);
          d += lut_s[(j + s) * ksub + code];
        }
      }
    } else {
      for (int j = 0; j < m; ++j)
        d += lut_s[j * ksub + min((int)c[j], ksub - 1)];
    }
    out[at] = valid[at] ? d + corr[at] : kBig;
  }
}

}  // namespace

// lut: f32 [B, m, ksub]; codes: uint8 [B, P, m]; corr: f32 [B, P];
// valid: bool [B, P] as bytes; out: f32 [B, P]. 1 <= ksub <= 256; codes must
// be 4-byte aligned when m % 4 == 0. Returns the CUDA error code of the
// launch (0 on success).
extern "C" int vdb_adc_probe(const float* lut, const uint8_t* codes,
                             const float* corr, const uint8_t* valid, int B,
                             int P, int m, int ksub, float* out,
                             void* stream) {
  if (ksub < 1 || ksub > 256 || m < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || P == 0) return 0;
  const size_t smem = (size_t)m * ksub * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      adc_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  // enough candidates per CTA that staging the LUT stays a small share
  const int per_cta = 4 * kThreads;
  const dim3 grid((P + per_cta - 1) / per_cta, B);
  adc_probe_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      lut, codes, corr, valid, P, m, ksub, per_cta, out);
  return (int)cudaGetLastError();
}
