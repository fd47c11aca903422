// Per-query running top-k lists kept by one warp in shared memory, shared by
// the port's scan-with-selection kernels (l2_topk.cu, adc_scan.cu).
//
// A list is k ascending (value, row) pairs, (kBig, -1) while not full. The
// warp tests 32 candidates at once against the list's k-th value held in a
// register; only the few that pass enter the warp-parallel sorted
// insertion. Candidates are offered in lane order and an equal value goes
// after the entries already held, so when rows arrive in ascending order
// the lower row wins a tie.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace vdb {

constexpr int kMaxK = 256;
constexpr int kPerLane = kMaxK / 32;
constexpr float kBig = 3.0e38f;  // the JAX masking sentinel

__device__ __forceinline__ void list_init(float* lv, int* li, int k,
                                          int lane) {
  for (int e = lane; e < k; e += 32) {
    lv[e] = kBig;
    li[e] = -1;
  }
}

// Insert (v, id) into the warp's ascending list of k entries, v < lv[k-1].
// Returns the new k-th value.
static __device__ __noinline__ float list_insert(float* lv, int* li, int k,
                                                 float v, int id, int lane) {
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

// Offer each lane's dist, for row id0 + lane, to the list in lane order; thr
// is the list's current k-th value (uniform across the warp). Returns the
// new k-th value.
__device__ __forceinline__ float list_offer(float* lv, int* li, int k,
                                           float thr, float dist, int id0,
                                           int lane) {
  unsigned want = __ballot_sync(0xffffffffu, dist < thr);
  while (want) {
    const int src = __ffs(want) - 1;
    want &= want - 1;
    const float v = __shfl_sync(0xffffffffu, dist, src);
    if (v < thr) thr = list_insert(lv, li, k, v, id0 + src, lane);
  }
  return thr;
}

}  // namespace vdb
