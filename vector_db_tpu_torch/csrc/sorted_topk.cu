// Exact ascending top-`topk` of each row of keys, with an int32 payload
// carried along: the wide-beam pool merge.
//
// Replaces the Pallas TPU kernel
// vector_db_tpu/ops/pallas/bitonic_merge.py:sorted_topk (and its blocked
// form _blocked_topk with the bodies _kernel, _kernel_slice_sort,
// _kernel_merge_pair, _kernel_merge). The TPU kernel sorts a block of 32-64
// rows at a time in VMEM with lane rotates, and for rows wider than 4096
// streams sorted slices through HBM in merge-halve rounds.
//
// Here one CTA owns one row (or one 16,384-wide slice of it) and selects
// before it sorts:
//   1. load: the row goes to shared memory with 16-byte loads as words of
//      order-preserving key bits and column: 32-bit words for bf16 keys
//      (ordered16 << 16 | column) and 64-bit words for f32 keys
//      (ordered32 << 32 | column). -0.0 orders as +0.0. The column makes
//      every word distinct and the word order is the stable sort's order;
//   2. radix select: the topk-th smallest word, 8 bits at a time from the
//      top, with a 256-bin histogram in shared memory that each warp feeds
//      once per distinct digit (__match_any_sync). Only words that match
//      the digits chosen so far take part. A pass whose chosen bin is
//      needed whole ends the select early, so distinct keys take two
//      passes (bf16) or four (f32), and the column digits are read only
//      when keys tie across the cut;
//   3. cut: the words at or below the threshold are exactly topk: every
//      key below the threshold key, then the lowest columns of the key
//      that ties across the cut, as the stable sort keeps them;
//   4. sort: only those topk survivors, by a bitonic network in shared
//      memory (next power of two, padded with all-ones words);
//   5. gather: key (in its own dtype) and payload from device memory by the
//      survivors' columns, once at the end.
//
// Width: a slice holds at most 16,384 keys (64 KiB of bf16 words, 128 KiB
// of f32 words, plus the survivors). A wider row is cut into 16,384-wide
// slices; each slice keeps its own top `topk` and the wrapper sorts the
// survivors in a second launch. That is exact: the top-P of a union is the
// top-P of the parts' top-Ps, and the survivors keep slice order, so ties
// still resolve by column.
//
// What bounds it on the H100: device memory, 69 MB at the wide-beam main
// shape (B = 1024 rows of 9,216 bf16 keys and int32 payloads, topk =
// 2,048), 21 us at 3.35 TB/s. What the design does about it: the row is
// read once into shared memory; the selection passes touch shared memory
// only; the sort runs over the 2,048 survivors (66 stages over 8 KiB)
// instead of the 16,384-word padded row (105 stages over 128 KiB); 45 KiB
// of shared memory per CTA lets four CTAs share an SM, so one CTA's
// barriers hide behind another's work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWidth = 16384;  // keys per CTA
constexpr int kMaxTopk = 8192;
constexpr int kBins = 256;

// IEEE f32 bits -> uint32 with the same order (-0.0 as +0.0)
__device__ __forceinline__ uint32_t ordered32(uint32_t bits) {
  if (bits == 0x80000000u) bits = 0u;
  return (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
}

// bf16 bits -> uint16 with the same order (-0.0 as +0.0)
__device__ __forceinline__ uint32_t ordered16(uint32_t bits) {
  if (bits == 0x8000u) bits = 0u;
  return (bits & 0x8000u) ? (~bits & 0xffffu) : (bits | 0x8000u);
}

// K: the keys' raw bits; W: the (key, column) word
template <typename K> struct Words;
template <> struct Words<uint16_t> {
  using W = uint32_t;
  static __device__ __forceinline__ W make(uint16_t key, int col) {
    return (ordered16(key) << 16) | (uint32_t)col;
  }
  static __device__ __forceinline__ int col(W w) { return (int)(w & 0xffffu); }
};
template <> struct Words<uint32_t> {
  using W = unsigned long long;
  static __device__ __forceinline__ W make(uint32_t key, int col) {
    return ((W)ordered32(key) << 32) | (uint32_t)col;
  }
  static __device__ __forceinline__ int col(W w) {
    return (int)(w & 0xffffffffull);
  }
};

// words[0, w) of the row, 16-byte loads where the row start allows
template <typename K>
__device__ __forceinline__ void load_words(const K* __restrict__ src, int w,
                                           typename Words<K>::W* words) {
  constexpr int kVec = 16 / sizeof(K);
  int head = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    head = (w / kVec) * kVec;
    for (int v = threadIdx.x; v < w / kVec; v += blockDim.x) {
      const uint4 raw = reinterpret_cast<const uint4*>(src)[v];
      const K* e = reinterpret_cast<const K*>(&raw);
#pragma unroll
      for (int u = 0; u < kVec; ++u)
        words[v * kVec + u] = Words<K>::make(e[u], v * kVec + u);
    }
  }
  for (int i = head + threadIdx.x; i < w; i += blockDim.x)
    words[i] = Words<K>::make(src[i], i);
}

// Block b handles slice b % slices of row b / slices: columns
// [s * slice_w, min((s + 1) * slice_w, n)), and writes its first
// min(topk, width) entries at out[row, s * topk + t].
template <typename K>
__global__ void __launch_bounds__(512)
sorted_topk_kernel(const K* __restrict__ keys, const int32_t* __restrict__ vals,
                   int64_t n, int slice_w, int slices, int topk, int p2,
                   K* __restrict__ out_keys, int32_t* __restrict__ out_vals,
                   int64_t out_w) {
  using W = typename Words<K>::W;
  constexpr int kBits = 8 * sizeof(W);
  extern __shared__ unsigned long long smem_u64[];
  W* words = reinterpret_cast<W*>(smem_u64);
  W* surv = words + slice_w;
  __shared__ int hist[kBins];
  __shared__ int pick[2];  // chosen bin, count below it
  __shared__ int n_surv;

  const int64_t row = blockIdx.x / slices;
  const int slice = blockIdx.x % slices;
  const int64_t c0 = (int64_t)slice * slice_w;
  const int w = n - c0 < slice_w ? (int)(n - c0) : slice_w;
  const int64_t base = row * n + c0;
  const int keep = topk < w ? topk : w;
  const int lane = threadIdx.x & 31;

  load_words<K>(keys + base, w, words);
  if (threadIdx.x == 0) n_surv = 0;
  __syncthreads();

  // radix select of the keep-th smallest word: afterwards exactly `keep`
  // words are <= limit
  W limit = ~(W)0;
  if (keep < w) {
    W prefix = 0, himask = 0;
    int rank = keep;  // 1-based rank within the words matching prefix
    for (int shift = kBits - 8; shift >= 0; shift -= 8) {
      for (int i = threadIdx.x; i < kBins; i += blockDim.x) hist[i] = 0;
      __syncthreads();
      for (int i0 = 0; i0 < w; i0 += blockDim.x) {  // warp-uniform trip count
        const int i = i0 + threadIdx.x;
        const W x = i < w ? words[i] : (W)0;
        const bool part = i < w && ((x ^ prefix) & himask) == 0;
        const unsigned active = __ballot_sync(0xffffffffu, part);
        if (part) {
          const int digit = (int)((x >> shift) & 0xff);
          const unsigned peers = __match_any_sync(active, digit);
          if (lane == __ffs(peers) - 1) atomicAdd(&hist[digit], __popc(peers));
        }
      }
      __syncthreads();
      if (threadIdx.x < 32) {
        // warp 0: the bin holding rank, from an inclusive scan of 8 bins
        // per lane
        int c[8], s = 0;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          c[u] = hist[lane * 8 + u];
          s += c[u];
        }
        int incl = s;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += y;
        }
        int below = incl - s;
        const bool mine = below < rank && rank <= incl;
        if (mine) {
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            if (below < rank && rank <= below + c[u]) {
              pick[0] = lane * 8 + u;
              pick[1] = below;
            }
            below += c[u];
          }
        }
      }
      __syncthreads();
      const int b = pick[0];
      rank -= pick[1];
      prefix |= (W)b << shift;
      himask |= (W)0xff << shift;
      const bool whole = hist[b] == rank;  // the bin is needed whole
      __syncthreads();                     // hist is cleared next pass
      if (whole) {
        limit = prefix | (shift ? (((W)1 << shift) - 1) : (W)0);
        break;
      }
    }
  }

  // cut: exactly `keep` words are <= limit; compact them (any order)
  for (int i0 = 0; i0 < w; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    const W x = i < w ? words[i] : ~(W)0;
    const bool in = i < w && x <= limit;
    const unsigned m = __ballot_sync(0xffffffffu, in);
    int at = 0;
    if (lane == 0 && m) at = atomicAdd(&n_surv, __popc(m));
    at = __shfl_sync(0xffffffffu, at, 0);
    if (in) surv[at + __popc(m & ((1u << lane) - 1))] = x;
  }
  __syncthreads();
  for (int i = keep + threadIdx.x; i < p2; i += blockDim.x) surv[i] = ~(W)0;
  __syncthreads();

  // bitonic sort of the p2 survivor slots, ascending: stage (k, j)
  // compare-exchanges i and i | j
  const int half = p2 >> 1;
  for (int k = 2; k <= p2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < half; p += blockDim.x) {
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const int l = i | j;
        const W a = surv[i], b = surv[l];
        if ((a > b) == ((i & k) == 0)) {
          surv[i] = b;
          surv[l] = a;
        }
      }
      __syncthreads();
    }
  }

  const int64_t out0 = row * out_w + (int64_t)slice * topk;
  for (int t = threadIdx.x; t < keep; t += blockDim.x) {
    const int col = Words<K>::col(surv[t]);
    out_keys[out0 + t] = keys[base + col];
    out_vals[out0 + t] = vals[base + col];
  }
}

template <typename K>
int launch(const void* keys, const int32_t* vals, int B, int64_t n,
           int slice_w, int topk, void* out_keys, int32_t* out_vals,
           int64_t out_w, cudaStream_t stream) {
  using W = typename Words<K>::W;
  const int64_t slices = (n + slice_w - 1) / slice_w;
  const int64_t grid = (int64_t)B * slices;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const int keep = topk < slice_w ? topk : slice_w;
  int p2 = 1;
  while (p2 < keep) p2 <<= 1;
  const size_t smem = (size_t)(slice_w + p2) * sizeof(W);
  // a warp per 32 survivor pairs or per 512 keys, at least 2 warps, at
  // most 16
  int threads = 64;
  while (threads < 512 && (threads < p2 / 2 || threads * 16 < slice_w))
    threads <<= 1;
  cudaError_t err = cudaFuncSetAttribute(
      sorted_topk_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  sorted_topk_kernel<K><<<(unsigned)grid, threads, smem, stream>>>(
      static_cast<const K*>(keys), vals, n, slice_w, (int)slices, topk, p2,
      static_cast<K*>(out_keys), out_vals, out_w);
  return (int)cudaGetLastError();
}

}  // namespace

// keys: f32 or bf16 [B, n] (is_bf16 selects); vals: int32 [B, n]. Each row
// is cut into ceil(n / slice_w) slices; slice s of row r writes its
// min(topk, width of s) smallest (key, payload) pairs, ascending, at
// out[r, s * topk ...] of out_keys (the keys' dtype) / out_vals, both
// [B, out_w]. 1 <= slice_w <= 16384, 1 <= topk <= 8192; topk <= slice_w
// when there is more than one slice. Returns the CUDA error code of the
// launch (0 on success).
extern "C" int vdb_sorted_topk(const void* keys, int is_bf16,
                               const int32_t* vals, int B, long long n,
                               int slice_w, int topk, void* out_keys,
                               int32_t* out_vals, long long out_w,
                               void* stream) {
  if (slice_w < 1 || slice_w > kMaxWidth || topk < 1 || topk > kMaxTopk ||
      n < 1 || B < 0)
    return (int)cudaErrorInvalidValue;
  if (n > slice_w && topk > slice_w) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<uint16_t>(keys, vals, B, n, slice_w, topk, out_keys,
                                    out_vals, out_w, s)
                 : launch<uint32_t>(keys, vals, B, n, slice_w, topk, out_keys,
                                    out_vals, out_w, s);
}
