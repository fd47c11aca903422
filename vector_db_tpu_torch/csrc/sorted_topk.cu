// Exact ascending top-`topk` of each row of keys, with an int32 payload
// carried along: the wide-beam pool merge.
//
// Replaces the Pallas TPU kernel
// vector_db_tpu/ops/pallas/bitonic_merge.py:sorted_topk (and its blocked
// form _blocked_topk with the bodies _kernel, _kernel_slice_sort,
// _kernel_merge_pair, _kernel_merge). The TPU kernel sorts a block of 32-64
// rows at a time in VMEM with lane rotates, and for rows wider than 4096
// streams sorted slices through HBM in merge-halve rounds. Here one CTA
// owns one row (or one 16,384-wide slice of it): the row lives in shared
// memory as 64-bit words (order-preserving key bits << 32 | column), padded
// to the next power of two with all-ones words that sort last, and a
// bitonic network sorts the words with __syncthreads between stages. The
// column in the low bits makes the order total, so the result is the
// stable sort: equal keys come out adjacent and in column order, and the
// two halves of every compare-exchange agree because one thread makes it.
// bf16 keys widen to f32 bits exactly (<< 16); -0.0 orders as +0.0. The
// payload never moves during the sort: the first `topk` words' columns
// gather the key (in its own dtype) and the payload from device memory at
// the end.
//
// Width: 16,384 words are 128 KiB of dynamic shared memory (the attribute
// is raised above 48 KiB), one CTA per SM. A wider row is cut into
// 16,384-wide slices; each slice keeps its own top `topk` and the wrapper
// sorts the survivors in a second launch. That is exact: the top-P of a
// union is the top-P of the parts' top-Ps, and the survivors keep slice
// order, so ties still resolve by column.
//
// What bounds it on the H100: shared-memory traffic, not device memory. At
// the wide-beam main shape (B = 1024 rows of 9,216 bf16 keys, padded to
// 16,384; topk = 2,048) the kernel reads 57 MB and writes 13 MB of device
// memory (~21 us at 3.35 TB/s), but each row runs 105 network stages, each
// reading and writing 128 KiB of shared memory. The design accepts that for
// a first, simple kernel; a register-resident first stages and a partial
// (top-k only) merge network would cut it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWidth = 16384;  // words per CTA: 128 KiB of shared memory
constexpr int kMaxThreads = 1024;

// IEEE f32 bits -> uint32 with the same order (-0.0 as +0.0)
__device__ __forceinline__ uint32_t ordered(uint32_t bits) {
  if (bits == 0x80000000u) bits = 0u;
  return (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
}

template <typename K>
__device__ __forceinline__ uint32_t f32_bits(K key);

template <>
__device__ __forceinline__ uint32_t f32_bits<uint32_t>(uint32_t key) {
  return key;
}

template <>
__device__ __forceinline__ uint32_t f32_bits<uint16_t>(uint16_t key) {
  return (uint32_t)key << 16;  // bf16 -> f32, exact
}

// K: the keys' raw bits (uint32_t for f32, uint16_t for bf16). Block b
// sorts slice b % slices of row b / slices: columns
// [s * slice_w, min((s + 1) * slice_w, n)), and writes its first
// min(topk, width) entries at out[row, s * topk + t].
template <typename K>
__global__ void __launch_bounds__(kMaxThreads)
sorted_topk_kernel(const K* __restrict__ keys, const int32_t* __restrict__ vals,
                   int64_t n, int slice_w, int slices, int topk,
                   K* __restrict__ out_keys, int32_t* __restrict__ out_vals,
                   int64_t out_w) {
  extern __shared__ unsigned long long words[];
  const int64_t row = blockIdx.x / slices;
  const int slice = blockIdx.x % slices;
  const int64_t c0 = (int64_t)slice * slice_w;
  const int w = n - c0 < slice_w ? (int)(n - c0) : slice_w;
  int width = 1;
  while (width < w) width <<= 1;
  const int64_t base = row * n + c0;

  for (int i = threadIdx.x; i < width; i += blockDim.x)
    words[i] = i < w ? ((unsigned long long)ordered(f32_bits<K>(keys[base + i]))
                        << 32) | (unsigned)i
                     : ~0ull;
  __syncthreads();

  // bitonic sort, ascending: stage (k, j) compare-exchanges i and i | j
  const int half = width >> 1;
  for (int k = 2; k <= width; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < half; p += blockDim.x) {
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const int l = i | j;
        const unsigned long long a = words[i], b = words[l];
        if ((a > b) == ((i & k) == 0)) {
          words[i] = b;
          words[l] = a;
        }
      }
      __syncthreads();
    }
  }

  const int keep = topk < w ? topk : w;
  const int64_t out0 = row * out_w + (int64_t)slice * topk;
  for (int t = threadIdx.x; t < keep; t += blockDim.x) {
    const int col = (int)(words[t] & 0xffffffffull);
    out_keys[out0 + t] = keys[base + col];
    out_vals[out0 + t] = vals[base + col];
  }
}

template <typename K>
int launch(const void* keys, const int32_t* vals, int B, int64_t n,
           int slice_w, int topk, void* out_keys, int32_t* out_vals,
           int64_t out_w, cudaStream_t stream) {
  const int64_t slices = (n + slice_w - 1) / slice_w;
  const int64_t grid = (int64_t)B * slices;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  int width = 1;
  while (width < slice_w) width <<= 1;
  const size_t smem = (size_t)width * sizeof(unsigned long long);
  const int threads = width / 2 < 32 ? 32
                      : (width / 2 > kMaxThreads ? kMaxThreads : width / 2);
  cudaError_t err = cudaFuncSetAttribute(
      sorted_topk_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  sorted_topk_kernel<K><<<(unsigned)grid, threads, smem, stream>>>(
      static_cast<const K*>(keys), vals, n, slice_w, (int)slices, topk,
      static_cast<K*>(out_keys), out_vals, out_w);
  return (int)cudaGetLastError();
}

}  // namespace

// keys: f32 or bf16 [B, n] (is_bf16 selects); vals: int32 [B, n]. Each row
// is cut into ceil(n / slice_w) slices; slice s of row r writes its
// min(topk, width of s) smallest (key, payload) pairs, ascending, at
// out[r, s * topk ...] of out_keys (the keys' dtype) / out_vals, both
// [B, out_w]. 1 <= slice_w <= 16384; topk <= slice_w when there is more
// than one slice. Returns the CUDA error code of the launch (0 on success).
extern "C" int vdb_sorted_topk(const void* keys, int is_bf16,
                               const int32_t* vals, int B, long long n,
                               int slice_w, int topk, void* out_keys,
                               int32_t* out_vals, long long out_w,
                               void* stream) {
  if (slice_w < 1 || slice_w > kMaxWidth || topk < 1 || n < 1 || B < 0)
    return (int)cudaErrorInvalidValue;
  if (n > slice_w && topk > slice_w) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<uint16_t>(keys, vals, B, n, slice_w, topk, out_keys,
                                    out_vals, out_w, s)
                 : launch<uint32_t>(keys, vals, B, n, slice_w, topk, out_keys,
                                    out_vals, out_w, s);
}
