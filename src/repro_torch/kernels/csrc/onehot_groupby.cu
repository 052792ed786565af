// Per-block dense GROUP BY partials: count and sum per key, in f32.
//
// Replaces the Pallas kernel src/repro/kernels/hash_groupby.py
// (onehot_groupby / _kernel): keys (nb, B) int32, values (nb, B) int32 or
// f32 (cast to f32 one by one, one instantiation each) -> (nb, domain, 2)
// f32, count then sum.  A key outside [0, domain) has an all-zero one-hot
// row in the reference and so drops out; it is not clipped into a group.
// The domain is at most 1024, the reference's cap (the wrapper checks it).
//
// Bound on the H100: bytes -- one read of the keys and values and one write
// of the (nb, domain, 2) partials.  Design: one CTA per block row, its
// table in shared memory (the paper's cache-sized prepass table), where the
// TPU kernel contracted a (B, domain) one-hot on the MXU.  Each thread owns
// a contiguous chunk of kChunk columns of a tile of kThreads x kChunk:
// * it loads the whole chunk first, keys and values by 16-byte vector
//   loads (one element at a time where the row's address is not 16-byte
//   aligned, or past the row's end), so all its loads are in flight before
//   the first atomic;
// * it folds runs of equal in-domain keys in registers, and adds each run
//   into the table with one count and one sum atomic.  An out-of-domain
//   key adds nothing and does not end a run (it is skipped, never added);
//   a run that crosses into the next chunk takes one pair of atomics in
//   each.  Keys sorted within a day (Q3) are one or two runs a chunk.
// Counts go into an int32 table and become f32 at write-out, so they are
// exact; sums are f32 adds of f32 values, never int adds that could wrap.
// Merging a warp's runs with __match_any_sync, and one table per warp,
// were measured against this fold and not kept (PERF.md §6).
#include <cstdint>
#include <cuda_runtime.h>

constexpr int kThreads = 256;
constexpr int kChunk = 16;                   // columns a thread folds
constexpr int kTile = kThreads * kChunk;     // 4096: the path's block
constexpr int kMaxDomain = 1024;

template <typename V> struct Vec4;
template <> struct Vec4<float> { using T = float4; };
template <> struct Vec4<int32_t> { using T = int4; };

template <typename V>
__global__ void __launch_bounds__(kThreads)
onehot_groupby_kernel(const int32_t* __restrict__ keys,
                      const V* __restrict__ values, int n_cols, int domain,
                      float* __restrict__ out) {
  __shared__ int cnt[kMaxDomain];
  __shared__ float sum[kMaxDomain];
  for (int j = threadIdx.x; j < domain; j += kThreads) {
    cnt[j] = 0;
    sum[j] = 0.f;
  }
  __syncthreads();

  const long long row = blockIdx.x;
  const int32_t* k = keys + row * n_cols;
  const V* v = values + row * n_cols;
  const bool vec = ((reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  for (int base = 0; base < n_cols; base += kTile) {
    const int start = base + threadIdx.x * kChunk;
    int32_t kk[kChunk];
    float vv[kChunk];
    // loads first: the whole chunk, before any atomic
#pragma unroll
    for (int q = 0; q < kChunk / 4; ++q) {
      const int i = start + 4 * q;
      if (vec && i + 4 <= n_cols) {
        const int4 k4 = *reinterpret_cast<const int4*>(k + i);
        const typename Vec4<V>::T v4 =
            *reinterpret_cast<const typename Vec4<V>::T*>(v + i);
        kk[4 * q] = k4.x; kk[4 * q + 1] = k4.y;
        kk[4 * q + 2] = k4.z; kk[4 * q + 3] = k4.w;
        vv[4 * q] = (float)v4.x; vv[4 * q + 1] = (float)v4.y;
        vv[4 * q + 2] = (float)v4.z; vv[4 * q + 3] = (float)v4.w;
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const bool in = i + u < n_cols;
          kk[4 * q + u] = in ? k[i + u] : -1;      // past the row: no key
          vv[4 * q + u] = in ? (float)v[i + u] : 0.f;
        }
      }
    }
    // then the fold: one count and one sum atomic per run
    int run_key = -1, run_n = 0;
    float run_s = 0.f;
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int32_t key = kk[u];
      const bool in = (uint32_t)key < (uint32_t)domain;
      const bool starts = in && key != run_key;
      if (starts && run_n > 0) {
        atomicAdd(&cnt[run_key], run_n);
        atomicAdd(&sum[run_key], run_s);
      }
      if (starts) {
        run_key = key;
        run_n = 0;
        run_s = 0.f;
      }
      if (in) {
        ++run_n;
        run_s += vv[u];
      }
    }
    if (run_n > 0) {
      atomicAdd(&cnt[run_key], run_n);
      atomicAdd(&sum[run_key], run_s);
    }
  }
  __syncthreads();
  // write-out: [key][count, sum], one coalesced float2 per key
  float2* o = reinterpret_cast<float2*>(out + row * 2LL * domain);
  for (int j = threadIdx.x; j < domain; j += kThreads)
    o[j] = make_float2((float)cnt[j], sum[j]);
}

// values_float: 1 for f32, 0 for int32.
extern "C" int onehot_groupby_launch(const void* keys, const void* values,
                                     int values_float, int n_blocks,
                                     int n_cols, int domain, void* out,
                                     void* stream) {
  if (domain < 1 || domain > kMaxDomain || n_cols < 0)
    return (int)cudaErrorInvalidValue;
  if (n_blocks == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* k = (const int32_t*)keys;
  float* o = (float*)out;
  if (values_float)
    onehot_groupby_kernel<float><<<n_blocks, kThreads, 0, s>>>(
        k, (const float*)values, n_cols, domain, o);
  else
    onehot_groupby_kernel<int32_t><<<n_blocks, kThreads, 0, s>>>(
        k, (const int32_t*)values, n_cols, domain, o);
  return (int)cudaGetLastError();
}
