// Per-block dense GROUP BY partials: count and sum per key, in f32.
//
// Replaces the Pallas kernel src/repro/kernels/hash_groupby.py
// (onehot_groupby / _kernel): keys (nb, B) int32, values (nb, B) int32 or
// f32 (cast to f32, one instantiation each) -> (nb, domain, 2) f32, count
// then sum.  A key outside [0, domain) has an all-zero one-hot row in the
// reference and so drops out; it is not clipped into a group.  The domain
// is at most 1024, the reference's cap (the wrapper checks it).
//
// Bound on the H100: bytes -- one read of the keys and values and one write
// of the (nb, domain, 2) partials.  Design: one CTA per block row.  The TPU
// kernel built the (B, domain) one-hot and contracted it on the MXU; here
// the block's table lives in shared memory (domain x 2 floats, 8 KB at
// most), zeroed in-kernel, and each row adds into it with a shared-memory
// atomicAdd -- the paper's cache-sized prepass table.  Contention on a hot
// key stays inside one SM instead of serialising in L2.  The table is
// kept interleaved [key][count, sum], so its write-out is one coalesced
// copy of the output row.
#include <cstdint>
#include <cuda_runtime.h>

constexpr int kThreads = 512;
constexpr int kMaxDomain = 1024;

template <typename V>
__global__ void onehot_groupby_kernel(const int32_t* __restrict__ keys,
                                      const V* __restrict__ values,
                                      int n_cols, int domain,
                                      float* __restrict__ out) {
  __shared__ float table[2 * kMaxDomain];
  const long long row = blockIdx.x;
  for (int j = threadIdx.x; j < 2 * domain; j += blockDim.x) table[j] = 0.f;
  __syncthreads();
  const int32_t* k = keys + row * n_cols;
  const V* v = values + row * n_cols;
  for (int i = threadIdx.x; i < n_cols; i += blockDim.x) {
    const int32_t key = k[i];
    if (key >= 0 && key < domain) {
      atomicAdd(&table[2 * key], 1.f);
      atomicAdd(&table[2 * key + 1], (float)v[i]);
    }
  }
  __syncthreads();
  float* o = out + row * 2LL * domain;
  for (int j = threadIdx.x; j < 2 * domain; j += blockDim.x) o[j] = table[j];
}

// values_float: 1 for f32, 0 for int32.
extern "C" int onehot_groupby_launch(const void* keys, const void* values,
                                     int values_float, int n_blocks,
                                     int n_cols, int domain, void* out,
                                     void* stream) {
  if (domain < 1 || domain > kMaxDomain) return (int)cudaErrorInvalidValue;
  if (n_blocks == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (values_float)
    onehot_groupby_kernel<float><<<n_blocks, kThreads, 0, s>>>(
        (const int32_t*)keys, (const float*)values, n_cols, domain,
        (float*)out);
  else
    onehot_groupby_kernel<int32_t><<<n_blocks, kThreads, 0, s>>>(
        (const int32_t*)keys, (const int32_t*)values, n_cols, domain,
        (float*)out);
  return (int)cudaGetLastError();
}
