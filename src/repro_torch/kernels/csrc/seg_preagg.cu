// Dense GROUP BY under a validity mask: per-key count, and sum / min / max
// per aggregate, over keys clipped into [0, domain).
//
// Replaces the Pallas kernel src/repro/kernels/seg_preagg.py
// (seg_preagg_pallas / _preagg_call / _make_kernel), whose contract is
// operators.groupby_dense: negative keys merge into group 0, counts and int
// sums are int32 and wrap, float sums are f32, min/max start from the
// dtype's sentinels (the wrapper initialises the outputs with them).
//
// Bound on the H100: bytes -- each row is read once (key, mask, one value
// per aggregate) and each output written once.  Design: a grid-stride loop
// over rows, one global atomic per valid row and aggregate.  The TPU kernel
// kept a (block, domain) one-hot in VMEM and so capped the domain at 1024;
// atomics into device memory take any domain (the planner allows up to
// 2^20).  What holds it back today is atomic contention when many rows hit
// few keys (domain ~100): those updates serialise in L2.  Privatising the
// partials in shared memory for small domains is the next step.
//
// Float min/max: float_atomics.cuh.
#include <cstdint>
#include <cuda_runtime.h>

#include "float_atomics.cuh"

#define SEG_MAX_AGGS 32

enum AggKind { AGG_SUM = 0, AGG_MIN = 1, AGG_MAX = 2 };

struct AggSpecs {
  int n;
  int kind[SEG_MAX_AGGS];
  int is_float[SEG_MAX_AGGS];
  const void* vals[SEG_MAX_AGGS];
  void* out[SEG_MAX_AGGS];
};

__global__ void seg_preagg_kernel(const int32_t* __restrict__ keys,
                                  const bool* __restrict__ valid,
                                  long long n, int domain,
                                  int32_t* __restrict__ counts,
                                  AggSpecs specs) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n; i += (long long)gridDim.x * blockDim.x) {
    if (!valid[i]) continue;
    int k = keys[i];
    k = k < 0 ? 0 : (k >= domain ? domain - 1 : k);
    atomicAdd(&counts[k], 1);
    for (int a = 0; a < specs.n; ++a) {
      if (specs.is_float[a]) {
        const float v = ((const float*)specs.vals[a])[i];
        float* o = (float*)specs.out[a] + k;
        if (specs.kind[a] == AGG_SUM) atomicAdd(o, v);
        else if (specs.kind[a] == AGG_MIN) atomic_min_f32(o, v);
        else atomic_max_f32(o, v);
      } else {
        const int32_t v = ((const int32_t*)specs.vals[a])[i];
        int32_t* o = (int32_t*)specs.out[a] + k;
        if (specs.kind[a] == AGG_SUM) atomicAdd(o, v);   // wraps mod 2^32
        else if (specs.kind[a] == AGG_MIN) atomicMin(o, v);
        else atomicMax(o, v);
      }
    }
  }
}

extern "C" int seg_preagg_launch(const void* keys, const void* valid,
                                 long long n, int domain, void* counts,
                                 int n_aggs, const int* kinds,
                                 const int* is_float,
                                 const void* const* vals,
                                 void* const* outs, void* stream) {
  if (n_aggs < 0 || n_aggs > SEG_MAX_AGGS) return (int)cudaErrorInvalidValue;
  AggSpecs specs;
  specs.n = n_aggs;
  for (int a = 0; a < n_aggs; ++a) {
    specs.kind[a] = kinds[a];
    specs.is_float[a] = is_float[a];
    specs.vals[a] = vals[a];
    specs.out[a] = outs[a];
  }
  if (n == 0) return (int)cudaGetLastError();
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;   // grid-stride beyond this
  seg_preagg_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)keys, (const bool*)valid, n, domain, (int32_t*)counts,
      specs);
  return (int)cudaGetLastError();
}
