// Per-key count, sum, min and max straight from RLE runs.
//
// Replaces the Pallas kernel src/repro/kernels/rle_scan_agg.py
// (rle_grouped_agg / _grouped_kernel).  A run of key k, length L and value
// v contributes L rows of v to key k.  Runs whose key lies outside
// [lo, hi] or [0, domain), or whose length is 0, drop out -- the mask of
// rle_scan_agg.py:89-90, evaluated in f32 like the reference.  Empty keys
// read count 0, sum 0, min +3.4e38, max -3.4e38 (the wrapper initialises
// the outputs).  Unlike the TPU kernel, the count is int32 (atomicAdd of
// the run length): an f32 count rounds once a key passes 2^24 rows.
//
// Bound on the H100: bytes -- one pass over the runs (key, length, value)
// and one write of the (4, domain) table.  Design: one thread per run with
// global atomics.  The TPU kernel contracted a (runs, domain) one-hot on the
// MXU; on this card a run touches one key, so a scatter of O(runs) atomics
// does O(runs) work instead of O(runs x domain).  Runs of a sorted RLE
// column rarely share a key within a block, so contention is low.
#include <cstdint>
#include <cuda_runtime.h>

#include "float_atomics.cuh"

__global__ void rle_grouped_agg_kernel(const int32_t* __restrict__ keys,
                                       const int32_t* __restrict__ lengths,
                                       const float* __restrict__ values,
                                       long long n_runs, int domain,
                                       float lo, float hi,
                                       int32_t* __restrict__ count,
                                       float* __restrict__ sum,
                                       float* __restrict__ mn,
                                       float* __restrict__ mx) {
  const float fdomain = (float)domain;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n_runs; i += (long long)gridDim.x * blockDim.x) {
    const int32_t key = keys[i];
    const int32_t len = lengths[i];
    const float fk = (float)key;
    if (!(fk >= lo && fk <= hi && len > 0 && fk >= 0.f && fk < fdomain))
      continue;
    const int k = key < 0 ? 0 : (key >= domain ? domain - 1 : key);
    const float v = values[i];
    atomicAdd(&count[k], len);
    atomicAdd(&sum[k], v * (float)len);
    atomic_min_f32(&mn[k], v);
    atomic_max_f32(&mx[k], v);
  }
}

extern "C" int rle_grouped_agg_launch(const void* keys, const void* lengths,
                                      const void* values, long long n_runs,
                                      int domain, float lo, float hi,
                                      void* count, void* sum, void* mn,
                                      void* mx, void* stream) {
  if (n_runs == 0) return (int)cudaGetLastError();
  const int threads = 256;
  long long blocks = (n_runs + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;
  rle_grouped_agg_kernel<<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(
      (const int32_t*)keys, (const int32_t*)lengths, (const float*)values,
      n_runs, domain, lo, hi, (int32_t*)count, (float*)sum, (float*)mn,
      (float*)mx);
  return (int)cudaGetLastError();
}
