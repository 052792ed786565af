// Per-key count, sum, min and max straight from RLE runs, over a list of
// run segments (one per ROS container) in one launch.
//
// Replaces the Pallas kernel src/repro/kernels/rle_scan_agg.py
// (rle_grouped_agg / _grouped_kernel).  A run of key k, length L and value
// v contributes L rows of v to key k.  Runs whose key lies outside
// [lo, hi] or [0, domain), or whose length is 0, drop out -- the mask of
// rle_scan_agg.py:89-90, evaluated in f32 like the reference.  Empty keys
// read count 0, sum 0, min +3.4e38, max -3.4e38.  Unlike the TPU kernel,
// the count is int32 (atomicAdd of the run length): an f32 count rounds
// once a key passes 2^24 rows.  A segment without values takes its key as
// the value (the wrapper's default), read here as (float)key.
//
// Bound on the H100: bytes -- one pass over the runs (key, length, value)
// and one write of the (4, domain) table; at the main path's sizes (a few
// thousand runs) it is the launch itself.  Design: one C call takes up to
// RLE_MAX_SEGS segments by value in the kernel's parameters, so a scan of
// every container is one launch with no host-side concatenation.  Each
// thread walks run indices of the concatenation and advances its segment
// pointer monotonically.  Each CTA folds its runs into a (4, domain) table
// in shared memory and flushes the keys it touched with global atomics
// (a lane equal to its identity is skipped: adding 0, or min against the
// sentinel, changes nothing).  When the grid is one CTA and this call
// starts the result, that CTA writes the whole table, sentinels included,
// and nothing else runs; otherwise a small init kernel on the same stream
// writes the sentinels first.  A domain whose table does not fit in
// shared memory takes the global-atomic loop of the same kernel.  The TPU
// kernel contracted a (runs, domain) one-hot on the MXU; here a run
// touches one key, so the work is O(runs), not O(runs x domain).
#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#include "float_atomics.cuh"
#include "smem_opt_in.cuh"

#define RLE_MAX_SEGS 64

constexpr float kPos = 3.4e38f, kNeg = -3.4e38f;
constexpr int kSharedThreads = 1024;
constexpr int kRunsPerThread = 8;             // runs a thread folds per CTA
constexpr int kSmemMax = 232448;              // H100: 227 KB per block

struct RleSegs {
  int n;
  long long start[RLE_MAX_SEGS + 1];          // prefix sums of run counts
  const int32_t* keys[RLE_MAX_SEGS];
  const int32_t* lengths[RLE_MAX_SEGS];
  const float* values[RLE_MAX_SEGS];          // null: the key is the value
};

__global__ void rle_grouped_agg_init_kernel(int domain, int32_t* count,
                                            float* sum, float* mn,
                                            float* mx) {
  for (int k = blockIdx.x * blockDim.x + threadIdx.x; k < domain;
       k += gridDim.x * blockDim.x) {
    count[k] = 0;
    sum[k] = 0.f;
    mn[k] = kPos;
    mx[k] = kNeg;
  }
}

// SHARED: fold into a per-CTA table in shared memory, then flush (or, with
// ``direct``, the one CTA writes the outputs); else global atomics per run.
template <bool SHARED>
__global__ void __launch_bounds__(kSharedThreads)
rle_grouped_agg_kernel(const __grid_constant__ RleSegs segs, long long total,
                       int domain, float lo, float hi, int direct,
                       int32_t* __restrict__ count, float* __restrict__ sum,
                       float* __restrict__ mn, float* __restrict__ mx) {
  extern __shared__ int32_t smem[];
  int32_t* tc = smem;
  float* ts = (float*)(smem + domain);
  float* tmn = ts + domain;
  float* tmx = tmn + domain;
  if (SHARED) {
    for (int k = threadIdx.x; k < domain; k += blockDim.x) {
      tc[k] = 0;
      ts[k] = 0.f;
      tmn[k] = kPos;
      tmx[k] = kNeg;
    }
    __syncthreads();
  }
  const float fdomain = (float)domain;
  int s = 0;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    while (segs.start[s + 1] <= i) ++s;        // i only grows
    const long long r = i - segs.start[s];
    const int32_t key = segs.keys[s][r];
    const int32_t len = segs.lengths[s][r];
    const float fk = (float)key;
    if (!(fk >= lo && fk <= hi && len > 0 && fk >= 0.f && fk < fdomain))
      continue;
    const int k = key < 0 ? 0 : (key >= domain ? domain - 1 : key);
    const float v = segs.values[s] ? segs.values[s][r] : fk;
    if (SHARED) {
      atomicAdd(&tc[k], len);
      atomicAdd(&ts[k], v * (float)len);
      atomic_min_f32(&tmn[k], v);
      atomic_max_f32(&tmx[k], v);
    } else {
      atomicAdd(&count[k], len);
      atomicAdd(&sum[k], v * (float)len);
      atomic_min_f32(&mn[k], v);
      atomic_max_f32(&mx[k], v);
    }
  }
  if (!SHARED) return;
  __syncthreads();
  for (int k = threadIdx.x; k < domain; k += blockDim.x) {
    if (direct) {
      count[k] = tc[k];
      sum[k] = ts[k];
      mn[k] = tmn[k];
      mx[k] = tmx[k];
      continue;
    }
    if (tc[k] != 0) atomicAdd(&count[k], tc[k]);
    if (ts[k] != 0.f) atomicAdd(&sum[k], ts[k]);
    if (tmn[k] != kPos) atomic_min_f32(&mn[k], tmn[k]);
    if (tmx[k] != kNeg) atomic_max_f32(&mx[k], tmx[k]);
  }
}

// out: one (4, domain) buffer of 4-byte words -- count (int32), sum, min,
// max (f32).  values[s] may be null.  ``init`` 1 starts the result (the
// first call of a list); 0 adds to what earlier calls left there.
extern "C" int rle_grouped_agg_launch(int n_segs, const void* const* keys,
                                      const void* const* lengths,
                                      const void* const* values,
                                      const long long* n_runs, int domain,
                                      float lo, float hi, int init, void* out,
                                      void* stream) {
  if (n_segs < 0 || n_segs > RLE_MAX_SEGS || domain < 1)
    return (int)cudaErrorInvalidValue;
  RleSegs segs;
  segs.n = n_segs;
  segs.start[0] = 0;
  for (int s = 0; s < n_segs; ++s) {
    segs.keys[s] = (const int32_t*)keys[s];
    segs.lengths[s] = (const int32_t*)lengths[s];
    segs.values[s] = (const float*)values[s];
    segs.start[s + 1] = segs.start[s] + n_runs[s];
  }
  for (int s = n_segs + 1; s <= RLE_MAX_SEGS; ++s)
    segs.start[s] = segs.start[n_segs];
  const long long total = segs.start[n_segs];
  cudaStream_t st = (cudaStream_t)stream;
  int32_t* count = (int32_t*)out;
  float* sum = (float*)out + domain;
  float* mn = sum + domain;
  float* mx = mn + domain;
  const size_t smem = (size_t)domain * 16;
  const bool shared = smem <= (size_t)kSmemMax;
  const long long per_cta =
      shared ? (long long)kSharedThreads * kRunsPerThread : 256;
  long long blocks = (total + per_cta - 1) / per_cta;
  if (blocks > 132LL * 8) blocks = 132LL * 8;  // grid-stride beyond this
  const int direct = shared && init && blocks <= 1;
  if (init && !direct) {
    rle_grouped_agg_init_kernel<<<(domain + 255) / 256, 256, 0, st>>>(
        domain, count, sum, mn, mx);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (total == 0 && !direct) return (int)cudaGetLastError();
  if (blocks < 1) blocks = 1;                  // direct with no runs
  if (shared) {
    if (smem > 48 * 1024) {
      static std::atomic<unsigned long long> opted{0};   // once per device
      const cudaError_t e =
          opt_in_smem(opted, rle_grouped_agg_kernel<true>, kSmemMax);
      if (e != cudaSuccess) return (int)e;
    }
    rle_grouped_agg_kernel<true><<<(unsigned)blocks, kSharedThreads, smem,
                                   st>>>(segs, total, domain, lo, hi,
                                         direct, count, sum, mn, mx);
  } else {
    rle_grouped_agg_kernel<false><<<(unsigned)blocks, 256, 0, st>>>(
        segs, total, domain, lo, hi, 0, count, sum, mn, mx);
  }
  return (int)cudaGetLastError();
}
