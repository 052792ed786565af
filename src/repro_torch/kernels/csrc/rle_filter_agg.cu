// Per-block count, sum and max of the rows of RLE runs inside [lo, hi].
//
// Replaces the Pallas kernel src/repro/kernels/rle_scan_agg.py
// (rle_filter_agg / _kernel).  A run of value v and length L passes when
// lo <= v <= hi and L > 0, evaluated in f32 after casting the run value
// and length, as the reference does; it adds L rows, L * v to the sum and
// v to the max.  Output (nb, 3) f32 [count, sum, max]; a block with no
// passing run reads [0, 0, -inf].  The reference pads R to a multiple of
// 128 with zero lengths, which drop out, so no padding is needed here.
//
// Bound on the H100: bytes -- one read of the runs and one (nb, 3) write.
// At the main path's shape (123 blocks of 4 runs) it is launch-bound.
// Design: one warp per block row.  The TPU kernel reduced a whole (1, R)
// strip per sequential grid step; here each lane strides over the row's
// runs and the warp reduces count, sum and max with shuffles, so a row
// costs one coalesced pass and no shared memory.  The values and lengths
// arrive as int32 or f32 (one instantiation per pair).
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

template <typename V, typename L>
__global__ void rle_filter_agg_kernel(const V* __restrict__ values,
                                      const L* __restrict__ lengths,
                                      int n_blocks, int n_runs, float lo,
                                      float hi, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int row = (int)((blockIdx.x * (long long)blockDim.x + threadIdx.x)
                        >> 5);
  if (row >= n_blocks) return;          // whole warps leave together
  const V* rv = values + (long long)row * n_runs;
  const L* rl = lengths + (long long)row * n_runs;
  float cnt = 0.f, sum = 0.f, mx = -INFINITY;
  for (int r = lane; r < n_runs; r += 32) {
    const float v = (float)rv[r];
    const float len = (float)rl[r];
    if (v >= lo && v <= hi && len > 0.f) {
      cnt += len;
      sum += v * len;
      mx = fmaxf(mx, v);
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    cnt += __shfl_down_sync(0xffffffffu, cnt, off);
    sum += __shfl_down_sync(0xffffffffu, sum, off);
    mx = fmaxf(mx, __shfl_down_sync(0xffffffffu, mx, off));
  }
  if (lane == 0) {
    out[row * 3LL + 0] = cnt;
    out[row * 3LL + 1] = sum;
    out[row * 3LL + 2] = mx;
  }
}

template <typename V, typename L>
static void launch(const void* values, const void* lengths, int n_blocks,
                   int n_runs, float lo, float hi, void* out,
                   cudaStream_t stream) {
  const int threads = 256;                      // 8 rows per CTA
  const long long blocks = ((long long)n_blocks * 32 + threads - 1) / threads;
  rle_filter_agg_kernel<V, L><<<(unsigned)blocks, threads, 0, stream>>>(
      (const V*)values, (const L*)lengths, n_blocks, n_runs, lo, hi,
      (float*)out);
}

// values_float / lengths_float: 1 for f32, 0 for int32.
extern "C" int rle_filter_agg_launch(const void* values, const void* lengths,
                                     int values_float, int lengths_float,
                                     int n_blocks, int n_runs, float lo,
                                     float hi, void* out, void* stream) {
  if (n_blocks == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (values_float && lengths_float)
    launch<float, float>(values, lengths, n_blocks, n_runs, lo, hi, out, s);
  else if (values_float)
    launch<float, int32_t>(values, lengths, n_blocks, n_runs, lo, hi, out, s);
  else if (lengths_float)
    launch<int32_t, float>(values, lengths, n_blocks, n_runs, lo, hi, out, s);
  else
    launch<int32_t, int32_t>(values, lengths, n_blocks, n_runs, lo, hi, out,
                             s);
  return (int)cudaGetLastError();
}
