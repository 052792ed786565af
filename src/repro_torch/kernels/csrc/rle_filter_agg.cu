// Per-block count, sum and max of the rows of RLE runs inside [lo, hi],
// over a list of run segments (one per ROS container) in one launch.
//
// Replaces the Pallas kernel src/repro/kernels/rle_scan_agg.py
// (rle_filter_agg / _kernel).  A run of value v and length L passes when
// lo <= v <= hi and L > 0, evaluated in f32 after casting the run value
// and length, as the reference does; it adds L rows, L * v to the sum and
// v to the max.  Each segment is one (nb, R) pair of run values and
// lengths, int32 or f32 each; its output is (nb, 3) f32 [count, sum, max],
// written at the segment's row offset into the call's concatenated output.
// A block with no passing run reads [0, 0, -inf].  The reference pads R to
// a multiple of 128 with zero lengths, which drop out, so no padding is
// needed here.
//
// Bound on the H100: bytes -- one read of the runs and one (nb, 3) write.
// At the main path's shapes (12 containers of 123 blocks of 4 runs) a
// launch moves 20 KB, so it is the launch itself: a call per container
// pays that floor 12 times a scan.  Design: one C call takes up to
// RLE_FILTER_MAX_SEGS segments by value in the kernel's parameters (the
// segment table: pointers, nb, R, dtype flags, output offsets, and the
// prefix sums of each segment's warps), so a scan is one launch.  Threads
// map to runs, not rows: a row of R <= 32 runs takes next_pow2(R) lanes,
// so a warp holds 32 / next_pow2(R) rows, and count, sum and max reduce
// by xor shuffles within each row's lanes; a row of R > 32 runs takes a
// whole warp, whose lanes stride over its runs.  Each warp finds its
// segment in the warp prefix sums.  No shared memory, no atomics.
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#define RLE_FILTER_MAX_SEGS 64

constexpr int kThreads = 256;                 // 8 warps per CTA
constexpr unsigned kFull = 0xffffffffu;

// The segment table of one launch, S entries (1 for a single segment, so
// a one-container call carries a small parameter block).
template <int S>
struct FilterSegs {
  int n;
  int warp_start[S + 1];               // prefix sums of the segments' warps
  int nb[S];
  int log2_lanes[S];                   // lanes per row: 1 << this (<= 5)
  int runs[S];
  int flags[S];                        // bit 0: values f32, bit 1: lengths
  long long out_row[S];                // the segment's first output row
  const int32_t* values[S];            // int32 or f32 bits
  const int32_t* lengths[S];
};

// log2 of the lanes per row: next_pow2(R) lanes for R <= 32 (one for
// R <= 1), the whole warp (5) for longer rows, whose lanes stride.
static int log2_lanes(int R) {
  int l = 0;
  while ((1 << l) < R && l < 5) ++l;
  return l;
}

__device__ __forceinline__ float as_f32(int32_t x, bool is_float) {
  return is_float ? __int_as_float(x) : (float)x;
}

template <int S>
__global__ void __launch_bounds__(kThreads)
rle_filter_agg_kernel(const __grid_constant__ FilterSegs<S> segs, float lo,
                      float hi, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int w = (int)((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  // one segment: every index below is known at compile time
  if (w >= segs.warp_start[S == 1 ? 1 : segs.n]) return;   // whole warps
  int s = 0;
  if (S > 1)
    while (segs.warp_start[s + 1] <= w) ++s;   // uniform across the warp
  const int lg = segs.log2_lanes[s];
  const int P = 1 << lg;
  const int row = ((w - segs.warp_start[s]) << (5 - lg)) + (lane >> lg);
  const int r = lane & (P - 1);
  const int R = segs.runs[s];
  const bool vf = segs.flags[s] & 1, lf = segs.flags[s] & 2;
  float cnt = 0.f, sum = 0.f, mx = -INFINITY;
  if (row < segs.nb[s]) {
    const long long at = (long long)row * R;
    const int32_t* rv = segs.values[s] + at;
    const int32_t* rl = segs.lengths[s] + at;
    for (int j = r; j < R; j += P) {
      const float v = as_f32(rv[j], vf);
      const float len = as_f32(rl[j], lf);
      if (v >= lo && v <= hi && len > 0.f) {
        cnt += len;
        sum += __fmul_rn(v, len);
        mx = fmaxf(mx, v);
      }
    }
  }
  for (int off = P >> 1; off > 0; off >>= 1) {
    cnt += __shfl_xor_sync(kFull, cnt, off);
    sum += __shfl_xor_sync(kFull, sum, off);
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
  }
  if (r == 0 && row < segs.nb[s]) {
    float* o = out + (segs.out_row[s] + row) * 3;
    o[0] = cnt;
    o[1] = sum;
    o[2] = mx;
  }
}

template <int S>
static int launch(int n_segs, const void* const* values,
                  const void* const* lengths, const int* flags,
                  const int* nb, const int* runs, float lo, float hi,
                  void* out, cudaStream_t stream) {
  FilterSegs<S> segs;
  segs.n = n_segs;
  segs.warp_start[0] = 0;
  long long rows = 0, warps = 0;
  for (int s = 0; s < n_segs; ++s) {
    if (nb[s] < 0 || runs[s] < 0) return (int)cudaErrorInvalidValue;
    const int lg = log2_lanes(runs[s]);
    segs.values[s] = (const int32_t*)values[s];
    segs.lengths[s] = (const int32_t*)lengths[s];
    segs.nb[s] = nb[s];
    segs.log2_lanes[s] = lg;
    segs.runs[s] = runs[s];
    segs.flags[s] = flags[s];
    segs.out_row[s] = rows;
    rows += nb[s];
    // rows per warp: 32 >> lg
    warps += ((long long)nb[s] + (32 >> lg) - 1) >> (5 - lg);
    if (warps * 32 >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    segs.warp_start[s + 1] = (int)warps;
  }
  if (warps == 0) return (int)cudaGetLastError();
  const long long blocks = (warps * 32 + kThreads - 1) / kThreads;
  rle_filter_agg_kernel<S><<<(unsigned)blocks, kThreads, 0, stream>>>(
      segs, lo, hi, (float*)out);
  return (int)cudaGetLastError();
}

// n_segs segments of nb[s] rows of runs[s] runs each; flags[s] bit 0: the
// values are f32 (else int32), bit 1: the lengths.  out: (sum nb, 3) f32,
// the segments' rows in order.
extern "C" int rle_filter_agg_launch(int n_segs, const void* const* values,
                                     const void* const* lengths,
                                     const int* flags, const int* nb,
                                     const int* runs, float lo, float hi,
                                     void* out, void* stream) {
  if (n_segs < 0 || n_segs > RLE_FILTER_MAX_SEGS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (n_segs == 1)
    return launch<1>(n_segs, values, lengths, flags, nb, runs, lo, hi, out,
                     st);
  return launch<RLE_FILTER_MAX_SEGS>(n_segs, values, lengths, flags, nb,
                                     runs, lo, hi, out, st);
}

// One segment's pointers and shape as scalars: the one-container call,
// without the host arrays of the list form.
extern "C" int rle_filter_agg_launch1(const void* values, const void* lengths,
                                      int flags, int nb, int runs, float lo,
                                      float hi, void* out, void* stream) {
  return launch<1>(1, &values, &lengths, &flags, &nb, &runs, lo, hi, out,
                   (cudaStream_t)stream);
}
