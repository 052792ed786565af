// DELTA_RANGE block decode: a prefix sum per block row, in f32.
//
// Replaces the Pallas kernel src/repro/kernels/delta_decode.py
// (delta_decode / _kernel): out[b, i] = first[b] + cumsum(d[b])[i] - d[b, 0],
// i.e. first[b] + d[b, 1] + ... + d[b, i] (d[b, 0] drops out), with first
// and the deltas cast to f32 (they arrive as int32 or f32, one
// instantiation per pair).  The reference's formula is kept as written, so
// integer-valued deltas whose prefix sums stay below 2^24 decode bit for
// bit; float deltas differ only by summation order.
//
// Bound on the H100: bytes -- one read of the deltas and first, one f32
// write.  Design: one CTA per block row.  The TPU kernel ran jnp.cumsum
// over the row's 128-lane strip in VMEM; here the row is walked in tiles of
// blockDim elements: each warp scans its 32 values with __shfl_up_sync,
// warp 0 scans the warp totals held in shared memory, and a running carry
// joins one tile to the next.  Loads and stores are coalesced and nothing
// but the 32 warp totals touches shared memory.
#include <cstdint>
#include <cuda_runtime.h>

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

template <typename F, typename D>
__global__ void delta_decode_kernel(const F* __restrict__ first,
                                    const D* __restrict__ deltas,
                                    int n_cols, float* __restrict__ out) {
  __shared__ float warp_sums[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row = blockIdx.x;
  const D* d = deltas + row * n_cols;
  float* o = out + row * n_cols;
  const float f = (float)first[row];
  const float d0 = (float)d[0];
  float carry = 0.f;                       // sum of the earlier tiles
  for (int base = 0; base < n_cols; base += kThreads) {
    const int i = base + threadIdx.x;
    float x = i < n_cols ? (float)d[i] : 0.f;
    for (int off = 1; off < 32; off <<= 1) {      // inclusive warp scan
      const float y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {                              // scan the warp totals
      float w = warp_sums[lane];
      for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, w, off);
        if (lane >= off) w += y;
      }
      warp_sums[lane] = w;
    }
    __syncthreads();
    const float prefix = carry + (warp > 0 ? warp_sums[warp - 1] : 0.f) + x;
    if (i < n_cols) o[i] = f + prefix - d0;
    carry += warp_sums[kWarps - 1];
    __syncthreads();                    // warp_sums is rewritten next tile
  }
}

template <typename F, typename D>
static void launch(const void* first, const void* deltas, int n_blocks,
                   int n_cols, void* out, cudaStream_t stream) {
  delta_decode_kernel<F, D><<<n_blocks, kThreads, 0, stream>>>(
      (const F*)first, (const D*)deltas, n_cols, (float*)out);
}

// first_float / deltas_float: 1 for f32, 0 for int32.
extern "C" int delta_decode_launch(const void* first, const void* deltas,
                                   int first_float, int deltas_float,
                                   int n_blocks, int n_cols, void* out,
                                   void* stream) {
  if (n_blocks == 0 || n_cols == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (first_float && deltas_float)
    launch<float, float>(first, deltas, n_blocks, n_cols, out, s);
  else if (first_float)
    launch<float, int32_t>(first, deltas, n_blocks, n_cols, out, s);
  else if (deltas_float)
    launch<int32_t, float>(first, deltas, n_blocks, n_cols, out, s);
  else
    launch<int32_t, int32_t>(first, deltas, n_blocks, n_cols, out, s);
  return (int)cudaGetLastError();
}
