// Bit-unpack: packed little-endian uint32 word streams -> int32 symbols.
//
// Replaces the Pallas kernel src/repro/kernels/bitunpack.py
// (bitunpack_pallas / _kernel / _kernel_base): w-bit symbols (w = 1..32),
// 32-symbol groups of exactly w words, optional per-block base add fused in
// (DELTA_VALUE base, DELTA_RANGE delta_min).
//
// Bound on the H100: bytes.  Each symbol costs ~w/8 bytes read and 4 bytes
// written against a handful of integer ops, far below the card's
// operations-per-byte ridge.  Design: one thread per output symbol, so
// consecutive threads write consecutive int32 (coalesced stores) and read
// the same or neighbouring words (the w words of a group are shared by its
// 32 threads, one warp, and served from L1).  No shared memory: the reads
// already coalesce, and the TPU kernel's static (word, shift) tables become
// two integer multiplies per thread.
//
// The words arrive as int32 bits (PyTorch's uint32 support is partial) and
// are reinterpreted as uint32 here.  The base add wraps in uint32, like the
// reference's int32 lanes.
#include <cstdint>
#include <cuda_runtime.h>

__global__ void bitunpack_kernel(const uint32_t* __restrict__ words,
                                 const int32_t* __restrict__ base,
                                 int32_t* __restrict__ out,
                                 long long n_out, int n_words, int width,
                                 int block_rows) {
  const uint32_t mask = width == 32 ? 0xFFFFFFFFu : ((1u << width) - 1u);
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n_out; i += (long long)gridDim.x * blockDim.x) {
    const long long b = i / block_rows;
    const int j = (int)(i - b * block_rows);
    const int g = j >> 5;
    const int bit = (j & 31) * width;
    const uint32_t* row = words + b * (long long)n_words;
    const int lo = g * width + (bit >> 5);
    const int sh = bit & 31;
    uint32_t v = row[lo] >> sh;
    if (sh + width > 32) v |= row[lo + 1] << (32 - sh);
    v &= mask;
    if (base != nullptr) v += (uint32_t)base[b];
    out[i] = (int32_t)v;
  }
}

extern "C" int bitunpack_launch(const void* words, const void* base,
                                void* out, int n_blocks, int n_words,
                                int width, int block_rows, void* stream) {
  const long long n_out = (long long)n_blocks * block_rows;
  if (n_out == 0) return (int)cudaGetLastError();
  const int threads = 256;
  long long blocks = (n_out + threads - 1) / threads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  bitunpack_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const int32_t*)base, (int32_t*)out, n_out,
      n_words, width, block_rows);
  return (int)cudaGetLastError();
}
