// Bit-unpack: packed little-endian uint32 word streams -> int32 symbols.
//
// Replaces the Pallas kernel src/repro/kernels/bitunpack.py
// (bitunpack_pallas / _kernel / _kernel_base): w-bit symbols (w = 1..32),
// 32-symbol groups of exactly w words, optional per-block base add fused in
// (DELTA_VALUE base, DELTA_RANGE delta_min).
//
// Bound on the H100: bytes.  Each symbol costs w/8 bytes read and 4 bytes
// written against a handful of integer ops, far below the card's
// operations-per-byte ridge.  At one container (123 blocks of 4096 rows)
// the launch and the tail set the time, so one launch walks a SEGMENT
// TABLE: one entry per container of a scan (words, row stride, width,
// base, kept-block indices, block count, first output block), the widths
// free to differ per entry.  The compressed scan's mask program unpacks a
// predicate column over the kept blocks of every container in one launch,
// reading the kept indices in place (no words[kept] copy); the decoded
// path's per-container decode is a one-segment launch whose entry rides
// in the kernel's arguments (no table upload).
//
// Design: one CTA per (output block, tile of TILE symbols) -- block from
// blockIdx.x, tile from blockIdx.y, so no 64-bit divide.  The CTA finds its
// segment by a binary search of the table's first-output-block column,
// stages the tile's 32 * w words in shared memory (16-byte loads where the
// tile's words are 16-byte aligned, else 4-byte ones), then each thread
// unpacks 4 consecutive symbols and writes them with one 16-byte store
// (4-byte stores where the output is not 16-byte aligned: block_rows not a
// multiple of 4, or the ragged end of a block).
//
// The words arrive as int32 bits (PyTorch's uint32 support is partial) and
// are reinterpreted as uint32 here.  The base add wraps in uint32, like the
// reference's int32 lanes.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 1024;          // symbols per CTA: 32 groups
constexpr int THREADS = TILE / 4;   // 4 symbols a thread
constexpr int SEG_FIELDS = 8;       // int64 fields per table entry

// One table entry, field for field as kernels/bitunpack.py packs it.
struct Seg {
  long long words;       // const uint32_t*: block 0's first word
  long long row_stride;  // words from one block to the next
  long long base;        // const int32_t* per block, or 0
  long long kept;        // index of the entry's kept-block list in the
                         // table (int64 elements), or -1: blocks 0..n-1
  long long n_blocks;    // output blocks of this entry
  long long out_block;   // first output block of this entry
  long long width;       // bits per symbol, 1..32
  long long unused;
};

__device__ __forceinline__ Seg load_seg(const long long* t) {
  Seg s;
  s.words = t[0]; s.row_stride = t[1]; s.base = t[2]; s.kept = t[3];
  s.n_blocks = t[4]; s.out_block = t[5]; s.width = t[6]; s.unused = 0;
  return s;
}

__global__ void __launch_bounds__(THREADS)
bitunpack_kernel(const long long* __restrict__ table, int n_segs, Seg one,
                 int32_t* __restrict__ out, int block_rows) {
  __shared__ __align__(16) uint32_t sw[TILE / 32 * 32];  // <= 32 words a group
  const long long g = blockIdx.x;                  // output block
  Seg s = one;
  if (table != nullptr) {
    // the last entry whose first output block is <= g (empty entries
    // share their successor's first block and are never the last such)
    int lo = 0, hi = n_segs - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (table[mid * SEG_FIELDS + 5] <= g) lo = mid; else hi = mid - 1;
    }
    s = load_seg(table + lo * SEG_FIELDS);
  }
  const long long k = g - s.out_block;
  const long long b = s.kept < 0 ? k : table[s.kept + k];
  const int w = (int)s.width;
  const int n_groups = (block_rows + 31) >> 5;
  const int g0 = blockIdx.y * (TILE / 32);         // first group of the tile
  const int ng = min(TILE / 32, n_groups - g0);
  const int nw = ng * w;                           // words of the tile

  const uint32_t* src = reinterpret_cast<const uint32_t*>(s.words) +
                        b * s.row_stride + (long long)g0 * w;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int nv = nw >> 2;
    for (int i = threadIdx.x; i < nv; i += THREADS)
      reinterpret_cast<uint4*>(sw)[i] = reinterpret_cast<const uint4*>(src)[i];
    for (int i = (nv << 2) + threadIdx.x; i < nw; i += THREADS) sw[i] = src[i];
  } else {
    for (int i = threadIdx.x; i < nw; i += THREADS) sw[i] = src[i];
  }
  __syncthreads();

  const int first = g0 * 32;                       // tile's first symbol
  const int n_sym = min(ng * 32, block_rows - first);
  const int j0 = threadIdx.x * 4;
  if (j0 >= n_sym) return;
  const uint32_t mask = w == 32 ? 0xFFFFFFFFu : ((1u << w) - 1u);
  const uint32_t add =
      s.base != 0 ? (uint32_t)reinterpret_cast<const int32_t*>(s.base)[b] : 0u;
  uint32_t v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int j = j0 + q;
    const int bit = (j & 31) * w;
    const int wi = (j >> 5) * w + (bit >> 5);
    const int sh = bit & 31;
    uint32_t x = sw[wi] >> sh;
    if (sh + w > 32) x |= sw[wi + 1] << (32 - sh);
    v[q] = (x & mask) + add;
  }
  int32_t* dst = out + g * (long long)block_rows + first + j0;
  if (j0 + 4 <= n_sym && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    *reinterpret_cast<int4*>(dst) =
        make_int4((int)v[0], (int)v[1], (int)v[2], (int)v[3]);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (j0 + q < n_sym) dst[q] = (int32_t)v[q];
  }
}

int launch(const long long* table, int n_segs, const Seg& one, void* out,
           long long n_out_blocks, int block_rows, void* stream) {
  if (n_out_blocks == 0 || block_rows == 0) return (int)cudaGetLastError();
  if (n_out_blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const int n_groups = (block_rows + 31) >> 5;
  const dim3 grid((unsigned)n_out_blocks,
                  (unsigned)((n_groups + TILE / 32 - 1) / (TILE / 32)));
  bitunpack_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      table, n_segs, one, (int32_t*)out, block_rows);
  return (int)cudaGetLastError();
}

}  // namespace

// One container: words (n_blocks rows of row_stride words), optional base.
extern "C" int bitunpack_launch(const void* words, const void* base,
                                void* out, int n_blocks, long long row_stride,
                                int width, int block_rows, void* stream) {
  Seg one;
  one.words = (long long)words; one.row_stride = row_stride;
  one.base = (long long)base; one.kept = -1; one.n_blocks = n_blocks;
  one.out_block = 0; one.width = width; one.unused = 0;
  return launch(nullptr, 1, one, out, n_blocks, block_rows, stream);
}

// A segment table on the device (n_segs entries of SEG_FIELDS int64, then
// the kept-block lists), output (n_out_blocks, block_rows) int32.
extern "C" int bitunpack_segments_launch(const void* table, int n_segs,
                                         long long n_out_blocks, void* out,
                                         int block_rows, void* stream) {
  Seg none = {};
  return launch((const long long*)table, n_segs, none, out, n_out_blocks,
                block_rows, stream);
}
