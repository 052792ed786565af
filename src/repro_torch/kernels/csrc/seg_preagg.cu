// Dense GROUP BY under a validity mask: per-key count, and sum / min / max
// per aggregate, over keys clipped into [0, domain).
//
// Replaces the Pallas kernel src/repro/kernels/seg_preagg.py
// (seg_preagg_pallas / _preagg_call / _make_kernel), whose contract is
// operators.groupby_dense: negative keys merge into group 0, counts and int
// sums are int32 and wrap, float sums are f32, min/max start from the
// dtype's sentinels (int32 max/min, +-inf).  The C call writes those
// identities itself into one (1 + n_aggs, domain) buffer of 4-byte words,
// lane 0 the count: the shared-route kernel before its grid-wide barrier,
// else seg_preagg_init_kernel on the same stream.
//
// Bound on the H100: bytes -- the mask once, the keys and values of the
// 32-byte sectors that hold a valid row, and each output written once --
// and, below that, atomics: with one atomic per valid row and aggregate,
// a hot key puts thousands of updates on one address and L2 (or the
// shared-memory bank) serialises them, so both routes fold runs of equal
// keys in registers first.  Two routes, both in this file, chosen by the
// wrapper (seg_preagg.py::seg_preagg_route):
//
// * shared (the table fits in shared memory): a persistent grid sized by
//   occupancy.  Each CTA keeps R replicas of a key-major table
//   [key][lane][replica] in dynamic shared memory (one replica per
//   16 / R warps, adjacent words, so a hot key's updates from different
//   warps land in different banks), walks its rows in 16-row chunks with
//   16-byte loads of keys, values and the valid bytes (a scalar loop takes
//   the unaligned head, the tail, and every row when the pointers disagree
//   on alignment), folds each chunk's runs of equal keys in registers
//   (sorted keys send one update per run, not per row), updates the table
//   with shared-memory atomics, then folds its replicas and flushes only
//   the keys it touched with global atomics.  The grid is launched
//   cooperatively (it is resident at once), so the outputs' identities
//   are written by the same launch and a grid-wide barrier after the row
//   walk orders them before the flush: one launch per call.  Int sums
//   wrap in every step, so the result is exact mod 2^32.
// * global (the table does not fit, e.g. domain 150,000): each lane takes
//   8 consecutive rows (one 32-byte sector of keys or of a value column),
//   so a warp takes 256 (one tile), over a grid-stride loop of tiles.  A
//   lane reads its 8 valid bytes in one load, then its keys and each value
//   column only if one of its rows is valid: a chunk with no valid row
//   reads only its mask, and a tile with none skips the rest.  It folds its
//   runs of equal clipped keys in registers and sends each interior run
//   straight to a global atomic; its first and last runs go into a
//   segmented scan across the warp (__shfl_up_sync, a head flag wherever a
//   lane's run does not continue the previous non-empty lane's last run),
//   so a run of equal keys that crosses lanes costs one atomic per warp
//   and aggregate.  A warp in which no lane's first run continues the lane
//   below's last (random keys, as a rule) skips the scan: each lane sends
//   its runs itself.  Sorted keys (a shared Q4 over the unpruned scan) send
//   about one atomic per distinct key and warp instead of one per row,
//   which L2 serialised on a hot address; random keys fold nothing and
//   send no more atomics than valid rows.  Rows off the aligned vector
//   range (a head, a tail, or every row when the pointers disagree on
//   alignment or n is shorter than the valid bytes' unaligned head) take
//   element loads of the same chunk layout and the same fold.  8-row
//   lanes in CTAs of 2 warps at 48 registers beat 16-row lanes (up to 112
//   registers) and 4-row lanes on random keys, where the fold saves
//   nothing and occupancy hides the loads' latency, and 4-row lanes on
//   sorted ones (PERF.md, the kernel table and its findings).
//
// Float min/max: float_atomics.cuh's ordered-int trick, in shared and in
// global memory alike; ``ordered`` below is the same order in registers
// (-0.0 below +0.0).  Tensor cores have no part here.
#include <climits>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>
#include <mutex>

#include "float_atomics.cuh"

#define SEG_MAX_AGGS 32

namespace cg = cooperative_groups;

enum AggKind { AGG_SUM = 0, AGG_MIN = 1, AGG_MAX = 2 };

constexpr int kThreads = 512;           // shared route: 16 warps per CTA
constexpr int kSmemMax = 232448;        // H100: 227 KB per block (opt-in)

struct AggSpecs {
  int n;
  int kind[SEG_MAX_AGGS];
  int is_float[SEG_MAX_AGGS];
  const void* vals[SEG_MAX_AGGS];
};

// A lane's identity as its 4-byte pattern: 0 for counts and sums, the
// dtype's sentinel for min and max.
__device__ __forceinline__ int32_t identity_bits(int kind, int is_float) {
  if (kind == AGG_SUM) return 0;
  if (is_float) return kind == AGG_MIN ? 0x7f800000 : (int32_t)0xff800000u;
  return kind == AGG_MIN ? INT_MAX : INT_MIN;
}

__device__ __forceinline__ int32_t lane_identity(const AggSpecs& specs,
                                                 int lane) {
  return lane == 0 ? 0 : identity_bits(specs.kind[lane - 1],
                                       specs.is_float[lane - 1]);
}

// blockIdx.y: the lane; its row of ``out`` takes the lane's identity.
__global__ void seg_preagg_init_kernel(int domain,
                                       const __grid_constant__ AggSpecs specs,
                                       int32_t* __restrict__ out) {
  const int32_t v = lane_identity(specs, blockIdx.y);
  int32_t* row = out + (long long)blockIdx.y * domain;
  for (int k = blockIdx.x * blockDim.x + threadIdx.x; k < domain;
       k += gridDim.x * blockDim.x)
    row[k] = v;
}

// ------------------------------------------------------------ shared route

// Float order on the bits, -0.0 below +0.0 (float_atomics.cuh's order).
__device__ __forceinline__ int32_t ordered(int32_t bits) {
  return bits >= 0 ? bits : bits ^ 0x7fffffff;
}

template <int KIND, bool FLOAT>
__device__ __forceinline__ int32_t combine(int32_t a, int32_t b) {
  if (KIND == AGG_SUM)
    return FLOAT ? __float_as_int(__int_as_float(a) + __int_as_float(b))
                 : (int32_t)((uint32_t)a + (uint32_t)b);
  if (KIND == AGG_MIN)
    return FLOAT ? (ordered(b) < ordered(a) ? b : a) : min(a, b);
  return FLOAT ? (ordered(b) > ordered(a) ? b : a) : max(a, b);
}

// One atomic update of ``e``, in shared or in device memory.
template <int KIND, bool FLOAT>
__device__ __forceinline__ void update(int32_t* e, int32_t v) {
  if (KIND == AGG_SUM) {
    if (FLOAT) atomicAdd((float*)e, __int_as_float(v));
    else atomicAdd(e, v);
  } else if (KIND == AGG_MIN) {
    if (FLOAT) atomic_min_f32((float*)e, __int_as_float(v));
    else atomicMin(e, v);
  } else {
    if (FLOAT) atomic_max_f32((float*)e, __int_as_float(v));
    else atomicMax(e, v);
  }
}

// The same, with the kind known only at run time (uniform across a warp).
__device__ __forceinline__ void update_dyn(int kind, int is_float,
                                           int32_t* e, int32_t v) {
  if (is_float) {
    if (kind == AGG_SUM) update<AGG_SUM, true>(e, v);
    else if (kind == AGG_MIN) update<AGG_MIN, true>(e, v);
    else update<AGG_MAX, true>(e, v);
  } else {
    if (kind == AGG_SUM) update<AGG_SUM, false>(e, v);
    else if (kind == AGG_MIN) update<AGG_MIN, false>(e, v);
    else update<AGG_MAX, false>(e, v);
  }
}

// One lane of a 16-row chunk: runs of equal keys among the valid rows
// (mask ``m``) fold in registers, and each run sends one shared atomic to
// its key's entry, ``base + key * stride``.  ``vals`` null: the count.
template <int KIND, bool FLOAT>
__device__ __forceinline__ void fold16(const int (&k)[16], unsigned m,
                                       const int32_t* __restrict__ vals,
                                       long long row0, int32_t* base,
                                       int stride) {
  int32_t v[16];
  if (vals) {
    const int4* p = reinterpret_cast<const int4*>(vals + row0);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int4 t = __ldg(p + q);
      v[4 * q] = t.x; v[4 * q + 1] = t.y; v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) v[i] = 1;
  }
  int cur = -1;
  int32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    if (!((m >> i) & 1u)) continue;
    if (k[i] != cur) {
      if (cur >= 0) update<KIND, FLOAT>(base + cur * stride, acc);
      cur = k[i];
      acc = v[i];
    } else {
      acc = combine<KIND, FLOAT>(acc, v[i]);
    }
  }
  if (cur >= 0) update<KIND, FLOAT>(base + cur * stride, acc);
}

__device__ __forceinline__ int32_t combine_dyn(int kind, int is_float,
                                               int32_t a, int32_t b) {
  if (is_float) {
    if (kind == AGG_SUM) return combine<AGG_SUM, true>(a, b);
    if (kind == AGG_MIN) return combine<AGG_MIN, true>(a, b);
    return combine<AGG_MAX, true>(a, b);
  }
  if (kind == AGG_SUM) return combine<AGG_SUM, false>(a, b);
  if (kind == AGG_MIN) return combine<AGG_MIN, false>(a, b);
  return combine<AGG_MAX, false>(a, b);
}

// The R replicas of one (key, lane) entry folded into one value.
__device__ __forceinline__ int32_t fold_replicas(const int32_t* e, int R,
                                                 int kind, int is_float) {
  int32_t acc = e[0];
  for (int r = 1; r < R; ++r) acc = combine_dyn(kind, is_float, acc, e[r]);
  return acc;
}

// Rows [vec_begin, vec_end) (a multiple of 16, every pointer 16-byte
// aligned at vec_begin) go in 16-row chunks; the rest one by one.
__global__ void __launch_bounds__(kThreads, 2)
seg_preagg_shared_kernel(const int32_t* __restrict__ keys,
                         const uint8_t* __restrict__ valid, long long n,
                         long long vec_begin, long long vec_end, int domain,
                         int replicas,
                         const __grid_constant__ AggSpecs specs,
                         int32_t* __restrict__ out) {
  extern __shared__ int32_t table[];           // [key][lane][replica]
  const int L = 1 + specs.n, R = replicas;
  const int stride = L * R;                    // words per key
  for (int j = threadIdx.x; j < domain * stride; j += blockDim.x)
    table[j] = lane_identity(specs, (j / R) % L);
  const long long gtid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long step = (long long)gridDim.x * blockDim.x;
  // the outputs' identities, written by the whole grid; the grid-wide
  // barrier before the flush orders them before every global atomic
  for (long long j = gtid; j < (long long)L * domain; j += step)
    out[j] = lane_identity(specs, (int)(j / domain));
  __syncthreads();
  const int rep = (threadIdx.x >> 5) % R;

  const long long n_chunks = (vec_end - vec_begin) >> 4;
  for (long long c = gtid; c < n_chunks; c += step) {
    const long long row0 = vec_begin + (c << 4);
    const uint4 vb = __ldg(reinterpret_cast<const uint4*>(valid + row0));
    const unsigned w[4] = {vb.x, vb.y, vb.z, vb.w};
    unsigned m = 0;
#pragma unroll
    for (int i = 0; i < 16; ++i)
      m |= ((w[i >> 2] >> (8 * (i & 3))) & 0xffu) ? (1u << i) : 0u;
    if (!m) continue;
    int k[16];
    const int4* kp = reinterpret_cast<const int4*>(keys + row0);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int4 t = __ldg(kp + q);
      k[4 * q] = t.x; k[4 * q + 1] = t.y; k[4 * q + 2] = t.z;
      k[4 * q + 3] = t.w;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i)
      k[i] = k[i] < 0 ? 0 : (k[i] >= domain ? domain - 1 : k[i]);
    fold16<AGG_SUM, false>(k, m, nullptr, row0, table + rep, stride);
    for (int a = 0; a < specs.n; ++a) {
      const int32_t* vals = (const int32_t*)specs.vals[a];
      int32_t* base = table + (1 + a) * R + rep;
      const int kind = specs.kind[a];
      if (specs.is_float[a]) {
        if (kind == AGG_SUM)
          fold16<AGG_SUM, true>(k, m, vals, row0, base, stride);
        else if (kind == AGG_MIN)
          fold16<AGG_MIN, true>(k, m, vals, row0, base, stride);
        else
          fold16<AGG_MAX, true>(k, m, vals, row0, base, stride);
      } else {
        if (kind == AGG_SUM)
          fold16<AGG_SUM, false>(k, m, vals, row0, base, stride);
        else if (kind == AGG_MIN)
          fold16<AGG_MIN, false>(k, m, vals, row0, base, stride);
        else
          fold16<AGG_MAX, false>(k, m, vals, row0, base, stride);
      }
    }
  }

  const long long n_scalar = vec_begin + (n - vec_end);
  for (long long i = gtid; i < n_scalar; i += step) {
    const long long row = i < vec_begin ? i : vec_end + (i - vec_begin);
    if (!valid[row]) continue;
    int k = keys[row];
    k = k < 0 ? 0 : (k >= domain ? domain - 1 : k);
    int32_t* e = table + k * stride + rep;
    atomicAdd(e, 1);
    for (int a = 0; a < specs.n; ++a)
      update_dyn(specs.kind[a], specs.is_float[a], e + (1 + a) * R,
                 ((const int32_t*)specs.vals[a])[row]);
  }
  __syncthreads();
  cg::this_grid().sync();

  // fold the replicas; flush the keys this CTA touched (count > 0: a CTA
  // holds fewer than 2^31 rows, so its count of a key never wraps to 0)
  for (int key = threadIdx.x; key < domain; key += blockDim.x) {
    const int32_t* e = table + key * stride;
    const int32_t cnt = fold_replicas(e, R, AGG_SUM, 0);
    if (cnt == 0) continue;
    atomicAdd(out + key, cnt);
    for (int a = 0; a < specs.n; ++a) {
      const int kind = specs.kind[a], isf = specs.is_float[a];
      update_dyn(kind, isf, out + (long long)(1 + a) * domain + key,
                 fold_replicas(e + (1 + a) * R, R, kind, isf));
    }
  }
}

// ------------------------------------------------------------ global route

constexpr int kGlobalThreads = 64;      // 2 warps per CTA
constexpr int kGlobalBlocksPerSm = 20;  // 40 warps an SM: 48 registers
constexpr int kLaneRows = 8;            // rows a lane folds (a 32-byte
                                        // sector of int32); a warp 256
constexpr unsigned kFull = 0xffffffffu;

// Four valid bytes as four mask bits: each nonzero byte to 1, then one
// multiply gathers the four into the top byte, byte 0 lowest.
__device__ __forceinline__ unsigned nibble(unsigned w) {
  return (__vsetne4(w, 0u) * 0x01020408u) >> 24;
}

// The 8 words of a lane's chunk at rows [r0, r0 + 8), read only where the
// mask ``m`` has a valid row: the whole sector in two 16-byte loads on
// the vector range, else the valid rows one by one.  Unread words are 0.
__device__ __forceinline__ void load_chunk(const int32_t* __restrict__ p,
                                           long long r0, unsigned m,
                                           bool vec,
                                           int32_t (&x)[kLaneRows]) {
#pragma unroll
  for (int i = 0; i < kLaneRows; ++i) x[i] = 0;
  if (vec) {
    if (!m) return;                     // the sector holds no valid row
    const int4* q = reinterpret_cast<const int4*>(p + r0);
    const int4 a = __ldg(q), b = __ldg(q + 1);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < kLaneRows; ++i)
      if ((m >> i) & 1u) x[i] = __ldg(p + r0 + i);
  }
}

// What one tile's run structure tells each lane, shared by every
// aggregate: its first and last run's keys, its number of runs, whether
// its first run continues the previous non-empty lane's last run
// (``joins``), whether the run its carry ends in stops at this lane
// (``emit_tail``: no later non-empty lane continues it), and the steps of
// the segmented scan at which it combines with the lane 2^s below.
struct LaneRuns {
  int kf, kl, nruns;
  unsigned steps;
  bool joins, emit_tail;
};

// One aggregate of a tile: the lane folds its runs of the values ``v``
// (``count``: 1 a row) and sends them to ``out`` (the aggregate's
// (domain,) row of words).  MERGE false: no lane's first run continues the
// lane below's last, so every run goes straight to an atomic.  MERGE true:
// interior runs go at once, and the warp merges first and last runs
// across lanes.  A lane's carry is its last run (its only run, if it has
// one; the identity, if none); the scan makes it the whole run of equal
// keys that ends at this lane.  A lane with two or more runs sends its
// first run, joined to the carry of the lane below where the keys agree;
// a lane whose carry's run stops here sends the carry.
template <int KIND, bool FLOAT, bool MERGE>
__device__ __forceinline__ void fold_tile(const int (&k)[kLaneRows],
                                          unsigned m, unsigned starts,
                                          const int32_t (&v)[kLaneRows],
                                          bool count, const LaneRuns& r,
                                          int32_t* __restrict__ out) {
  int32_t acc = identity_bits(KIND, FLOAT), first = acc;
  int cur = 0, seen = 0;
#pragma unroll
  for (int i = 0; i < kLaneRows; ++i) {
    if (!((m >> i) & 1u)) continue;
    const int32_t x = count ? 1 : v[i];
    if ((starts >> i) & 1u) {
      if (!MERGE && seen) update<KIND, FLOAT>(out + cur, acc);
      else if (seen == 1) first = acc;
      else if (seen > 1) update<KIND, FLOAT>(out + cur, acc);   // interior
      ++seen;
      cur = k[i];
      acc = x;
    } else {
      acc = combine<KIND, FLOAT>(acc, x);
    }
  }
  if (!MERGE) {
    if (seen) update<KIND, FLOAT>(out + cur, acc);
    return;
  }
  int32_t carry = acc;
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const int32_t below = __shfl_up_sync(kFull, carry, 1 << s);
    if ((r.steps >> s) & 1u) carry = combine<KIND, FLOAT>(below, carry);
  }
  const int32_t before = __shfl_up_sync(kFull, carry, 1);
  if (r.nruns > 1)
    update<KIND, FLOAT>(out + r.kf,
                        r.joins ? combine<KIND, FLOAT>(before, first)
                                : first);
  if (r.emit_tail) update<KIND, FLOAT>(out + r.kl, carry);
}

template <bool MERGE>
__device__ __forceinline__ void fold_dyn(int kind, int is_float,
                                         const int (&k)[kLaneRows],
                                         unsigned m, unsigned starts,
                                         const int32_t (&v)[kLaneRows],
                                         const LaneRuns& r, int32_t* out) {
  if (is_float) {
    if (kind == AGG_SUM)
      fold_tile<AGG_SUM, true, MERGE>(k, m, starts, v, false, r, out);
    else if (kind == AGG_MIN)
      fold_tile<AGG_MIN, true, MERGE>(k, m, starts, v, false, r, out);
    else
      fold_tile<AGG_MAX, true, MERGE>(k, m, starts, v, false, r, out);
  } else {
    if (kind == AGG_SUM)
      fold_tile<AGG_SUM, false, MERGE>(k, m, starts, v, false, r, out);
    else if (kind == AGG_MIN)
      fold_tile<AGG_MIN, false, MERGE>(k, m, starts, v, false, r, out);
    else
      fold_tile<AGG_MAX, false, MERGE>(k, m, starts, v, false, r, out);
  }
}

// Every aggregate of a tile: the count, then each value column, loaded
// only where the lane has a valid row.
template <bool MERGE>
__device__ __forceinline__ void fold_aggs(long long r0, bool vec,
                                          const int (&k)[kLaneRows],
                                          unsigned m, unsigned starts,
                                          const LaneRuns& r, int domain,
                                          const AggSpecs& specs,
                                          int32_t* __restrict__ out) {
  int32_t v[kLaneRows];
  fold_tile<AGG_SUM, false, MERGE>(k, m, starts, v, true, r, out);
  for (int a = 0; a < specs.n; ++a) {
    load_chunk((const int32_t*)specs.vals[a], r0, m, vec, v);
    fold_dyn<MERGE>(specs.kind[a], specs.is_float[a], k, m, starts, v, r,
                    out + (long long)(1 + a) * domain);
  }
}

// Chunk c is rows [base + 8 c, base + 8 c + 8); ``aligned``: the chunks
// inside [0, n) take vector loads (base is then the row ``head`` at which
// the valid bytes reach a 16-byte boundary and every pointer is aligned,
// less the whole chunks that fit before it, less one more chunk if a part
// of one does).  Tile t is chunks [32 t, 32 t + 32), one per lane, walked
// grid-stride by the warps.
__global__ void __launch_bounds__(kGlobalThreads, kGlobalBlocksPerSm)
seg_preagg_global_kernel(const int32_t* __restrict__ keys,
                         const uint8_t* __restrict__ valid, long long n,
                         long long base, int aligned, int domain,
                         const __grid_constant__ AggSpecs specs,
                         int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long n_chunks = (n - base + kLaneRows - 1) / kLaneRows;
  const long long n_tiles = (n_chunks + 31) >> 5;
  const long long step = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long t = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
       t < n_tiles; t += step) {
    const long long r0 = base + (t * 32 + lane) * kLaneRows;
    const bool vec = aligned && r0 >= 0 && r0 + kLaneRows <= n;
    unsigned m = 0;
    if (vec) {
      const uint2 b = __ldg(reinterpret_cast<const uint2*>(valid + r0));
      m = nibble(b.x) | nibble(b.y) << 4;
    } else {
#pragma unroll
      for (int i = 0; i < kLaneRows; ++i) {
        const long long row = r0 + i;
        if (row >= 0 && row < n && valid[row]) m |= 1u << i;
      }
    }
    const unsigned nonempty = __ballot_sync(kFull, m != 0);
    if (!nonempty) continue;                    // the whole tile invalid

    int k[kLaneRows];
    load_chunk(keys, r0, m, vec, k);
    LaneRuns r;
    r.kf = 0;
    unsigned starts = 0;
    int prev = 0;
#pragma unroll
    for (int i = 0; i < kLaneRows; ++i) {
      if (!((m >> i) & 1u)) continue;
      k[i] = k[i] < 0 ? 0 : (k[i] >= domain ? domain - 1 : k[i]);
      if (!starts) r.kf = k[i];
      if (!starts || k[i] != prev) starts |= 1u << i;
      prev = k[i];
    }
    r.kl = prev;
    r.nruns = __popc(starts);
    // the nearest non-empty lanes below and above this one
    const unsigned below = nonempty & ((1u << lane) - 1u);
    const int kl_below = __shfl_sync(kFull, r.kl,
                                     below ? 31 - __clz(below) : lane);
    r.joins = m && below && r.kf == kl_below;
    // no run crosses a lane edge (random keys, as a rule): no merge
    if (!__any_sync(kFull, r.joins)) {
      fold_aggs<false>(r0, vec, k, m, starts, r, domain, specs, out);
      continue;
    }
    const unsigned above = nonempty & ~((2u << lane) - 1u);
    const int kf_above = __shfl_sync(kFull, r.kf,
                                     above ? __ffs(above) - 1 : lane);
    r.emit_tail = m && !(above && kf_above == r.kl);
    // a lane heads a segment of the scan unless it is empty (it passes
    // the carry below on) or its one run continues the lane below's
    unsigned head = m && !(r.nruns == 1 && r.joins);
    r.steps = 0;
#pragma unroll
    for (int s = 0; s < 5; ++s) {
      const unsigned h = __shfl_up_sync(kFull, head, 1 << s);
      if (lane >= (1 << s)) {
        if (!head) r.steps |= 1u << s;
        head |= h;
      }
    }
    fold_aggs<true>(r0, vec, k, m, starts, r, domain, specs, out);
  }
}

// The shared route's largest resident grid for a table of ``smem`` bytes
// on the current device: occupancy times SMs, with the opt-in above 48 KB
// made first.  Cached per (device, smem) under a lock, as the wrappers may
// call from several threads at once.
static cudaError_t shared_grid_cap(size_t smem, int* cap) {
  struct Entry { int dev; size_t smem; int cap; };
  static std::mutex mu;
  static Entry cache[16];
  static int used = 0, next = 0;
  static unsigned long long opted = 0;         // one bit per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i)
    if (cache[i].dev == dev && cache[i].smem == smem) {
      *cap = cache[i].cap;
      return cudaSuccess;
    }
  const bool known = dev < 64 && ((opted >> dev) & 1);
  if (smem > 48 * 1024 && !known) {
    e = cudaFuncSetAttribute(seg_preagg_shared_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemMax);
    if (e != cudaSuccess) return e;
    if (dev < 64) opted |= 1ULL << dev;
  }
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, seg_preagg_shared_kernel, kThreads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *cap = per_sm * sms;
  cache[next] = Entry{dev, smem, *cap};
  next = (next + 1) % 16;
  if (used < 16) ++used;
  return cudaSuccess;
}

// out: (1 + n_aggs, domain) 4-byte words; row 0 the int32 count, row 1 + a
// aggregate a (int32 or f32 as is_float[a] says).  replicas: 0 takes the
// global route, R >= 1 the shared route with R table replicas per CTA.
extern "C" int seg_preagg_launch(const void* keys, const void* valid,
                                 long long n, int domain, int n_aggs,
                                 const int* kinds, const int* is_float,
                                 const void* const* vals, void* out,
                                 int replicas, void* stream) {
  if (n_aggs < 0 || n_aggs > SEG_MAX_AGGS || domain < 1 || replicas < 0)
    return (int)cudaErrorInvalidValue;
  AggSpecs specs;
  specs.n = n_aggs;
  for (int a = 0; a < n_aggs; ++a) {
    specs.kind[a] = kinds[a];
    specs.is_float[a] = is_float[a];
    specs.vals[a] = vals[a];
  }
  cudaStream_t st = (cudaStream_t)stream;
  int32_t* o = (int32_t*)out;
  const long long words = (long long)(1 + n_aggs) * domain;
  cudaError_t e;
  if (replicas == 0 || n == 0) {
    const dim3 init_grid((unsigned)((domain + 255) / 256 < 64
                                    ? (domain + 255) / 256 : 64),
                         (unsigned)(1 + n_aggs));
    seg_preagg_init_kernel<<<init_grid, 256, 0, st>>>(domain, specs, o);
    e = cudaGetLastError();
    if (e != cudaSuccess || n == 0) return (int)e;
  }

  // the vector range: the head that aligns the valid bytes to 16, if the
  // keys and every value column are aligned at the same row
  const long long head16 = (long long)((16 - ((uintptr_t)valid & 15)) & 15);
  const long long head = head16 > n ? n : head16;
  bool aligned = (((uintptr_t)keys + 4 * head) & 15) == 0;
  for (int a = 0; a < n_aggs; ++a)
    aligned = aligned && (((uintptr_t)vals[a] + 4 * head) & 15) == 0;

  if (replicas == 0) {
    // a lane's vector load of 8 valid bytes needs them 8-byte aligned,
    // which a head clamped to n does not give: such a call (n < 16) takes
    // element loads throughout
    const bool vec = aligned && head16 <= n;
    const long long base =
        vec && head % kLaneRows ? head % kLaneRows - kLaneRows : 0;
    const long long tiles = ((n - base + kLaneRows - 1) / kLaneRows + 31) / 32;
    long long blocks = (tiles * 32 + kGlobalThreads - 1) / kGlobalThreads;
    if (blocks > 132LL * 64) blocks = 132LL * 64;   // grid-stride beyond
    seg_preagg_global_kernel<<<(unsigned)blocks, kGlobalThreads, 0, st>>>(
        (const int32_t*)keys, (const uint8_t*)valid, n, base, (int)vec,
        domain, specs, o);
    return (int)cudaGetLastError();
  }

  const size_t smem = (size_t)words * replicas * 4;
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  int grid_cap = 0;
  if ((e = shared_grid_cap(smem, &grid_cap)) != cudaSuccess) return (int)e;
  const long long vec_begin = aligned ? head : n;
  const long long vec_end = aligned ? head + ((n - head) & ~15LL) : n;
  const long long units = ((vec_end - vec_begin) >> 4) +
                          (vec_begin + (n - vec_end) + 15) / 16;
  long long blocks = (units + kThreads - 1) / kThreads;
  if (blocks > grid_cap) blocks = grid_cap;
  if (blocks < 1) blocks = 1;
  if (n / blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  // cooperative: the whole grid is resident at once (it is sized by
  // occupancy), as its grid-wide barrier needs
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, seg_preagg_shared_kernel,
                         (const int32_t*)keys, (const uint8_t*)valid, n,
                         vec_begin, vec_end, domain, replicas, specs, o);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
