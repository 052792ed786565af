// Blocked attention with an online softmax (flash attention), for the LM's
// prefill: out = softmax(q k^T / sqrt(d), causal top-left mask) v, in f32,
// written in q's type.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py
// (flash_attention / _kernel), which the reference batches over batch and
// heads with vmap in kernels/ops.py; it computes the contract of
// ref.flash_attention_ref: f32 scores divided by sqrt(d), masked keys at
// -1e30, softmax and P.V to f32 accuracy, one cast at the end.
//
// Two kernels, chosen by dtype (nothing is tried and replaced):
//
// * bf16, the LM's path: flash_attention_kernel_sm90, on Hopper's tensor
//   cores (wgmma), fed by TMA through a ring of mbarrier-guarded stages.
// * f32: flash_attention_kernel, scalar f32 FMAs.  On tensor cores f32
//   would run as TF32 (10-bit mantissas), which breaks the f32 contract.
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s), for qwen3-4b's
// prefill (32 q / 8 kv heads of 128, causal): at 4 x 512, 42 MB (k and v
// unexpanded) take 0.0125 ms, more than 8.6e9 flops at the tensor rate,
// so it is bound by bytes; at 1 x 4096, 1.37e11 flops take 0.139 ms (or
// 0.208 ms counting the second P.V product of the split below), bound by
// operations.  The design keeps both products on the tensor cores and the
// loads off the threads: each K/V tile is read from memory once per 128
// query rows and each kv head once for its query heads (grouped-query
// attention through the maps), and while one consumer warpgroup runs its
// softmax the other's products can use the tensor cores.
//
// bf16 design (flash_attention_kernel_sm90<DP, kLse>, DP = the head dim
// padded to 64 or 128):
// * CTA: 384 threads.  Warpgroup 0 is the producer: one thread issues
//   every TMA load, and the warpgroup gives its registers up (setmaxnreg
//   24).  Warpgroups 1 and 2 are consumers of 64 query rows each (240
//   registers), so 128 rows of one (batch, head) share each K/V tile.
// * Tiles of kBK = 128 keys, kStages = 2 K/V stages in flight (full and
//   empty mbarriers per stage); Q (128 rows) is loaded once.  At DP = 128
//   that is 32 KB of Q and 128 KB of K/V in dynamic shared memory.
// * Shared memory holds each 64-column slab of a row as 128 bytes in the
//   128-byte swizzle that TMA writes and wgmma reads, so a d = 128 row is
//   two boxes; d = 96 is loaded as d = 128, TMA zero-filling columns
//   96-127 (a zero column adds nothing to q.k, and output columns past d
//   are not stored).
// * S = Q K^T: wgmma m64n128k16, Q and K from shared memory (K-major).
//   Masks and the scale by log2(e)/sqrt(d) apply in registers; only
//   tiles that cross the diagonal or T are masked.  Row max and sum stay
//   in f32 registers, reduced over the 4 lanes that share a row; the
//   normaliser sums the unrounded f32 P.  This softmax work per score on
//   the CUDA cores, not the tensor cores, is what holds the kernel back:
//   issuing the next tile's Q K^T before this tile's P V (3 stages, with
//   or without a ping-pong between the warpgroups) measured slower, and
//   fewer conversions per score faster (PERF.md).
// * O += P V: P goes from the S accumulator into register A fragments
//   (the accumulator's layout is the A layout).  One bf16 P would cost
//   the output more than its 2-ulp limit, so P is split into
//   P_hi = bf16(P) and P_lo = bf16(P - P_hi), and two wgmmas (m64nDPk16,
//   V from shared memory as (keys x d), i.e. the transposed-B form) add
//   both into the f32 accumulator: P_hi + P_lo carries 16 of P's 24 bits,
//   and bf16 products are exact in f32.
// * Grid: one launch over every (leading index, q tile), heaviest causal
//   tiles first, so the last wave is not all long tiles.  Causal tiles
//   past the CTA's last row are never loaded; keys past T score -1e30
//   (TMA zero-fills them and a zero key would score 0); rows past S store
//   nothing.
// * Layout: every tensor goes through its own TMA map, built on the host
//   from its strides (5 dims: d, rows, leading dims 2, 1, 0; a broadcast
//   dim of k or v has size 1 and coordinate 0), so the model passes views
//   and nothing is copied.  cuTensorMapEncodeTiled comes through
//   cudaGetDriverEntryPoint, so the library needs no -lcuda.  The output
//   is stored from registers through its strides.  The Hopper helpers
//   (mbarriers, TMA, descriptors, wgmma forms, maps) live in sm90.cuh,
//   shared with the backward.
// * lse: given a pointer (training), each row's logsumexp of its scaled
//   scores, m / sqrt(d) + ln(l), is stored from the registers that hold m
//   and l: one f32 per row, for the backward (csrc/flash_attention_bwd.cu).
//   That store is a second instantiation (kLse): compiled into the one
//   kernel, it cost the prefill, which passes null, 5-6 % at 1 x 4096
//   (PERF.md), so prefill runs the kernel without it.
//
// f32 design (flash_attention_kernel<D>): one CTA of 256 threads takes
// 64 query rows of one head; 4 threads share a row, each holding a
// quarter of the head dim of q and of the f32 accumulator in registers.
// K and V tiles of 32 keys are staged in shared memory; per tile each row
// takes its 32 scores (partial dots joined by two xor shuffles), rescales
// its running max, normaliser and accumulator once, then adds P.V.
// Every tensor is read through its strides (k and v: stride 0 where they
// broadcast); lse, when asked for, is m + ln(l) of the scaled scores.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90.cuh"   // mbarriers, TMA, wgmma descriptors and forms, maps
#include "smem_opt_in.cuh"

// ------------------------------------------------------ f32: CUDA cores --

constexpr int kBQ = 64;                   // query rows per CTA
constexpr int kBK = 32;                   // keys per staged tile
constexpr int kLanes = 4;                 // threads per query row
constexpr int kThreads = kBQ * kLanes;    // 256
constexpr float kMasked = -1e30f;         // the reference's NEG_INF

// Sizes of the leading dims 1 and 2 (dim 0 follows from the grid), and per
// tensor the strides of leading dims 0-2 and of the row (S or T) dim.
struct Layout {
  long long n1, n2;
  long long q[4], k[4], v[4], o[4];
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       float* __restrict__ lse, const Layout lay, int S,
                       int n_keys,
                       int n_qtiles, int causal, float sqrt_d) {
  constexpr int kVec = D / 4;             // float4 per row
  constexpr int kGroups = kVec / kLanes;  // float4 per thread
  __shared__ float4 ks[kBK][kVec];
  __shared__ float4 vs[kBK][kVec];

  const long long n = blockIdx.x / n_qtiles;
  const int qt = blockIdx.x % n_qtiles;
  const int row = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int s = qt * kBQ + row;
  const long long i2 = n % lay.n2, i1 = (n / lay.n2) % lay.n1,
                  i0 = n / (lay.n2 * lay.n1);
  const float* qp = q + i0 * lay.q[0] + i1 * lay.q[1] + i2 * lay.q[2] +
                    min(s, S - 1) * lay.q[3];
  const float* kp = k + i0 * lay.k[0] + i1 * lay.k[1] + i2 * lay.k[2];
  const float* vp = v + i0 * lay.v[0] + i1 * lay.v[1] + i2 * lay.v[2];

  float4 qr[kGroups], acc[kGroups];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    qr[g] = load4(qp + 4 * (lane + kLanes * g));
    acc[g] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = kMasked, l = 0.f;

  const int q_end = min(S, (qt + 1) * kBQ);     // past this CTA's last row
  const int k_end = causal ? min(n_keys, q_end) : n_keys;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    for (int i = threadIdx.x; i < kBK * kVec; i += kThreads) {
      const int r = i / kVec, c = i % kVec;
      const int t = k0 + r;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
      if (t < n_keys) {
        kk = load4(kp + t * lay.k[3] + 4 * c);
        vv = load4(vp + t * lay.v[3] + 4 * c);
      }
      ks[r][c] = kk;
      vs[r][c] = vv;
    }
    __syncthreads();

    float sc[kBK];
    float tile_max = kMasked;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const float4 kk = ks[j][lane + kLanes * g];
        part = fmaf(qr[g].x, kk.x, part);
        part = fmaf(qr[g].y, kk.y, part);
        part = fmaf(qr[g].z, kk.z, part);
        part = fmaf(qr[g].w, kk.w, part);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int t = k0 + j;
      const bool ok = t < n_keys && (!causal || t <= s);
      sc[j] = ok ? part / sqrt_d : kMasked;
      tile_max = fmaxf(tile_max, sc[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      acc[g].x *= alpha; acc[g].y *= alpha;
      acc[g].z *= alpha; acc[g].w *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float p = expf(sc[j] - m_new);
      l += p;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const float4 vv = vs[j][lane + kLanes * g];
        acc[g].x = fmaf(p, vv.x, acc[g].x);
        acc[g].y = fmaf(p, vv.y, acc[g].y);
        acc[g].z = fmaf(p, vv.z, acc[g].z);
        acc[g].w = fmaf(p, vv.w, acc[g].w);
      }
    }
    m = m_new;
    __syncthreads();                // the tile is restaged next iteration
  }

  if (s < S) {
    // the four lanes of a row hold the same m and l
    if (lse != nullptr && lane == 0) lse[n * S + s] = m + logf(l);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    float* op = out + i0 * lay.o[0] + i1 * lay.o[1] + i2 * lay.o[2] +
                s * lay.o[3];
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const float4 a = acc[g];
      store4(op + 4 * (lane + kLanes * g),
             make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv));
    }
  }
}

static void launch_f32(const float* qq, const float* kk, const float* vv,
                       float* oo, float* lse, const Layout& lay,
                       long long n_q, int S,
                       int n_keys, int D, int causal, cudaStream_t stream) {
  const int n_qtiles = (S + kBQ - 1) / kBQ;
  const dim3 grid((unsigned)(n_q * n_qtiles));
  const float sqrt_d = sqrtf((float)D);
  if (D == 64)
    flash_attention_kernel<64><<<grid, kThreads, 0, stream>>>(
        qq, kk, vv, oo, lse, lay, S, n_keys, n_qtiles, causal, sqrt_d);
  else if (D == 96)
    flash_attention_kernel<96><<<grid, kThreads, 0, stream>>>(
        qq, kk, vv, oo, lse, lay, S, n_keys, n_qtiles, causal, sqrt_d);
  else
    flash_attention_kernel<128><<<grid, kThreads, 0, stream>>>(
        qq, kk, vv, oo, lse, lay, S, n_keys, n_qtiles, causal, sqrt_d);
}

// dims: the leading sizes (n0, n1, n2); strides: 16 element strides, for
// q, k, v and out in turn those of leading dims 0-2 and of the row dim (k
// and v 0 where they broadcast): q and out (n0, n1, n2, S, D), k and v
// (n0, n1, n2, n_keys, D) as broadcast.  lse: null, or (n0, n1, n2, S)
// contiguous f32 for each row's logsumexp (natural log) of its scaled
// scores.  D in {64, 96, 128}; every stride a multiple of 4 and every
// pointer 16-byte aligned; float tensors.  Returns cudaGetLastError().
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, float* lse,
                                      const long long* dims,
                                      const long long* strides, int S,
                                      int n_keys, int D, int causal,
                                      void* stream) {
  if (D != 64 && D != 96 && D != 128) return (int)cudaErrorInvalidValue;
  const long long n_q = dims[0] * dims[1] * dims[2];
  if (n_q == 0 || S == 0) return (int)cudaGetLastError();
  const long long n_qtiles = (S + kBQ - 1) / kBQ;
  if (n_keys <= 0 || dims[1] <= 0 || dims[2] <= 0 ||
      n_q * n_qtiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 16; ++i)
    if (strides[i] % 4 != 0) return (int)cudaErrorInvalidValue;
  const void* ptrs[4] = {q, k, v, out};
  for (const void* p : ptrs)
    if ((uintptr_t)p % 16 != 0) return (int)cudaErrorMisalignedAddress;
  Layout lay;
  lay.n1 = dims[1];
  lay.n2 = dims[2];
  for (int i = 0; i < 4; ++i) {
    lay.q[i] = strides[i];
    lay.k[i] = strides[4 + i];
    lay.v[i] = strides[8 + i];
    lay.o[i] = strides[12 + i];
  }
  launch_f32((const float*)q, (const float*)k, (const float*)v, (float*)out,
             lse, lay, n_q, S, n_keys, D, causal, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// ---------------------------------------------- bf16: Hopper tensor cores --
namespace sm90 {

constexpr int kBQ = 128;                  // query rows per CTA (2 x 64)
constexpr int kBK = 128;                  // keys per K/V tile
constexpr int kStages = 2;                // K/V tiles in flight
constexpr int kThreads = 384;             // producer + 2 consumer warpgroups
constexpr int kTileBytes = kBK * kSlab * 2;   // one slab of 128 rows: 16 KB

// What the kernel needs beyond the tensor maps: the leading index's sizes
// (dim 0 follows from the grid), which leading dims each map indexes (0
// where it has size 1: a broadcast kv dim), and the output's strides.
struct Args {
  int n1, n2, n_q, n_qtiles, S, T, D, causal;
  int qi[3], ki[3], vi[3];                // leading dims 0-2: 1 if indexed
  long long o[4];                         // out: leading dims 0-2, rows
  float scale_log2;                       // log2(e) / sqrt(D)
  float* lse;                             // null, or (n_q, S) f32
};

// The online softmax of one tile of scores, in place: mask, the running
// max m of the raw scores (alpha: its rescale factor) and P = exp2((S - m)
// log2(e) / sqrt(d)) in f32 (one FMA and one ex2.approx per score),
// summed into l.  sc[i] is row r + 8 * ((i / 2) % 2) and key
// k0 + 8 * (i / 4) + c0 + i % 2 (the accumulator layout); the max is
// joined over the 4 lanes of a row here, the sums at the end.
__device__ __forceinline__ void softmax_tile(float (&sc)[64], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             int k0, int r, int c0, int row0,
                                             const Args& a) {
  const bool edge = k0 + kBK > a.T || (a.causal && k0 + kBK - 1 > row0);
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int key = k0 + 8 * (i / 4) + c0 + i % 2;
    const int row = r + 8 * ((i / 2) % 2);
    if (edge && !(key < a.T && (!a.causal || key <= row))) sc[i] = kMasked;
    mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
  }
  float neg[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    alpha[h] = ex2((m[h] - mx[h]) * a.scale_log2);
    m[h] = mx[h];
    neg[h] = -mx[h] * a.scale_log2;
    l[h] *= alpha[h];
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    sc[i] = ex2(fmaf(sc[i], a.scale_log2, neg[(i / 2) % 2]));
    l[(i / 2) % 2] += sc[i];
  }
}

// P into the A fragments of P_hi and P_lo: fragment register f holds
// p[2f], p[2f + 1] (the accumulator's layout is the A layout).  One
// conversion per pair rounds P_hi; P_hi - P is exact in f32, and P_lo is
// rounded to nearest (ties away from zero) by adding half a bf16 ulp to
// its bits before one byte permute keeps the top halves of the pair: one
// conversion per pair instead of two, a quarter less time per call on the
// H100 (PERF.md).
__device__ __forceinline__ void split_p(const float (&p)[64],
                                        uint32_t (&hi)[32],
                                        uint32_t (&lo)[32]) {
#pragma unroll
  for (int f = 0; f < 32; ++f) {
    const float p0 = p[2 * f], p1 = p[2 * f + 1];
    const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
    const uint32_t hb = pack(h);
    hi[f] = hb;
    lo[f] = __byte_perm(
        __float_as_uint(p0 - __uint_as_float(hb << 16)) + 0x8000u,
        __float_as_uint(p1 - __uint_as_float(hb & 0xffff0000u)) + 0x8000u,
        0x7632);
  }
}

template <int DP, bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel_sm90(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            __nv_bfloat16* __restrict__ out, const Args a) {
  constexpr int kSlabs = DP / kSlab;
  constexpr int kStageBytes = kSlabs * kTileBytes;  // one K or V tile
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  uint8_t* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  uint8_t* sq = smem;                                 // kSlabs x 16 KB
  uint8_t* sk = sq + kStageBytes;                     // kStages tiles
  uint8_t* sv = sk + kStages * kStageBytes;           // kStages tiles
  uint64_t* bars = (uint64_t*)(sv + kStages * kStageBytes);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;                          // K/V tile landed
  uint64_t* empty = bars + 1 + kStages;               // K/V tile consumed

  // heaviest causal q tiles first: rank r takes tile n_qtiles - 1 - r
  const int n = blockIdx.x % a.n_q;
  const int qt = a.n_qtiles - 1 - blockIdx.x / a.n_q;
  const int q0 = qt * kBQ;
  const int lead[3] = {n / (a.n2 * a.n1), (n / a.n2) % a.n1, n % a.n2};
  const int q_end = min(a.S, q0 + kBQ);
  const int k_end = a.causal ? min(a.T, q_end) : a.T;
  const int n_tiles = (k_end + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == 0) {
      int ql[3], kl[3], vl[3];
      for (int i = 0; i < 3; ++i) {
        ql[i] = lead[i] * a.qi[i];
        kl[i] = lead[i] * a.ki[i];
        vl[i] = lead[i] * a.vi[i];
      }
      mbar_expect_tx(q_full, kStageBytes);
      for (int c = 0; c < kSlabs; ++c)
        tma_load(&qmap, q_full, sq + c * kTileBytes, c * kSlab, q0, ql);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * kStageBytes);
        for (int c = 0; c < kSlabs; ++c) {
          tma_load(&kmap, &full[s], sk + s * kStageBytes + c * kTileBytes,
                   c * kSlab, j * kBK, kl);
          tma_load(&vmap, &full[s], sv + s * kStageBytes + c * kTileBytes,
                   c * kSlab, j * kBK, vl);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int wg = threadIdx.x / 128 - 1;
    const int lane = threadIdx.x % 32;
    const int row0 = q0 + 64 * wg;                   // the warpgroup's rows
    // this thread's rows in the accumulator layout: r and r + 8
    const int r = row0 + 16 * ((threadIdx.x % 128) / 32) + lane / 4;
    const int c0 = 2 * (lane % 4);                   // and its first column

    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};

    const uint8_t* sqw = sq + 64 * 128 * wg;       // the warpgroup's Q rows
    float sc[64], alpha[2];
    uint32_t hi[32], lo[32];
    mbar_wait(q_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      mbar_wait(&full[s], (j / kStages) & 1);
      wg_fence();
      // S = Q K^T: DP / 16 steps, Q (64 rows) and K (kBK) K-major
      issue_ss<DP>(sc, sqw, kTileBytes, sk + s * kStageBytes, kTileBytes);
      wg_commit();
      wg_wait();
      pin(sc);
      softmax_tile(sc, m, l, alpha, j * kBK, r, c0, row0, a);
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) o[i] *= alpha[(i / 2) % 2];
      split_p(sc, hi, lo);

      // O += P_hi V + P_lo V over kBK / 16 steps of 16 keys
      pin(o);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t vd = desc_sw128(sv + s * kStageBytes + kk * 16 * 128,
                                       kTileBytes, 1024);
        mma_rs(o, hi + 4 * kk, vd);
        mma_rs(o, lo + 4 * kk, vd);
      }
      wg_commit();
      wg_wait();
      pin(o);
      pin(hi);
      pin(lo);
      mbar_arrive(&empty[s]);
    }

    // normalise and store rows below S, columns below D; lse = m / sqrt(d)
    // + ln(l) from the raw-score max and the base-2 sum: (m log2(e) /
    // sqrt(d) + log2(l)) ln(2), written by the first of a row's 4 lanes
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      const int row = r + 8 * h;
      if (kLse && lane % 4 == 0 && row < a.S)
        a.lse[(long long)n * a.S + row] =
            fmaf(m[h], a.scale_log2, log2f(l[h])) * 0.6931471805599453f;
      l[h] = 1.f / l[h];
    }
    const long long base = lead[0] * a.o[0] + lead[1] * a.o[1] +
                           lead[2] * a.o[2];
#pragma unroll
    for (int i = 0; i < DP / 2; i += 2) {
      const int row = r + 8 * ((i / 2) % 2);
      const int col = 8 * (i / 4) + c0;
      if (row < a.S && col < a.D)
        *reinterpret_cast<__nv_bfloat162*>(out + base + row * a.o[3] + col) =
            __floats2bfloat162_rn(o[i] * l[(i / 2) % 2],
                                  o[i + 1] * l[(i / 2) % 2]);
    }
  }
}

template <int DP, bool kLse>
static int launch(const CUtensorMap* maps, void* out, const Args& a,
                  cudaStream_t stream) {
  constexpr int kSmem = 1024 + (1 + 2 * kStages) * (DP / kSlab) * kTileBytes +
                        (1 + 2 * kStages) * 8;
  static std::atomic<unsigned long long> sized{0};   // once per device
  const cudaError_t e =
      opt_in_smem(sized, flash_attention_kernel_sm90<DP, kLse>, kSmem);
  if (e != cudaSuccess) return (int)e;
  flash_attention_kernel_sm90<DP, kLse>
      <<<(unsigned)(a.n_q * a.n_qtiles), kThreads, kSmem, stream>>>(
          maps[0], maps[1], maps[2], (__nv_bfloat16*)out, a);
  return (int)cudaGetLastError();
}

}  // namespace sm90

// bf16 q, k, v, out.  dims: 15 sizes, for q, k and v in turn their map's
// (d, rows, leading 2, 1, 0), a broadcast dim of size 1; strides: 12 byte
// strides, per map those of its four outer dims (multiples of 16); lead:
// the leading sizes (n0, n1, n2) of q and out; out_strides: 4 element
// strides of out's leading dims 0-2 and rows; lse as flash_attention_launch
// takes it.  D in {64, 96, 128}; every pointer 16-byte aligned.  Returns a
// cudaError_t.
extern "C" int flash_attention_sm90_launch(
    const void* q, const void* k, const void* v, void* out, float* lse,
    const long long* dims, const long long* strides, const long long* lead,
    const long long* out_strides, int S, int T, int D, int causal,
    void* stream) {
  if (D != 64 && D != 96 && D != 128) return (int)cudaErrorInvalidValue;
  const long long n_q = lead[0] * lead[1] * lead[2];
  if (n_q == 0 || S == 0) return (int)cudaGetLastError();
  const long long n_qtiles = (S + sm90::kBQ - 1) / sm90::kBQ;
  if (T <= 0 || lead[1] <= 0 || lead[2] <= 0 ||
      n_q * n_qtiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[4] = {q, k, v, out};
  for (const void* p : ptrs)
    if ((uintptr_t)p % 16 != 0) return (int)cudaErrorMisalignedAddress;
  CUtensorMap maps[3];
  for (int t = 0; t < 3; ++t)
    if (!sm90::make_map(&maps[t], ptrs[t], dims + 5 * t, strides + 4 * t,
                        sm90::kBK))
      return (int)cudaErrorInvalidValue;
  sm90::Args a;
  a.n1 = (int)lead[1];
  a.n2 = (int)lead[2];
  a.n_q = (int)n_q;
  a.n_qtiles = (int)n_qtiles;
  a.S = S;
  a.T = T;
  a.D = D;
  a.causal = causal;
  for (int i = 0; i < 3; ++i) {          // map dim 4 - i is leading dim i
    a.qi[i] = dims[4 - i] > 1;
    a.ki[i] = dims[5 + 4 - i] > 1;
    a.vi[i] = dims[10 + 4 - i] > 1;
  }
  for (int i = 0; i < 4; ++i) a.o[i] = out_strides[i];
  a.scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  a.lse = lse;
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 64)
    return lse ? sm90::launch<64, true>(maps, out, a, st)
               : sm90::launch<64, false>(maps, out, a, st);
  return lse ? sm90::launch<128, true>(maps, out, a, st)
             : sm90::launch<128, false>(maps, out, a, st);
}
