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
// bf16 design (flash_attention_kernel_sm90<DP>, DP = the head dim padded
// to 64 or 128):
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
//   is stored from registers through its strides.
//
// f32 design (flash_attention_kernel<D>): one CTA of 256 threads takes
// 64 query rows of one head; 4 threads share a row, each holding a
// quarter of the head dim of q and of the f32 accumulator in registers.
// K and V tiles of 32 keys are staged in shared memory; per tile each row
// takes its 32 scores (partial dots joined by two xor shuffles), rescales
// its running max, normaliser and accumulator once, then adds P.V.
// Every tensor is read through its strides (k and v: stride 0 where they
// broadcast).
#include <cstdint>
#include <cuda.h>          // CUtensorMap and its enums; no -lcuda needed
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
                       const Layout lay, int S, int n_keys,
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
                       float* oo, const Layout& lay, long long n_q, int S,
                       int n_keys, int D, int causal, cudaStream_t stream) {
  const int n_qtiles = (S + kBQ - 1) / kBQ;
  const dim3 grid((unsigned)(n_q * n_qtiles));
  const float sqrt_d = sqrtf((float)D);
  if (D == 64)
    flash_attention_kernel<64><<<grid, kThreads, 0, stream>>>(
        qq, kk, vv, oo, lay, S, n_keys, n_qtiles, causal, sqrt_d);
  else if (D == 96)
    flash_attention_kernel<96><<<grid, kThreads, 0, stream>>>(
        qq, kk, vv, oo, lay, S, n_keys, n_qtiles, causal, sqrt_d);
  else
    flash_attention_kernel<128><<<grid, kThreads, 0, stream>>>(
        qq, kk, vv, oo, lay, S, n_keys, n_qtiles, causal, sqrt_d);
}

// dims: the leading sizes (n0, n1, n2); strides: 16 element strides, for
// q, k, v and out in turn those of leading dims 0-2 and of the row dim (k
// and v 0 where they broadcast): q and out (n0, n1, n2, S, D), k and v
// (n0, n1, n2, n_keys, D) as broadcast.  D in {64, 96, 128}; every stride
// a multiple of 4 and every pointer 16-byte aligned; float tensors.
// Returns cudaGetLastError().
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out,
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
             lay, n_q, S, n_keys, D, causal, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// ---------------------------------------------- bf16: Hopper tensor cores --
namespace sm90 {

constexpr int kBQ = 128;                  // query rows per CTA (2 x 64)
constexpr int kBK = 128;                  // keys per K/V tile
constexpr int kStages = 2;                // K/V tiles in flight
constexpr int kThreads = 384;             // producer + 2 consumer warpgroups
constexpr int kSlab = 64;                 // bf16 columns per 128-byte row
constexpr int kTileBytes = kBK * kSlab * 2;   // one slab of 128 rows: 16 KB

// What the kernel needs beyond the tensor maps: the leading index's sizes
// (dim 0 follows from the grid), which leading dims each map indexes (0
// where it has size 1: a broadcast kv dim), and the output's strides.
struct Args {
  int n1, n2, n_q, n_qtiles, S, T, D, causal;
  int qi[3], ki[3], vi[3];                // leading dims 0-2: 1 if indexed
  long long o[4];                         // out: leading dims 0-2, rows
  float scale_log2;                       // log2(e) / sqrt(D)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

// Blocks until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done)
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}"
                 : "=r"(done) : "r"(addr), "r"(parity) : "memory");
}

// One box of a 5-dim map (d, rows, leading dims 2, 1, 0) into shared
// memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(const CUtensorMap* map,
                                         uint64_t* bar, void* dst, int col,
                                         int row, const int (&lead)[3]) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];"
      :: "r"(smem_u32(dst)), "l"((uint64_t)map), "r"(smem_u32(bar)),
         "r"(col), "r"(row), "r"(lead[2]), "r"(lead[1]), "r"(lead[0])
      : "memory");
}

// wgmma shared-memory descriptor for a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (given in bytes, held in
// 16-byte units), layout B128.
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Pins registers in place across an asynchronous wgmma: the compiler may
// neither read an accumulator before wg_wait nor reuse an A fragment's
// registers while the product still reads them.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

#define F4(i) "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3])
#define F16(i) F4(i), F4((i) + 4), F4((i) + 8), F4((i) + 12)
#define R32 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, " \
    "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
    "%28, %29, %30, %31"
#define R64 R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, " \
    "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, " \
    "%57, %58, %59, %60, %61, %62, %63"

// d (64 x 128 f32) = or += A (64 x 16, shared) B^T (128 x 16, shared).
__device__ __forceinline__ void mma_ss_n128(float (&d)[64], uint64_t a,
                                            uint64_t b, int accumulate) {
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
               " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
               R64 "}, %64, %65, p, 1, 1, 0, 0;\n}"
               : F16(0), F16(16), F16(32), F16(48)
               : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x N f32) += A (64 x 16, registers) B (16 x N, shared, N-major).
__device__ __forceinline__ void mma_rs(float (&d)[64], const uint32_t* a,
                                       uint64_t b) {
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
               " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
               R64 "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}"
               : F16(0), F16(16), F16(32), F16(48)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
                 "r"(1));
}
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t* a,
                                       uint64_t b) {
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
               " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
               R32 "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}"
               : F16(0), F16(16)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
                 "r"(1));
}
#undef F4
#undef F16
#undef R32
#undef R64

__device__ __forceinline__ uint32_t pack(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// S = Q K^T of one tile, issued and not waited for: DP / 16 steps of 16
// columns, Q (64 rows) and K (kBK rows) K-major in shared memory.
template <int DP>
__device__ __forceinline__ void issue_s(float (&sc)[64], const uint8_t* sq,
                                        const uint8_t* sk) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int off = (kk / 4) * kTileBytes + (kk % 4) * 32;
    mma_ss_n128(sc, desc_sw128(sq + off, 16, 1024),
                desc_sw128(sk + off, 16, 1024), kk > 0);
  }
}

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

template <int DP>
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
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
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
      issue_s<DP>(sc, sqw, sk + s * kStageBytes);
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

    // normalise and store rows below S, columns below D
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
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

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, found through the runtime, so the
// library links against nothing but cudart.
static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// A bf16 map of dims (d, rows, leading 2, 1, 0) with byte strides of the
// four outer dims, read in boxes of 64 columns x 128 rows, 128-byte swizzle,
// zero fill out of bounds.
static bool make_map(CUtensorMap* map, const void* ptr,
                     const long long* dims, const long long* strides) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t gdim[5], gstride[4];
  for (int i = 0; i < 5; ++i) gdim[i] = (cuuint64_t)dims[i];
  for (int i = 0; i < 4; ++i) gstride[i] = (cuuint64_t)strides[i];
  const cuuint32_t box[5] = {kSlab, kBK, 1, 1, 1};
  const cuuint32_t step[5] = {1, 1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(ptr),
            gdim, gstride, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP>
static int launch(const CUtensorMap* maps, void* out, const Args& a,
                  cudaStream_t stream) {
  constexpr int kSmem = 1024 + (1 + 2 * kStages) * (DP / kSlab) * kTileBytes +
                        (1 + 2 * kStages) * 8;
  static bool sized = false;           // raise the dynamic shared limit once
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel_sm90<DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  flash_attention_kernel_sm90<DP>
      <<<(unsigned)(a.n_q * a.n_qtiles), kThreads, kSmem, stream>>>(
          maps[0], maps[1], maps[2], (__nv_bfloat16*)out, a);
  return (int)cudaGetLastError();
}

}  // namespace sm90

// bf16 q, k, v, out.  dims: 15 sizes, for q, k and v in turn their map's
// (d, rows, leading 2, 1, 0), a broadcast dim of size 1; strides: 12 byte
// strides, per map those of its four outer dims (multiples of 16); lead:
// the leading sizes (n0, n1, n2) of q and out; out_strides: 4 element
// strides of out's leading dims 0-2 and rows.  D in {64, 96, 128}; every
// pointer 16-byte aligned.  Returns a cudaError_t.
extern "C" int flash_attention_sm90_launch(
    const void* q, const void* k, const void* v, void* out,
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
    if (!sm90::make_map(&maps[t], ptrs[t], dims + 5 * t, strides + 4 * t))
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
  if (D == 64) return sm90::launch<64>(maps, out, a, (cudaStream_t)stream);
  return sm90::launch<128>(maps, out, a, (cudaStream_t)stream);
}
