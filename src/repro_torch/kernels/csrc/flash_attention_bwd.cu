// The backward pass of flash attention, for training: given q, k, v, the
// forward's output o, its lse and the output's gradient do, the gradients
// dq, dk and dv of out = softmax(q k^T / sqrt(d), causal top-left mask) v.
//
// Replaces no TPU kernel: the reference's Pallas flash_attention
// (src/repro/kernels/flash_attention.py) has no backward, and the
// reference's model trains through attend, which jax differentiates.  The
// port trains through its own forward kernel (csrc/flash_attention.cu),
// and a ctypes-launched kernel has no autograd, so this is the gradient
// of that forward: kernels/flash_attention.py wraps both in a
// torch.autograd.Function.
//
// Contract (flash_attention_bwd_plain in kernels/flash_attention.py):
// scores s = q.k / sqrt(d) in f32, masked keys (causal: key j > row i) out,
// P = exp(s - lse) with lse the row's logsumexp that the forward saved,
// D = rowsum(do * o) in f32, dP = do v^T, dS = P * (dP - D),
// dq = dS k / sqrt(d), dk = dS^T q / sqrt(d), dv = P^T do.  Sums in f32;
// one cast to the inputs' type at the end.  k and v may serve G query
// heads each (grouped-query attention): dk and dv are summed over the G
// heads in f32 before the cast.
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s): the five products of
// the gradient take 10 d flops per unmasked (query, key) pair; for
// qwen3-4b at 4 x 512 that is 2.2e10 flops (0.022 ms) against 84 MB read
// and written (0.025 ms), at 1 x 4096 3.4e11 flops (0.35 ms), bound by
// operations.  With lse from the forward, the kernels below do 7 products
// (14 d flops a pair): S and dP once in each kernel, and dq, dk, dv.
//
// Two launches, deterministic, no atomics: every output tile has one
// writer, so a rerun is bit for bit the same.  The inputs are read through
// TMA maps of the model's own views (their strides, as the forward reads
// them); dq, dk and dv are stored through their strides.
//
// bf16, on Hopper's tensor cores (flash_attention_bwd_*_sm90<DP>, DP = the
// head dim padded to 64 or 128; d 96 is loaded as 128, TMA zero-filling
// columns 96-127, and columns past d are not stored).  Both kernels are
// the forward's shape: 384 threads, warpgroup 0 a producer whose one
// thread issues every TMA load (setmaxnreg 24), warpgroups 1 and 2
// consumers (240 registers) of 64 rows each; a ring of stages with
// full and empty mbarriers.  Every product is one of two wgmma forms: SS
// with both operands K-major in shared memory, or RS with A from the
// accumulator's registers as bf16 fragments (the accumulator's layout is
// the A layout) and B MN-major in shared memory.  P and dS go to the
// products as single bf16 values (the backward's limit is looser than the
// forward's; tests/test_torch_flash.py's model of this arithmetic holds
// it to that limit); neither touches shared or device memory.
// * dq (flash_attention_bwd_dq_sm90): one CTA per (query head, 128 rows),
//   heaviest causal tiles first.  Q, dO and O are loaded once; D =
//   rowsum(dO * O) from the swizzled tiles (a row's 16-byte chunks stay in
//   its own 128-byte line), two threads a row.  K/V tiles of 128 keys
//   stream through 2 stages (all the shared memory 3 x 128 rows of Q, dO
//   and O leave at d 128); causal tiles past the CTA's last row are not
//   loaded.  Per tile: S = Q K^T and dP = dO V^T (SS, m64n128), P =
//   exp2(S log2(e) / sqrt(d) - lse log2(e)) and dS = P (dP - D) in
//   registers, dQ += dS K (RS, K MN-major).  The CTA writes lse log2(e)
//   (+inf past S) and D to an f32 scratch of (q heads, S rounded up to
//   64) for the second kernel.
// * dk/dv (flash_attention_bwd_dkdv_sm90): one CTA per (kv head, 128
//   keys), key tile 0 (the most causal work) first.  K and V stay in
//   shared memory; the CTA loops, in a fixed order, over its kv head's G
//   query heads and the 64-row q tiles the mask leaves, through 3 stages
//   (1-2 % faster than 2 on an H100, PERF.md), each holding a Q and a dO
//   tile plus their 64 lse and D values (one bulk copy each).
//   Per tile: S^T = K Q^T and dP^T = V dO^T (SS, m64n64), P^T and dS^T in
//   registers, dV += P^T dO and dK += dS^T Q (RS).  dK and dV stay in
//   registers (128 a thread at d 128) across the loop, so the G heads sum
//   in f32 without atomics, and are stored once.  q rows past S take
//   lse = +inf, so P = 0 there.
//
// f32 (flash_attention_bwd_*_f32<D>): scalar f32 FMAs (tensor cores would
// round f32 to TF32, as the forward's header explains).  The same two
// launches with tiles of 64 rows and 64 keys staged in shared memory as
// f32, rows padded to d + 1 floats; a thread computes a 4 x 4 block of
// each 64 x 64 product and a 4 x d/16 block of each 64 x d one.  Every
// tensor is read and written through its element strides.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// The leading index: sizes n1, n2 of leading dims 1 and 2 (dim 0 follows
// from n_q), which leading dims k and v index (1) or broadcast over (0),
// and the number of q heads, of kv heads (the indexed dims' product) and
// of q heads per kv head (the broadcast dims').
struct Lead {
  int n1, n2, n_q, n_kv, G;
  int ki[3];
};

// q head n's leading coordinates
__device__ __forceinline__ void q_lead(int n, const Lead& L, int (&c)[3]) {
  c[0] = n / (L.n2 * L.n1);
  c[1] = (n / L.n2) % L.n1;
  c[2] = n % L.n2;
}

// the coordinates of kv head u's g-th query head (u row-major over the
// indexed dims, g over the broadcast ones); returns its q head index
__device__ __forceinline__ int kv_lead(int u, int g, const Lead& L,
                                       int (&c)[3]) {
  const int n[3] = {L.n_q / (L.n1 * L.n2), L.n1, L.n2};
#pragma unroll
  for (int i = 2; i >= 0; --i) {
    if (L.ki[i]) {
      c[i] = u % n[i];
      u /= n[i];
    } else {
      c[i] = g % n[i];
      g /= n[i];
    }
  }
  return (c[0] * L.n1 + c[1]) * L.n2 + c[2];
}

template <int N>
__device__ __forceinline__ long long offset(const int (&c)[3],
                                            const long long (&st)[N]) {
  return c[0] * st[0] + c[1] * st[1] + c[2] * st[2];
}

// ------------------------------------------------------ f32: CUDA cores --

constexpr int kB = 64;          // rows of a q tile and of a k tile
constexpr int kThreadsF = 256;  // 16 x 16: tx, ty
constexpr int kPS = kB + 1;     // padded row of a 64 x 64 tile

struct F32Args {
  Lead L;
  const float *q, *k, *v, *o, *dout, *lse;
  float *dq, *dk, *dv, *delta;  // delta: (n_q, S)
  long long st[8][4];           // q, k, v, o, do, dq, dk, dv: lead 0-2, rows
  int S, T, causal;
  float scale;                  // 1 / sqrt(d)
};

// rows [row0, row0 + 64) of a (n_rows, D) matrix with row stride rs into a
// padded f32 tile; rows past n_rows are zeros
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long rs, int row0,
                                          int n_rows) {
  for (int i = threadIdx.x; i < kB * D; i += kThreadsF) {
    const int r = i / D, c = i - (i / D) * D;
    const int g = row0 + r;
    dst[r * (D + 1) + c] = g < n_rows ? src[g * rs + c] : 0.f;
  }
}

// acc[i][j] = sum_c A[ty + 16 i][c] * B[tx + 16 j][c] over padded tiles
template <int D>
__device__ __forceinline__ void dot_tile(float acc[4][4], const float* A,
                                         const float* B, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < D; ++c) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * (D + 1) + c];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * (D + 1) + c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] += sum_n X(ty + 16 i, n) * Y[n][tx + 16 j], n over 64 rows of
// the padded tile Y; X(r, n) = X[r * xr + n * xn] in a 64 x 64 tile
template <int D>
__device__ __forceinline__ void acc_tile(float acc[4][D / 16], const float* X,
                                         int xr, int xn, const float* Y,
                                         int ty, int tx) {
#pragma unroll 2
  for (int n = 0; n < kB; ++n) {
    float x[4], y[D / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = X[(ty + 16 * i) * xr + n * xn];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) y[j] = Y[n * (D + 1) + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

// a sum over the 16 threads (tx) that share a row: lanes 0-15 and 16-31 of
// a warp hold two different rows
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

template <int D>
__global__ void __launch_bounds__(kThreadsF)
flash_attention_bwd_dq_f32(F32Args a) {
  extern __shared__ float sm[];
  float* Qs = sm;                       // [64][D + 1]
  float* dOs = Qs + kB * (D + 1);
  float* Ks = dOs + kB * (D + 1);
  float* Vs = Ks + kB * (D + 1);
  float* dSs = Vs + kB * (D + 1);       // [64][65]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int n_qt = (a.S + kB - 1) / kB;
  const int n = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x - n * n_qt) * kB;
  int c[3], kc[3];
  q_lead(n, a.L, c);
  for (int i = 0; i < 3; ++i) kc[i] = c[i] * a.L.ki[i];
  const float* k = a.k + offset(kc, a.st[1]);
  const float* v = a.v + offset(kc, a.st[2]);

  load_tile<D>(Qs, a.q + offset(c, a.st[0]), a.st[0][3], q0, a.S);
  load_tile<D>(dOs, a.dout + offset(c, a.st[4]), a.st[4][3], q0, a.S);
  load_tile<D>(Ks, a.o + offset(c, a.st[3]), a.st[3][3], q0, a.S);  // o
  __syncthreads();
  float delta[4], lse[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float s = 0.f;
    const int r = ty + 16 * i, row = q0 + r;
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      s = fmaf(dOs[r * (D + 1) + tx + 16 * j], Ks[r * (D + 1) + tx + 16 * j],
               s);
    delta[i] = row_sum(s);
    lse[i] = row < a.S ? a.lse[(long long)n * a.S + row] : 0.f;
    if (tx == 0 && row < a.S) a.delta[(long long)n * a.S + row] = delta[i];
  }

  // dq += dS k over the k tiles the mask leaves
  const int all = (a.T + kB - 1) / kB;
  const int n_kt = a.causal ? min(all, (min(q0 + kB, a.S) - 1) / kB + 1)
                            : all;
  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;
  float s[4][4], dp[4][4];
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();
    load_tile<D>(Ks, k, a.st[1][3], kt * kB, a.T);
    load_tile<D>(Vs, v, a.st[2][3], kt * kB, a.T);
    __syncthreads();
    dot_tile<D>(s, Qs, Ks, ty, tx);
    dot_tile<D>(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = kt * kB + tx + 16 * j;
        const bool ok = key < a.T && (!a.causal || key <= row);
        const float p = ok ? expf(s[i][j] * a.scale - lse[i]) : 0.f;
        dSs[(ty + 16 * i) * kPS + tx + 16 * j] = p * (dp[i][j] - delta[i]);
      }
    }
    __syncthreads();
    acc_tile<D>(acc, dSs, kPS, 1, Ks, ty, tx);
  }
  float* dq = a.dq + offset(c, a.st[5]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.S) continue;
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      dq[row * a.st[5][3] + tx + 16 * j] = acc[i][j] * a.scale;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreadsF)
flash_attention_bwd_dkdv_f32(F32Args a) {
  extern __shared__ float sm[];
  float* Ks = sm;                       // [64][D + 1]
  float* Vs = Ks + kB * (D + 1);
  float* Qs = Vs + kB * (D + 1);
  float* dOs = Qs + kB * (D + 1);
  float* Ps = dOs + kB * (D + 1);       // [64 q][65]
  float* dSs = Ps + kB * kPS;           // [64 q][65]
  float* lse_s = dSs + kB * kPS;        // [64]
  float* delta_s = lse_s + kB;          // [64]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int n_kt = (a.T + kB - 1) / kB;
  const int u = blockIdx.x / n_kt;
  const int k0 = (blockIdx.x - u * n_kt) * kB;
  int kc[3];
  kv_lead(u, 0, a.L, kc);
  load_tile<D>(Ks, a.k + offset(kc, a.st[1]), a.st[1][3], k0, a.T);
  load_tile<D>(Vs, a.v + offset(kc, a.st[2]), a.st[2][3], k0, a.T);

  float dk[4][D / 16], dv[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) dk[i][j] = dv[i][j] = 0.f;
  const int n_qt = (a.S + kB - 1) / kB;
  const int qt0 = a.causal ? k0 / kB : 0;   // rows before k0 see no key here
  float s[4][4], dp[4][4];
  for (int g = 0; g < a.L.G; ++g) {
    int c[3];
    const int n = kv_lead(u, g, a.L, c);
    const float* q = a.q + offset(c, a.st[0]);
    const float* dout = a.dout + offset(c, a.st[4]);
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * kB;
      __syncthreads();
      load_tile<D>(Qs, q, a.st[0][3], q0, a.S);
      load_tile<D>(dOs, dout, a.st[4][3], q0, a.S);
      if (threadIdx.x < kB) {
        const int row = q0 + threadIdx.x;
        const long long at = (long long)n * a.S + row;
        lse_s[threadIdx.x] = row < a.S ? a.lse[at] : 0.f;
        delta_s[threadIdx.x] = row < a.S ? a.delta[at] : 0.f;
      }
      __syncthreads();
      dot_tile<D>(s, Qs, Ks, ty, tx);     // rows: queries, columns: keys
      dot_tile<D>(dp, dOs, Vs, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i, row = q0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int cc = tx + 16 * j, key = k0 + cc;
          const bool ok = row < a.S && key < a.T && (!a.causal || key <= row);
          const float p = ok ? expf(s[i][j] * a.scale - lse_s[r]) : 0.f;
          Ps[r * kPS + cc] = p;
          dSs[r * kPS + cc] = p * (dp[i][j] - delta_s[r]);
        }
      }
      __syncthreads();
      // rows of dk, dv are keys: X(key, q) = P[q][key]
      acc_tile<D>(dv, Ps, 1, kPS, dOs, ty, tx);
      acc_tile<D>(dk, dSs, 1, kPS, Qs, ty, tx);
    }
  }
  float* dkp = a.dk + offset(kc, a.st[6]);
  float* dvp = a.dv + offset(kc, a.st[7]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= a.T) continue;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      dkp[key * a.st[6][3] + tx + 16 * j] = dk[i][j] * a.scale;
      dvp[key * a.st[7][3] + tx + 16 * j] = dv[i][j];
    }
  }
}

template <int D>
cudaError_t launch_f32(const F32Args& a, cudaStream_t stream) {
  const size_t tile = (size_t)kB * (D + 1) * sizeof(float);
  const size_t smem_a = 4 * tile + (size_t)kB * kPS * sizeof(float);
  const size_t smem_b = 4 * tile + 2 * (size_t)kB * kPS * sizeof(float) +
                        2 * kB * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_bwd_dq_f32<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(flash_attention_bwd_dkdv_f32<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_b);
  if (e != cudaSuccess) return e;
  const long long grid_a = (long long)a.L.n_q * ((a.S + kB - 1) / kB);
  const long long grid_b = (long long)a.L.n_kv * ((a.T + kB - 1) / kB);
  flash_attention_bwd_dq_f32<D>
      <<<(unsigned)grid_a, kThreadsF, smem_a, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_attention_bwd_dkdv_f32<D>
      <<<(unsigned)grid_b, kThreadsF, smem_b, stream>>>(a);
  return cudaGetLastError();
}

// The Lead of leading sizes (n0, n1, n2), k indexing leading dim i where
// kidx[i]; false if a size is not positive or a count passes int range.
bool make_lead(Lead* L, const long long* lead, const int (&kidx)[3]) {
  long long n_q = 1, n_kv = 1;
  for (int i = 0; i < 3; ++i) {
    if (lead[i] <= 0) return false;
    n_q *= lead[i];
    if (kidx[i]) n_kv *= lead[i];
  }
  if (n_q > 0x7fffffffLL) return false;
  L->n1 = (int)lead[1];
  L->n2 = (int)lead[2];
  L->n_q = (int)n_q;
  L->n_kv = (int)n_kv;
  L->G = (int)(n_q / n_kv);
  for (int i = 0; i < 3; ++i) L->ki[i] = kidx[i];
  return true;
}

}  // namespace

// ---------------------------------------------- bf16: Hopper tensor cores --
namespace sm90 {
namespace {

constexpr int kThreads = 384;             // producer + 2 consumer warpgroups
constexpr int kRows = 128;                // dq: q rows a CTA; dk/dv: keys
constexpr int kKeys = 128;                // dq: keys per K/V tile
constexpr int kQRows = 64;                // dk/dv: q rows per Q/dO tile
constexpr int kStagesQ = 2;               // dq: K/V tiles in flight
constexpr int kStagesKV = 3;              // dk/dv: Q/dO tiles in flight
constexpr int kBig = kRows * kSlab * 2;   // a slab of 128 rows: 16 KB
constexpr int kSmall = kQRows * kSlab * 2;    // a slab of 64 rows: 8 KB

struct Args {
  Lead L;
  int S, T, D, causal;
  int S_pad;             // S rounded up to 64: the scratch's row count
  int n_qtiles;          // dq: 128-row q tiles
  int n_ktiles;          // dk/dv: 128-key tiles
  long long dq[4], dk[4], dv[4];  // element strides: leading dims 0-2, rows
  const float* lse;      // the forward's: (n_q, S), natural log
  float* lse2;           // scratch (n_q, S_pad): lse log2(e), +inf past S
  float* delta;          // scratch (n_q, S_pad): D, 0 past S
  float scale_log2;      // log2(e) / sqrt(D)
  float scale;           // 1 / sqrt(D)
};

// 8 bf16 products of two 16-byte chunks added to s
__device__ __forceinline__ float dot8(uint4 x, uint4 y, float s) {
  const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&xs[i]));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&ys[i]));
    s = fmaf(a.x, b.x, s);
    s = fmaf(a.y, b.y, s);
  }
  return s;
}

// Stores a 64 x DP accumulator (rows r and r + 8 of this thread, columns
// 8 (i / 4) + c0 + i % 2) times `mul` as bf16: rows below n_rows, columns
// below D, through `rs` elements a row.
template <int M>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base,
                                           const float (&acc)[M], float mul,
                                           int r, int c0, int n_rows, int D,
                                           long long rs) {
#pragma unroll
  for (int i = 0; i < M; i += 2) {
    const int row = r + 8 * ((i / 2) % 2);
    const int col = 8 * (i / 4) + c0;
    if (row < n_rows && col < D)
      *reinterpret_cast<__nv_bfloat162*>(base + row * rs + col) =
          __floats2bfloat162_rn(acc[i] * mul, acc[i + 1] * mul);
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_bwd_dq_sm90(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            const __grid_constant__ CUtensorMap omap,
                            const __grid_constant__ CUtensorMap dmap,
                            __nv_bfloat16* __restrict__ dq, const Args a) {
  constexpr int kSlabs = DP / kSlab;
  constexpr int kTile = kSlabs * kBig;          // one 128-row tile
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  uint8_t* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  uint8_t* sq = smem;
  uint8_t* sdo = sq + kTile;
  uint8_t* so = sdo + kTile;
  uint8_t* sk = so + kTile;                     // kStagesQ tiles
  uint8_t* sv = sk + kStagesQ * kTile;           // kStagesQ tiles
  uint64_t* bars = (uint64_t*)(sv + kStagesQ * kTile);
  uint64_t* q_full = bars;                      // Q, dO and O landed
  uint64_t* full = bars + 1;                    // K/V tile landed
  uint64_t* empty = bars + 1 + kStagesQ;         // K/V tile consumed
  float* sd = (float*)(bars + 1 + 2 * kStagesQ); // D of the 128 rows

  // heaviest causal q tiles first: rank r takes tile n_qtiles - 1 - r
  const int n = blockIdx.x % a.L.n_q;
  const int q0 = (a.n_qtiles - 1 - blockIdx.x / a.L.n_q) * kRows;
  int lead[3];
  q_lead(n, a.L, lead);
  const int q_end = min(a.S, q0 + kRows);
  const int k_end = a.causal ? min(a.T, q_end) : a.T;
  const int n_tiles = (k_end + kKeys - 1) / kKeys;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStagesQ; ++s) {
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
      int kl[3];
      for (int i = 0; i < 3; ++i) kl[i] = lead[i] * a.L.ki[i];
      mbar_expect_tx(q_full, 3 * kTile);
      for (int c = 0; c < kSlabs; ++c) {
        tma_load(&qmap, q_full, sq + c * kBig, c * kSlab, q0, lead);
        tma_load(&dmap, q_full, sdo + c * kBig, c * kSlab, q0, lead);
        tma_load(&omap, q_full, so + c * kBig, c * kSlab, q0, lead);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStagesQ;
        mbar_wait(&empty[s], ((j / kStagesQ) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * kTile);
        for (int c = 0; c < kSlabs; ++c) {
          tma_load(&kmap, &full[s], sk + s * kTile + c * kBig, c * kSlab,
                   j * kKeys, kl);
          tma_load(&vmap, &full[s], sv + s * kTile + c * kBig, c * kSlab,
                   j * kKeys, kl);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int wg = threadIdx.x / 128 - 1;
    const int t = threadIdx.x % 128;
    const int lane = threadIdx.x % 32;
    const int row0 = q0 + 64 * wg;                   // the warpgroup's rows
    // this thread's rows in the accumulator layout: r and r + 8
    const int r = row0 + 16 * (t / 32) + lane / 4;
    const int c0 = 2 * (lane % 4);                   // and its first column
    mbar_wait(q_full, 0);

    // D = rowsum(dO * O), two threads a row, each over half its chunks;
    // the scratch takes D and lse log2(e) for rows below S_pad
    {
      const int line = 64 * wg + t / 2, h = t % 2;
      float sum = 0.f;
#pragma unroll
      for (int j = h * (DP / 16); j < (h + 1) * (DP / 16); ++j) {
        const int at = (j / 8) * kBig + line * 128 + (j % 8) * 16;
        sum = dot8(*reinterpret_cast<const uint4*>(sdo + at),
                   *reinterpret_cast<const uint4*>(so + at), sum);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      const int row = q0 + line;
      if (h == 0) {
        sd[line] = sum;
        if (row < a.S_pad) {
          const long long at = (long long)n * a.S_pad + row;
          a.delta[at] = row < a.S ? sum : 0.f;
          a.lse2[at] = row < a.S ? a.lse[(long long)n * a.S + row] * kLog2e
                                 : __int_as_float(0x7f800000);
        }
      }
    }
    bar_sync(1 + wg, 128);
    float dd[2], l2[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r + 8 * h;
      dd[h] = sd[row - q0];
      l2[h] = row < a.S ? a.lse[(long long)n * a.S + row] * kLog2e
                        : __int_as_float(0x7f800000);
    }

    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
    const uint8_t* sqw = sq + 64 * 128 * wg;        // the warpgroup's rows
    const uint8_t* sdow = sdo + 64 * 128 * wg;
    float sc[64], dp[64];
    uint32_t ds[32];
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStagesQ;
      const int k0 = j * kKeys;
      mbar_wait(&full[s], (j / kStagesQ) & 1);
      // S = Q K^T, dP = dO V^T
      wg_fence();
      issue_ss<DP>(sc, sqw, kBig, sk + s * kTile, kBig);
      issue_ss<DP>(dp, sdow, kBig, sv + s * kTile, kBig);
      wg_commit();
      wg_wait();
      pin(sc);
      pin(dp);
      // P = exp(S / sqrt(d) - lse), masked to 0; dS = P (dP - D), as bf16
      // A fragments (register f: elements 2f, 2f + 1)
      const bool edge = k0 + kKeys > a.T || (a.causal && k0 + kKeys - 1 > row0);
#pragma unroll
      for (int f = 0; f < 32; ++f) {
        float x[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * f + e, h = (i / 2) % 2;
          const int key = k0 + 8 * (i / 4) + c0 + e;
          float p = ex2(fmaf(sc[i], a.scale_log2, -l2[h]));
          if (edge && !(key < a.T && (!a.causal || key <= r + 8 * h)))
            p = 0.f;
          x[e] = p * (dp[i] - dd[h]);
        }
        ds[f] = pack(__floats2bfloat162_rn(x[0], x[1]));
      }
      // dQ += dS K over kKeys / 16 steps of 16 keys, K MN-major
      pin(acc);
      wg_fence();
      issue_rs<kKeys / 16>(acc, ds, sk + s * kTile, kBig);
      wg_commit();
      wg_wait();
      pin(acc);
      pin(ds);
      mbar_arrive(&empty[s]);
    }
    store_rows(dq + offset(lead, a.dq), acc, a.scale, r, c0, a.S, a.D,
               a.dq[3]);
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_bwd_dkdv_sm90(const __grid_constant__ CUtensorMap kmap,
                              const __grid_constant__ CUtensorMap vmap,
                              const __grid_constant__ CUtensorMap qmap,
                              const __grid_constant__ CUtensorMap dmap,
                              __nv_bfloat16* __restrict__ dk,
                              __nv_bfloat16* __restrict__ dv, const Args a) {
  constexpr int kSlabs = DP / kSlab;
  constexpr int kKV = kSlabs * kBig;            // K or V: 128 keys
  constexpr int kQT = kSlabs * kSmall;          // a Q or dO tile: 64 rows
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  uint8_t* sk = smem;
  uint8_t* sv = sk + kKV;
  uint8_t* sq = sv + kKV;                       // kStagesKV Q tiles
  uint8_t* sdo = sq + kStagesKV * kQT;            // kStagesKV dO tiles
  float* slse = (float*)(sdo + kStagesKV * kQT);  // kStagesKV x 64 lse log2(e)
  float* sdel = slse + kStagesKV * kQRows;        // kStagesKV x 64 D
  uint64_t* bars = (uint64_t*)(sdel + kStagesKV * kQRows);
  uint64_t* kv_full = bars;                     // K and V landed
  uint64_t* full = bars + 1;                    // a Q/dO stage landed
  uint64_t* empty = bars + 1 + kStagesKV;         // a Q/dO stage consumed

  // key tile 0 (the most q tiles under a causal mask) first
  const int u = blockIdx.x % a.L.n_kv;
  const int k0 = (blockIdx.x / a.L.n_kv) * kRows;
  int kl[3];
  kv_lead(u, 0, a.L, kl);
  for (int i = 0; i < 3; ++i) kl[i] *= a.L.ki[i];
  // the 64-row q tiles the mask leaves: rows before k0 see no key here
  const int n_qt = a.S_pad / kQRows;
  const int qt_first = a.causal ? min(k0 / kQRows, n_qt) : 0;
  const int per_g = n_qt - qt_first;
  const int n_iters = a.L.G * per_g;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStagesKV; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * kKV);
      for (int c = 0; c < kSlabs; ++c) {
        tma_load(&kmap, kv_full, sk + c * kBig, c * kSlab, k0, kl);
        tma_load(&vmap, kv_full, sv + c * kBig, c * kSlab, k0, kl);
      }
      for (int it = 0; it < n_iters; ++it) {
        const int s = it % kStagesKV;
        const int q0 = (qt_first + it % per_g) * kQRows;
        int c[3];
        const int n = kv_lead(u, it / per_g, a.L, c);
        mbar_wait(&empty[s], ((it / kStagesKV) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * kQT + 2 * kQRows * 4);
        for (int cc = 0; cc < kSlabs; ++cc) {
          tma_load(&qmap, &full[s], sq + s * kQT + cc * kSmall, cc * kSlab,
                   q0, c);
          tma_load(&dmap, &full[s], sdo + s * kQT + cc * kSmall, cc * kSlab,
                   q0, c);
        }
        const long long at = (long long)n * a.S_pad + q0;
        bulk_load(slse + s * kQRows, a.lse2 + at, kQRows * 4, &full[s]);
        bulk_load(sdel + s * kQRows, a.delta + at, kQRows * 4, &full[s]);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int wg = threadIdx.x / 128 - 1;
    const int t = threadIdx.x % 128;
    const int lane = threadIdx.x % 32;
    const int key0 = k0 + 64 * wg;                   // the warpgroup's keys
    // this thread's keys in the accumulator layout: r and r + 8
    const int r = key0 + 16 * (t / 32) + lane / 4;
    const int c0 = 2 * (lane % 4);                   // and its first q row

    float dka[DP / 2], dva[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dka[i] = dva[i] = 0.f;
    const uint8_t* skw = sk + 64 * 128 * wg;
    const uint8_t* svw = sv + 64 * 128 * wg;
    float sc[32], dp[32];
    uint32_t pf[16], df[16];
    mbar_wait(kv_full, 0);
    for (int it = 0; it < n_iters; ++it) {
      const int s = it % kStagesKV;
      const int q0 = (qt_first + it % per_g) * kQRows;
      mbar_wait(&full[s], (it / kStagesKV) & 1);
      if (a.causal && q0 + kQRows - 1 < key0) {  // no row sees these keys
        mbar_arrive(&empty[s]);
        continue;
      }
      // S^T = K Q^T, dP^T = V dO^T
      wg_fence();
      issue_ss<DP>(sc, skw, kBig, sq + s * kQT, kSmall);
      issue_ss<DP>(dp, svw, kBig, sdo + s * kQT, kSmall);
      wg_commit();
      wg_wait();
      pin(sc);
      pin(dp);
      // P^T and dS^T as bf16 A fragments; column i of the accumulator is
      // q row q0 + 8 (i / 4) + c0 + i % 2
      const float* ls = slse + s * kQRows;
      const float* ds = sdel + s * kQRows;
      const bool edge = a.causal && key0 + 63 > q0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * j + c0);
        const float2 d2 = *reinterpret_cast<const float2*>(ds + 8 * j + c0);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {        // rows r, r + 8
          const int i = 4 * j + 2 * hh;
          const int key = r + 8 * hh, q = q0 + 8 * j + c0;
          float p0 = ex2(fmaf(sc[i], a.scale_log2, -l2.x));
          float p1 = ex2(fmaf(sc[i + 1], a.scale_log2, -l2.y));
          if (edge && key > q) p0 = 0.f;
          if (edge && key > q + 1) p1 = 0.f;
          pf[2 * j + hh] = pack(__floats2bfloat162_rn(p0, p1));
          df[2 * j + hh] = pack(__floats2bfloat162_rn(
              p0 * (dp[i] - d2.x), p1 * (dp[i + 1] - d2.y)));
        }
      }
      // dV += P^T dO, dK += dS^T Q over 64 q rows, dO and Q MN-major
      pin(dva);
      pin(dka);
      wg_fence();
      issue_rs<kQRows / 16>(dva, pf, sdo + s * kQT, kSmall);
      issue_rs<kQRows / 16>(dka, df, sq + s * kQT, kSmall);
      wg_commit();
      wg_wait();
      pin(dva);
      pin(dka);
      pin(pf);
      pin(df);
      mbar_arrive(&empty[s]);
    }
    store_rows(dk + offset(kl, a.dk), dka, a.scale, r, c0, a.T, a.D,
               a.dk[3]);
    store_rows(dv + offset(kl, a.dv), dva, 1.f, r, c0, a.T, a.D, a.dv[3]);
  }
}

template <int DP>
int launch(const CUtensorMap* maps, void* dq, void* dk, void* dv,
           const Args& a, cudaStream_t stream) {
  constexpr int kSlabs = DP / kSlab;
  constexpr int kSmemDq = 1024 + (3 + 2 * kStagesQ) * kSlabs * kBig +
                          (1 + 2 * kStagesQ) * 8 + kRows * 4;
  constexpr int kSmemKv = 1024 + 2 * kSlabs * kBig +
                          2 * kStagesKV * kSlabs * kSmall +
                          2 * kStagesKV * kQRows * 4 +
                          (1 + 2 * kStagesKV) * 8;
  static bool sized = false;           // raise the dynamic shared limit once
  if (!sized) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_attention_bwd_dq_sm90<DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemDq);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(flash_attention_bwd_dkdv_sm90<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemKv);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  // maps: q, k, v, o, do in 128-row boxes, then q, do in 64-row boxes
  flash_attention_bwd_dq_sm90<DP>
      <<<(unsigned)a.L.n_q * a.n_qtiles, kThreads, kSmemDq, stream>>>(
          maps[0], maps[1], maps[2], maps[3], maps[4],
          (__nv_bfloat16*)dq, a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_attention_bwd_dkdv_sm90<DP>
      <<<(unsigned)a.L.n_kv * a.n_ktiles, kThreads, kSmemKv, stream>>>(
          maps[1], maps[2], maps[5], maps[6], (__nv_bfloat16*)dk,
          (__nv_bfloat16*)dv, a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace sm90

// f32 q, k, v, o, do, dq, dk, dv.  lead: the leading sizes (n0, n1, n2);
// strides: 32 element strides, for the 8 tensors in turn those of leading
// dims 0-2 and of the row dim (k, v, dk, dv 0 where they broadcast, and
// nowhere else); lse: the forward's (n0, n1, n2, S) contiguous f32;
// scratch: n0 n1 n2 S floats (D).  D in {64, 96, 128}.  Launches the dq
// kernel then the dk/dv kernel on stream; returns a cudaError_t.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, void* dq, void* dk, void* dv,
    float* scratch, const long long* lead, const long long* strides, int S,
    int T, int D, int causal, void* stream) {
  if (D != 64 && D != 96 && D != 128) return (int)cudaErrorInvalidValue;
  if (S <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  F32Args a;
  const int kidx[3] = {strides[4] != 0, strides[5] != 0, strides[6] != 0};
  if (!make_lead(&a.L, lead, kidx) ||
      (long long)a.L.n_q * ((S + kB - 1) / kB) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  a.q = (const float*)q;
  a.k = (const float*)k;
  a.v = (const float*)v;
  a.o = (const float*)o;
  a.dout = (const float*)dout;
  a.lse = lse;
  a.dq = (float*)dq;
  a.dk = (float*)dk;
  a.dv = (float*)dv;
  a.delta = scratch;
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 4; ++i) a.st[t][i] = strides[4 * t + i];
  a.S = S;
  a.T = T;
  a.causal = causal;
  a.scale = 1.0f / sqrtf((float)D);
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 64) return (int)launch_f32<64>(a, st);
  if (D == 96) return (int)launch_f32<96>(a, st);
  return (int)launch_f32<128>(a, st);
}

// bf16 q, k, v, o, do, dq, dk, dv.  dims: 25 sizes, for the maps of q, k,
// v, o and do in turn (d, rows, leading 2, 1, 0), a broadcast dim of k or
// v of size 1; strides: 20 byte strides, per map those of its four outer
// dims (multiples of 16); lead: the leading sizes (n0, n1, n2) of q;
// out_strides: 12 element strides, of dq, dk and dv in turn their leading
// dims 0-2 and rows; lse: the forward's (n0, n1, n2, S) contiguous f32;
// scratch: 2 n0 n1 n2 S_pad floats, S_pad = S rounded up to 64.  D in
// {64, 96, 128}; every pointer 16-byte aligned.  Launches the dq kernel
// then the dk/dv kernel on stream; returns a cudaError_t.
extern "C" int flash_attention_bwd_sm90_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, void* dq, void* dk, void* dv,
    float* scratch, const long long* dims, const long long* strides,
    const long long* lead, const long long* out_strides, int S, int T,
    int D, int causal, void* stream) {
  if (D != 64 && D != 96 && D != 128) return (int)cudaErrorInvalidValue;
  if (S <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  sm90::Args a;
  int kidx[3];
  for (int i = 0; i < 3; ++i) kidx[i] = dims[5 + 4 - i] > 1;
  if (!make_lead(&a.L, lead, kidx)) return (int)cudaErrorInvalidValue;
  a.S = S;
  a.T = T;
  a.D = D;
  a.causal = causal;
  a.S_pad = (S + sm90::kQRows - 1) / sm90::kQRows * sm90::kQRows;
  a.n_qtiles = (S + sm90::kRows - 1) / sm90::kRows;
  a.n_ktiles = (T + sm90::kRows - 1) / sm90::kRows;
  if ((long long)a.L.n_q * a.n_qtiles > 0x7fffffffLL ||
      (long long)a.L.n_kv * a.n_ktiles > 0x7fffffffLL ||
      (long long)a.L.n_q * a.S_pad > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[10] = {q, k, v, o, dout, lse, dq, dk, dv, scratch};
  for (const void* p : ptrs)
    if ((uintptr_t)p % 16 != 0) return (int)cudaErrorMisalignedAddress;
  CUtensorMap maps[7];
  for (int t = 0; t < 5; ++t)
    if (!sm90::make_map(&maps[t], ptrs[t], dims + 5 * t, strides + 4 * t,
                        sm90::kRows))
      return (int)cudaErrorInvalidValue;
  for (int t = 0; t < 2; ++t) {            // q and do in 64-row boxes
    const int src = t == 0 ? 0 : 4;
    if (!sm90::make_map(&maps[5 + t], ptrs[src], dims + 5 * src,
                        strides + 4 * src, sm90::kQRows))
      return (int)cudaErrorInvalidValue;
  }
  for (int i = 0; i < 4; ++i) {
    a.dq[i] = out_strides[i];
    a.dk[i] = out_strides[4 + i];
    a.dv[i] = out_strides[8 + i];
  }
  a.lse = lse;
  a.lse2 = scratch;
  a.delta = scratch + (long long)a.L.n_q * a.S_pad;
  a.scale = 1.0f / sqrtf((float)D);
  a.scale_log2 = 1.4426950408889634f * a.scale;
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 64) return sm90::launch<64>(maps, dq, dk, dv, a, st);
  return sm90::launch<128>(maps, dq, dk, dv, a, st);
}
