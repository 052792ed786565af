// The backward pass of flash attention, for training: given q, k, v, the
// forward's output o and the output's gradient do, the gradients dq, dk
// and dv of out = softmax(q k^T / sqrt(d), causal top-left mask) v.
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
// scores s = q.k / sqrt(d) in f32, masked keys (causal: key j > row i) at
// -1e30, P = exp(s - lse) with lse the row's logsumexp, D = rowsum(do * o)
// in f32, dP = do v^T, dS = P * (dP - D), dq = dS k / sqrt(d),
// dk = dS^T q / sqrt(d), dv = P^T do.  Everything accumulates in f32; one
// cast to the inputs' type at the end.  k and v may serve G query heads
// each (grouped-query attention): dk and dv are summed over the G heads in
// f32 before the cast.
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s): the five products of
// the gradient take 10 d flops per unmasked (query, key) pair; for
// qwen3-4b at 4 x 512 that is 2.2e10 flops (0.022 ms) against 84 MB read
// and written (0.025 ms), at 1 x 4096 3.4e11 flops (0.35 ms).  This first
// design runs on scalar f32 FMAs (67 TFLOP/s at most), not the tensor
// cores, so it is bound by operations at several times that; wgmma and
// TMA are later work.  It recomputes two products beyond the five (the
// scores twice in launch A: once for lse, once for P) and P, dP again in
// launch B, so it does 16 d flops per pair.
//
// Design: deterministic, no atomics, every output written by one CTA.
// * Launch A (flash_attention_bwd_dq_kernel): one CTA of 256 threads per
//   (query head, 64-row q tile).  Pass 1 over the k tiles the mask leaves
//   recomputes each row's max and normaliser (lse).  D comes from the do
//   and o tiles.  Pass 2 recomputes P, dP and dS per k tile and adds dS k
//   into dq, held in registers.  It writes dq, and lse and D to an f32
//   scratch buffer.
// * Launch B (flash_attention_bwd_dkdv_kernel): one CTA per (kv head,
//   64-key tile).  It loops over the G query heads of its kv head and over
//   the q tiles the causal mask leaves (those at or past its keys),
//   recomputes P and dS from lse and D, and adds P^T do into dv and dS^T q
//   into dk, held in registers.  It is the only writer of its tile of dk
//   and dv.
// * Tiles are staged in shared memory as f32 (bf16 converted on load),
//   rows padded to d + 1 floats so that the 16 threads reading 16
//   different rows of one column hit 16 banks.  A thread computes a 4 x 4
//   block of each 64 x 64 product (rows ty + 16 i, columns tx + 16 j) and
//   a 4 x d/16 block of each 64 x d one.
// * Inputs are contiguous: q, o, do (n_kv * G, S, d) and k, v (n_kv, T,
//   d); the wrapper makes them so.  Ragged S and T are masked: rows past S
//   and keys past T load as zeros and take no part.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kB = 64;          // rows of a q tile and of a k tile
constexpr int kThreads = 256;   // 16 x 16: tx, ty
constexpr int kPS = kB + 1;     // padded row of a 64 x 64 tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* lse;      // (n_kv * G, S)
  float* delta;    // (n_kv * G, S)
  int n_kv, G, S, T, causal;
  float scale;     // 1 / sqrt(d)
};

// rows [row0, row0 + 64) of a (n_rows, D) matrix into a padded f32 tile;
// rows past n_rows are zeros
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int n_rows) {
  for (int i = threadIdx.x; i < kB * D; i += kThreads) {
    const int r = i / D, c = i - (i / D) * D;
    const int g = row0 + r;
    dst[r * (D + 1) + c] = g < n_rows ? to_f(src[(size_t)g * D + c]) : 0.f;
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

// reductions over the 16 threads (tx) that share a row: lanes 0-15 and
// 16-31 of a warp hold two different rows
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

// the last k tile (exclusive) that rows [q0, q0 + 64) see
__device__ __forceinline__ int k_tiles_for(int q0, const Args& a) {
  const int all = (a.T + kB - 1) / kB;
  if (!a.causal) return all;
  const int last_row = min(q0 + kB, a.S) - 1;
  return min(all, last_row / kB + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dq_kernel(Args a) {
  extern __shared__ float sm[];
  float* Qs = sm;                       // [64][D + 1]
  float* dOs = Qs + kB * (D + 1);
  float* Ks = dOs + kB * (D + 1);
  float* Vs = Ks + kB * (D + 1);
  float* dSs = Vs + kB * (D + 1);       // [64][65]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int n_qt = (a.S + kB - 1) / kB;
  const int l = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x - l * n_qt) * kB;
  const int lk = l / a.G;
  const size_t qoff = (size_t)l * a.S * D, koff = (size_t)lk * a.T * D;
  const T* q = (const T*)a.q + qoff;
  const T* o = (const T*)a.o + qoff;
  const T* dout = (const T*)a.dout + qoff;
  const T* k = (const T*)a.k + koff;
  const T* v = (const T*)a.v + koff;

  load_tile<T, D>(Qs, q, q0, a.S);
  load_tile<T, D>(dOs, dout, q0, a.S);
  load_tile<T, D>(Ks, o, q0, a.S);      // o, for D only
  __syncthreads();
  float delta[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float s = 0.f;
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      s = fmaf(dOs[r * (D + 1) + tx + 16 * j], Ks[r * (D + 1) + tx + 16 * j],
               s);
    delta[i] = row_sum(s);
  }

  const int n_kt = k_tiles_for(q0, a);
  // pass 1: each row's max and normaliser
  float m[4], lsum[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    lsum[i] = 0.f;
  }
  float s[4][4];
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();
    load_tile<T, D>(Ks, k, kt * kB, a.T);
    __syncthreads();
    dot_tile<D>(s, Qs, Ks, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = kt * kB + tx + 16 * j;
        const bool ok = key < a.T && (!a.causal || key <= row);
        s[i][j] = ok ? s[i][j] * a.scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max(mx);
      const float mn = fmaxf(m[i], mx);
      // every lane of the warp reaches each shuffle; a row that has seen
      // no key yet keeps m = -inf and lsum = 0 (base 0: exp(-inf) = 0)
      const float base = mn == -INFINITY ? 0.f : mn;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += expf(s[i][j] - base);
      lsum[i] = lsum[i] * expf(m[i] - base) + row_sum(sum);
      m[i] = mn;
    }
  }
  float lse[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lse[i] = m[i] + logf(lsum[i]);
    const int row = q0 + ty + 16 * i;
    if (tx == 0 && row < a.S) {
      a.lse[(size_t)l * a.S + row] = lse[i];
      a.delta[(size_t)l * a.S + row] = delta[i];
    }
  }

  // pass 2: dq += dS k
  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;
  float dp[4][4];
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();
    load_tile<T, D>(Ks, k, kt * kB, a.T);
    load_tile<T, D>(Vs, v, kt * kB, a.T);
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
  T* dq = (T*)a.dq + qoff;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.S) continue;
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      dq[(size_t)row * D + tx + 16 * j] = from_f<T>(acc[i][j] * a.scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dkdv_kernel(Args a) {
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
  const int lk = blockIdx.x / n_kt;
  const int k0 = (blockIdx.x - lk * n_kt) * kB;
  const size_t koff = (size_t)lk * a.T * D;
  load_tile<T, D>(Ks, (const T*)a.k + koff, k0, a.T);
  load_tile<T, D>(Vs, (const T*)a.v + koff, k0, a.T);

  float dk[4][D / 16], dv[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) dk[i][j] = dv[i][j] = 0.f;
  const int n_qt = (a.S + kB - 1) / kB;
  const int qt0 = a.causal ? k0 / kB : 0;   // rows before k0 see no key here
  float s[4][4], dp[4][4];
  for (int g = 0; g < a.G; ++g) {
    const int l = lk * a.G + g;
    const size_t qoff = (size_t)l * a.S * D;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * kB;
      __syncthreads();
      load_tile<T, D>(Qs, (const T*)a.q + qoff, q0, a.S);
      load_tile<T, D>(dOs, (const T*)a.dout + qoff, q0, a.S);
      if (threadIdx.x < kB) {
        const int row = q0 + threadIdx.x;
        lse_s[threadIdx.x] = row < a.S ? a.lse[(size_t)l * a.S + row] : 0.f;
        delta_s[threadIdx.x] =
            row < a.S ? a.delta[(size_t)l * a.S + row] : 0.f;
      }
      __syncthreads();
      dot_tile<D>(s, Qs, Ks, ty, tx);     // rows: queries, columns: keys
      dot_tile<D>(dp, dOs, Vs, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i, row = q0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j, key = k0 + c;
          const bool ok = row < a.S && key < a.T && (!a.causal || key <= row);
          const float p = ok ? expf(s[i][j] * a.scale - lse_s[r]) : 0.f;
          Ps[r * kPS + c] = p;
          dSs[r * kPS + c] = p * (dp[i][j] - delta_s[r]);
        }
      }
      __syncthreads();
      // rows of dk, dv are keys: X(key, q) = P[q][key]
      acc_tile<D>(dv, Ps, 1, kPS, dOs, ty, tx);
      acc_tile<D>(dk, dSs, 1, kPS, Qs, ty, tx);
    }
  }
  T* dkp = (T*)a.dk + koff;
  T* dvp = (T*)a.dv + koff;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= a.T) continue;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      dkp[(size_t)key * D + tx + 16 * j] = from_f<T>(dk[i][j] * a.scale);
      dvp[(size_t)key * D + tx + 16 * j] = from_f<T>(dv[i][j]);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t tile = (size_t)kB * (D + 1) * sizeof(float);
  const size_t smem_a = 4 * tile + (size_t)kB * kPS * sizeof(float);
  const size_t smem_b = 4 * tile + 2 * (size_t)kB * kPS * sizeof(float) +
                        2 * kB * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_bwd_dq_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(flash_attention_bwd_dkdv_kernel<T, D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_b);
  if (e != cudaSuccess) return e;
  const long long n_q = (long long)a.n_kv * a.G;
  const long long grid_a = n_q * ((a.S + kB - 1) / kB);
  const long long grid_b = (long long)a.n_kv * ((a.T + kB - 1) / kB);
  flash_attention_bwd_dq_kernel<T, D>
      <<<(unsigned)grid_a, kThreads, smem_a, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_attention_bwd_dkdv_kernel<T, D>
      <<<(unsigned)grid_b, kThreads, smem_b, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const Args& a, int D, cudaStream_t stream) {
  if (D == 64) return launch<T, 64>(a, stream);
  if (D == 96) return launch<T, 96>(a, stream);
  return launch<T, 128>(a, stream);
}

}  // namespace

// q, o, dout, dq: (n_kv * G, S, D); k, v, dk, dv: (n_kv, T, D); all
// contiguous, of one dtype (bf16 when bf16 != 0, else f32).  scratch holds
// 2 * n_kv * G * S floats (lse, then D).  Launches A then B on stream.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, float* scratch, int n_kv,
    int G, int S, int T, int D, int causal, int bf16, void* stream) {
  if (D != 64 && D != 96 && D != 128) return (int)cudaErrorInvalidValue;
  if (n_kv <= 0 || G <= 0 || S <= 0 || T <= 0)
    return (int)cudaErrorInvalidValue;
  const long long n_q = (long long)n_kv * G;
  if (n_q * ((S + kB - 1) / kB) > 0x7fffffffLL ||
      (long long)n_kv * ((T + kB - 1) / kB) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.lse = scratch;
  a.delta = scratch + n_q * S;
  a.n_kv = n_kv;
  a.G = G;
  a.S = S;
  a.T = T;
  a.causal = causal;
  a.scale = 1.0f / sqrtf((float)D);
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) return (int)launch_d<__nv_bfloat16>(a, D, st);
  return (int)launch_d<float>(a, D, st);
}
