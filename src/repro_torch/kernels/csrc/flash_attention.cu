// Blocked attention with an online softmax (flash attention), for the LM's
// prefill: out = softmax(q k^T / sqrt(d), causal top-left mask) v, in f32,
// written in q's type.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py
// (flash_attention / _kernel), which the reference batches over batch and
// heads with vmap in kernels/ops.py; it computes the contract of
// ref.flash_attention_ref: f32 scores divided by sqrt(d), masked keys at
// -1e30, softmax and P.V in f32, one cast at the end.
//
// Layout: every tensor is read and written through its strides (in
// elements; the head dim is contiguous).  The leading index n of q and out
// runs over up to three dims (n0, n1, n2); k and v carry a stride per dim,
// 0 where they broadcast, so under grouped-query attention the query heads
// of one kv head read that head from memory without an expanded copy, and
// the model hands over views of its (B, S, heads, d) tensors unchanged.
//
// Bound on the H100: at the serving shape (4 x 32 heads x 512 x 128 bf16,
// causal) 8.6e9 flops against about 42 MB of traffic, so by the card's bf16
// tensor rate it is bound by bytes.  This first kernel runs on the CUDA
// cores in scalar f32 FMAs, so in practice it is bound by FMA issue and
// shared-memory reads; wgmma and TMA are a later redesign.
//
// Design: one launch covers every (batch, head).  One CTA of 256 threads
// takes 64 query rows of one head; 4 threads share a row, each holding a
// quarter of the head dim (interleaved float4 groups, so the 4 lanes read
// 64 contiguous bytes of shared memory and the 8 rows of a warp share them
// by broadcast) of q and of the f32 accumulator in registers.  K and V
// tiles of 32 keys are converted to f32 and staged in shared memory; per
// tile each row takes its 32 scores (partial dots joined by two xor
// shuffles), rescales its running max, normaliser and accumulator once,
// then adds P.V.  Causal tiles past the CTA's last row are never loaded,
// as _kernel's n_iter skips them.  Ragged S and T are masked: rows past S
// compute on a clamped row and store nothing, keys past T score -1e30.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&a);
  raw.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
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
  const T* qp = q + i0 * lay.q[0] + i1 * lay.q[1] + i2 * lay.q[2] +
                min(s, S - 1) * lay.q[3];
  const T* kp = k + i0 * lay.k[0] + i1 * lay.k[1] + i2 * lay.k[2];
  const T* vp = v + i0 * lay.v[0] + i1 * lay.v[1] + i2 * lay.v[2];

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
    T* op = out + i0 * lay.o[0] + i1 * lay.o[1] + i2 * lay.o[2] +
            s * lay.o[3];
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const float4 a = acc[g];
      store4(op + 4 * (lane + kLanes * g),
             make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv));
    }
  }
}

template <typename T>
static void launch(const void* q, const void* k, const void* v, void* out,
                   const Layout& lay, long long n_q, int S, int n_keys,
                   int D, int causal, cudaStream_t stream) {
  const int n_qtiles = (S + kBQ - 1) / kBQ;
  const dim3 grid((unsigned)(n_q * n_qtiles));
  const float sqrt_d = sqrtf((float)D);
  const T* qq = (const T*)q;
  const T* kk = (const T*)k;
  const T* vv = (const T*)v;
  T* oo = (T*)out;
  if (D == 64)
    flash_attention_kernel<T, 64><<<grid, kThreads, 0, stream>>>(
        qq, kk, vv, oo, lay, S, n_keys, n_qtiles, causal, sqrt_d);
  else if (D == 96)
    flash_attention_kernel<T, 96><<<grid, kThreads, 0, stream>>>(
        qq, kk, vv, oo, lay, S, n_keys, n_qtiles, causal, sqrt_d);
  else
    flash_attention_kernel<T, 128><<<grid, kThreads, 0, stream>>>(
        qq, kk, vv, oo, lay, S, n_keys, n_qtiles, causal, sqrt_d);
}

// dims: the leading sizes (n0, n1, n2); strides: 16 element strides, for
// q, k, v and out in turn those of leading dims 0-2 and of the row dim (k
// and v 0 where they broadcast): q and out (n0, n1, n2, S, D), k and v
// (n0, n1, n2, n_keys, D) as broadcast.  D in {64, 96, 128}; every stride
// a multiple of 4 and every pointer 16-byte aligned; bf16: 1 for
// __nv_bfloat16, 0 for float.  Returns cudaGetLastError().
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out,
                                      const long long* dims,
                                      const long long* strides, int S,
                                      int n_keys, int D, int causal,
                                      int bf16, void* stream) {
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
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    launch<__nv_bfloat16>(q, k, v, out, lay, n_q, S, n_keys, D, causal, s);
  else
    launch<float>(q, k, v, out, lay, n_q, S, n_keys, D, causal, s);
  return (int)cudaGetLastError();
}
