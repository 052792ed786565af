// Exact semi-join membership: is each probe key among the build keys?
//
// Replaces the Pallas kernel src/repro/kernels/sip_probe.py
// (semijoin_probe / _kernel): keys (nb, B) int32, build (S,) int32 with
// S <= 4096 -> bool (nb, B).  The wrapper pads the build side with -1 to a
// multiple of 128 exactly as the reference wrapper does, so a probe key of
// -1 is a member whenever S % 128 != 0; the kernel sees the padded side.
//
// Bound on the H100: bytes -- the membership function needs one read of
// the keys and the build side and one bool write; the kernel's B x S
// compares are the TPU design's, kept for this first port.  Design: the
// build side (16 KB at most) is staged into shared memory by every CTA;
// each thread holds kKeys probe keys in registers (strided by blockDim, so
// loads and stores coalesce) and compares them with every build entry.  All
// lanes of a warp read the same build entry at once, a shared-memory
// broadcast, and each entry read serves kKeys compares.  A sorted build
// side with a binary search would do O(log S) work per key; that is a
// later change.
#include <cstdint>
#include <cuda_runtime.h>

constexpr int kThreads = 256;
constexpr int kKeys = 4;
constexpr int kMaxBuild = 4096;

__global__ void semijoin_probe_kernel(const int32_t* __restrict__ keys,
                                      long long n_keys,
                                      const int32_t* __restrict__ build,
                                      int n_build, bool* __restrict__ out) {
  __shared__ int32_t sb[kMaxBuild];
  for (int j = threadIdx.x; j < n_build; j += blockDim.x) sb[j] = build[j];
  __syncthreads();
  const long long tile = (long long)blockDim.x * kKeys;
  for (long long base = blockIdx.x * tile; base < n_keys;
       base += (long long)gridDim.x * tile) {
    int32_t k[kKeys];
    bool hit[kKeys];
#pragma unroll
    for (int u = 0; u < kKeys; ++u) {
      const long long i = base + u * blockDim.x + threadIdx.x;
      k[u] = i < n_keys ? keys[i] : 0;
      hit[u] = false;
    }
    for (int j = 0; j < n_build; ++j) {
      const int32_t b = sb[j];
#pragma unroll
      for (int u = 0; u < kKeys; ++u) hit[u] |= k[u] == b;
    }
#pragma unroll
    for (int u = 0; u < kKeys; ++u) {
      const long long i = base + u * blockDim.x + threadIdx.x;
      if (i < n_keys) out[i] = hit[u];
    }
  }
}

extern "C" int semijoin_probe_launch(const void* keys, long long n_keys,
                                     const void* build, int n_build,
                                     void* out, void* stream) {
  if (n_build < 0 || n_build > kMaxBuild) return (int)cudaErrorInvalidValue;
  if (n_keys == 0) return (int)cudaGetLastError();
  const long long tile = (long long)kThreads * kKeys;
  long long blocks = (n_keys + tile - 1) / tile;
  if (blocks > 132LL * 32) blocks = 132LL * 32;   // grid-stride beyond this
  semijoin_probe_kernel<<<(unsigned)blocks, kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const int32_t*)keys, n_keys, (const int32_t*)build, n_build,
      (bool*)out);
  return (int)cudaGetLastError();
}
