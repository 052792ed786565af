// Exact semi-join membership: is each probe key among the build keys?
//
// Replaces the Pallas kernel src/repro/kernels/sip_probe.py
// (semijoin_probe / _kernel): keys (nb, B) int32, build (S,) int32 with
// S <= 4096 -> bool (nb, B).  The reference pads the build side with -1 to
// a multiple of 128, so a probe key of -1 is a member whenever
// S % 128 != 0; the wrapper passes that as the flag minus_one_member and
// hands over the unpadded build side.  Any int32 is a key on both sides.
//
// Bound on the H100: bytes -- one read of the keys and the build side and
// one bool write per key.  The TPU kernel compared every probe key with
// every build key (B x S compares, 2e9 a call at phase 5's shape); here
// membership costs O(1) a key.  Design: an open-addressing hash set of the
// build side in shared memory, kSlots int32 slots (64 KB of dynamic shared
// memory) for at most kMaxBuild keys, so the load stays at or below 0.25
// and a miss reads about 1.4 slots, a hit 1.2.  (At 8,192 slots, load 0.5,
// the inserts' CAS retries made a CTA's build about twice as long: PERF.md
// §6.)  The slot is murmur3's fmix32 of the key, which mixes every bit (a
// build side of multiples of kSlots still spreads); linear probing until
// the key or an empty slot.  kEmpty marks an empty slot: a build key equal
// to it sets has_empty instead of entering the table, and a probe key
// equal to it answers from that flag.  Inserts claim a slot with
// atomicCAS; a duplicate stops at its equal slot.
//
// A persistent grid of one CTA of kThreads per SM: each CTA builds its own
// set (kMaxBuild / kThreads = 4 inserts a thread), then probes a
// grid-stride share of the keys, four keys per 16-byte load and one 4-byte
// store of their four bools.  (A set built once into global memory and
// copied from L2 by every CTA was slower: PERF.md §6.)  The set is dynamic
// shared memory (sizeof(HashSet), past the 48 KB a kernel gets without
// asking).
#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

constexpr int kThreads = 1024;
constexpr int kMaxBuild = 4096;
constexpr int kSlots = 16384;                // load <= kMaxBuild / kSlots
constexpr uint32_t kMask = kSlots - 1;
constexpr int32_t kEmpty = INT32_MIN;        // an empty slot
constexpr int kInserts = kMaxBuild / kThreads;

struct HashSet {
  int32_t slots[kSlots];
  int32_t has_empty;        // a build key equal to kEmpty was seen
};

__device__ __forceinline__ HashSet& shared_set() {
  extern __shared__ __align__(16) unsigned char smem[];
  return *reinterpret_cast<HashSet*>(smem);
}

__device__ __forceinline__ uint32_t slot_of(int32_t key) {
  uint32_t h = (uint32_t)key;                // murmur3's fmix32
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h & kMask;
}

__device__ __forceinline__ void insert(HashSet& t, int32_t key) {
  if (key == kEmpty) {
    t.has_empty = 1;
    return;
  }
  uint32_t s = slot_of(key);
  for (;;) {
    // a stale read of kEmpty only costs a CAS, which returns the truth;
    // a slot once claimed never changes
    int32_t v = t.slots[s];
    if (v == kEmpty) {
      v = atomicCAS(&t.slots[s], kEmpty, key);
      if (v == kEmpty) return;               // claimed
    }
    if (v == key) return;                    // a duplicate
    s = (s + 1) & kMask;
  }
}

__device__ __forceinline__ bool member(const HashSet& t, int32_t key,
                                       bool minus_one_member) {
  if (key == kEmpty) return t.has_empty != 0;
  if (key == -1 && minus_one_member) return true;
  uint32_t s = slot_of(key);
  for (;;) {       // ends: at most kMaxBuild of the kSlots slots are full
    const int32_t v = t.slots[s];
    if (v == key) return true;
    if (v == kEmpty) return false;
    s = (s + 1) & kMask;
  }
}

// Every slot empty, then the build keys in: kInserts loads a thread, all
// issued before the first insert.
__device__ __forceinline__ void build_set(HashSet& t,
                                          const int32_t* __restrict__ build,
                                          int n_build) {
  int4* s4 = reinterpret_cast<int4*>(t.slots);
  for (int j = threadIdx.x; j < kSlots / 4; j += blockDim.x)
    s4[j] = make_int4(kEmpty, kEmpty, kEmpty, kEmpty);
  if (threadIdx.x == 0) t.has_empty = 0;
  int32_t b[kInserts];
#pragma unroll
  for (int u = 0; u < kInserts; ++u) {
    const int j = u * kThreads + threadIdx.x;
    b[u] = j < n_build ? build[j] : 0;
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kInserts; ++u)
    if (u * kThreads + (int)threadIdx.x < n_build) insert(t, b[u]);
  __syncthreads();
}

// A grid-stride pass over the keys: four keys per 16-byte load and one
// 4-byte store of their bools where both pointers allow it, else one key
// at a time.
__device__ __forceinline__ void probe_keys(const HashSet& t,
                                           const int32_t* __restrict__ keys,
                                           long long n_keys,
                                           bool minus_one_member,
                                           bool* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (((reinterpret_cast<uintptr_t>(keys) & 15) |
       (reinterpret_cast<uintptr_t>(out) & 3)) == 0) {
    const long long n_quads = n_keys / 4;
    const int4* k4 = reinterpret_cast<const int4*>(keys);
    uint32_t* o4 = reinterpret_cast<uint32_t*>(out);
    for (long long q = tid; q < n_quads; q += stride) {
      const int4 k = k4[q];
      o4[q] = (uint32_t)member(t, k.x, minus_one_member)
              | (uint32_t)member(t, k.y, minus_one_member) << 8
              | (uint32_t)member(t, k.z, minus_one_member) << 16
              | (uint32_t)member(t, k.w, minus_one_member) << 24;
    }
    done = n_quads * 4;
  }
  for (long long i = done + tid; i < n_keys; i += stride)
    out[i] = member(t, keys[i], minus_one_member);
}

__global__ void __launch_bounds__(kThreads, 1)
semijoin_probe_kernel(const int32_t* __restrict__ keys, long long n_keys,
                      const int32_t* __restrict__ build, int n_build,
                      int minus_one_member, bool* __restrict__ out) {
  HashSet& t = shared_set();
  build_set(t, build, n_build);
  probe_keys(t, keys, n_keys, minus_one_member != 0, out);
}

// The SM count, and the kernel's dynamic shared memory allowed, once per
// device.
static int prepare_device() {
  static int sms[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 0;
  if (sms[dev] == 0) {
    cudaFuncSetAttribute(semijoin_probe_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)sizeof(HashSet));
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    sms[dev] = n < 1 ? 1 : n;
  }
  return sms[dev];
}

extern "C" int semijoin_probe_launch(const void* keys, long long n_keys,
                                     const void* build, int n_build,
                                     int minus_one_member, void* out,
                                     void* stream) {
  if (n_build < 0 || n_build > kMaxBuild) return (int)cudaErrorInvalidValue;
  if (n_keys == 0) return (int)cudaGetLastError();
  const int sms = prepare_device();
  if (sms == 0) return (int)cudaErrorInvalidDevice;
  const long long per_cta = 4LL * kThreads;        // one quad a thread
  long long blocks = (n_keys + per_cta - 1) / per_cta;
  if (blocks > sms) blocks = sms;                  // grid-stride beyond
  semijoin_probe_kernel<<<(unsigned)blocks, kThreads, sizeof(HashSet),
                          (cudaStream_t)stream>>>(
      (const int32_t*)keys, n_keys, (const int32_t*)build, n_build,
      minus_one_member, (bool*)out);
  return (int)cudaGetLastError();
}
