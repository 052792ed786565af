// Hopper building blocks shared by the tensor-core flash kernels
// (csrc/flash_attention.cu, csrc/flash_attention_bwd.cu): mbarriers, TMA
// loads, 128-byte-swizzle wgmma descriptors, the wgmma forms the kernels
// issue, and the host's tensor-map encoder.
//
// Tiles live in shared memory as TMA writes them: each row's 64-column
// slab (kSlab bf16, 128 bytes) in the 128-byte swizzle, a slab of R rows
// R x 128 bytes, the slabs of a wider row one after the other.  Such a
// tile is K-major for a product over its columns and MN-major for one
// over its rows.
#pragma once
#include <cstdint>
#include <cuda.h>          // CUtensorMap and its enums; no -lcuda needed
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace sm90 {

constexpr int kSlab = 64;                 // bf16 columns per 128-byte row

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

// Initialises the barriers of a CTA (thread 0 calls it before the CTA's
// first __syncthreads) and makes them visible to the async proxy.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
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

// A contiguous copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from device memory into shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Waits for the `count` threads of named barrier `id` (1-15; 0 is
// __syncthreads), e.g. the 128 of one warpgroup.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(count) : "memory");
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

// SS: d (64 x N f32) = or += A (64 x 16, shared) B^T (N x 16, shared), both
// K-major; N = 128 (64 registers) or 64 (32).
__device__ __forceinline__ void mma_ss(float (&d)[64], uint64_t a,
                                       uint64_t b, int accumulate) {
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
               " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
               R64 "}, %64, %65, p, 1, 1, 0, 0;\n}"
               : F16(0), F16(16), F16(32), F16(48)
               : "l"(a), "l"(b), "r"(accumulate));
}
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a,
                                       uint64_t b, int accumulate) {
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
               " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
               R32 "}, %32, %33, p, 1, 1, 0, 0;\n}"
               : F16(0), F16(16)
               : "l"(a), "l"(b), "r"(accumulate));
}

// RS: d (64 x N f32) += A (64 x 16, registers) B (16 x N, shared,
// MN-major); N = 128 or 64.
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

// acc (64 x N) = A B^T over DP columns, not waited for: DP / 16 SS steps.
// a and b are the first slabs of two tiles (A: 64 rows, B: N rows), each
// tile's slabs a_slab / b_slab bytes apart.
template <int DP, int M>
__device__ __forceinline__ void issue_ss(float (&acc)[M], const uint8_t* a,
                                         int a_slab, const uint8_t* b,
                                         int b_slab) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int col = (kk % 4) * 32;
    mma_ss(acc, desc_sw128(a + (kk / 4) * a_slab + col, 16, 1024),
           desc_sw128(b + (kk / 4) * b_slab + col, 16, 1024), kk > 0);
  }
}

// acc (64 x N) += A B over 16 KS rows of b, not waited for: A in register
// fragments (4 per 16 rows), B a tile of those rows whose slabs (of 64
// columns, N = 64 per slab) lie b_slab bytes apart.
template <int KS, int M>
__device__ __forceinline__ void issue_rs(float (&acc)[M], const uint32_t* a,
                                         const uint8_t* b, int b_slab) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    mma_rs(acc, a + 4 * kk, desc_sw128(b + kk * 16 * 128, b_slab, 1024));
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, found through the runtime, so a
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
// four outer dims, read in boxes of 64 columns x box_rows rows, 128-byte
// swizzle, zero fill out of bounds.
static bool make_map(CUtensorMap* map, const void* ptr,
                     const long long* dims, const long long* strides,
                     int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t gdim[5], gstride[4];
  for (int i = 0; i < 5; ++i) gdim[i] = (cuuint64_t)dims[i];
  for (int i = 0; i < 4; ++i) gstride[i] = (cuuint64_t)strides[i];
  const cuuint32_t box[5] = {kSlab, (cuuint32_t)box_rows, 1, 1, 1};
  const cuuint32_t step[5] = {1, 1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(ptr),
            gdim, gstride, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90
