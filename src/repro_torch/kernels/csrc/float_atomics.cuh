// Atomic min / max of a float in device memory, shared by the kernels.
//
// The ordered-int trick: non-negative floats order like their int bits
// (atomicMin/Max on int), negative floats order inversely as unsigned bits
// (atomicMax/Min on unsigned).  The sign bit, not v >= 0, picks the branch,
// so -0.0 takes the negative side and orders below +0.0.
#pragma once
#include <cuda_runtime.h>

__device__ __forceinline__ void atomic_min_f32(float* addr, float v) {
  if (!(__float_as_uint(v) >> 31)) atomicMin((int*)addr, __float_as_int(v));
  else atomicMax((unsigned int*)addr, __float_as_uint(v));
}

__device__ __forceinline__ void atomic_max_f32(float* addr, float v) {
  if (!(__float_as_uint(v) >> 31)) atomicMax((int*)addr, __float_as_int(v));
  else atomicMin((unsigned int*)addr, __float_as_uint(v));
}
