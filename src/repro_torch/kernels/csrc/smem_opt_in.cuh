// Dynamic shared memory past the 48 KB default, opted in once per device.
//
// The opt-in (cudaFuncSetAttribute) is a property of the function on the
// device that is current when it is made, so a flag kept once per process
// would leave every other card at the default and its first launch would be
// refused.  A launcher keeps one bit per device (devices 0-63; a higher index
// opts in on every call) and calls this before each launch; the wrappers run
// every launch under ``torch.cuda.device`` of its tensors.
#pragma once

#include <atomic>

#include <cuda_runtime.h>

template <typename Kernel>
static cudaError_t opt_in_smem(std::atomic<unsigned long long>& done,
                               Kernel* kernel, int bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev >= 0 && dev < 64 ? 1ULL << dev : 0;
  if (bit && (done.load(std::memory_order_acquire) & bit)) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_acq_rel);
  return e;
}
