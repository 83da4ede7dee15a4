// Shared helpers of the port's hand-written Hopper kernels.
//
// Every source in this directory is built on its own by
// tpukernels_torch/_build.py into a shared library with a plain C
// interface (nvcc -gencode arch=compute_90a,code=sm_90a ... -shared).
// An entry point takes raw device pointers and the caller's
// cudaStream_t, launches, and returns cudaGetLastError() so the Python
// wrapper can raise on a refused launch. Kernels never allocate and
// never synchronise.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define TPKT_EXPORT extern "C" __attribute__((visibility("default")))

static inline long long tpkt_cdiv(long long a, long long b) {
  return (a + b - 1) / b;
}

static inline bool tpkt_aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Blocks of `kernel` the current device holds at once (`threads` a
// block, `smem` bytes of dynamic shared memory), at most `cap` a SM when
// cap > 0: the grid of a kernel whose blocks loop over the work.
template <typename Kernel>
static cudaError_t tpkt_resident_blocks(Kernel kernel, int threads,
                                        size_t smem, int cap,
                                        long long* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) per_sm = 1;  // the launch then reports what does not fit
  if (cap > 0 && per_sm > cap) per_sm = cap;
  *blocks = static_cast<long long>(sms) * per_sm;
  return cudaSuccess;
}
