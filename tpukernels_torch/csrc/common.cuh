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
