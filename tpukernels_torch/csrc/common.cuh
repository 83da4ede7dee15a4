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
#include <mutex>

#include <cuda_runtime.h>

#define TPKT_EXPORT extern "C" __attribute__((visibility("default")))

static inline long long tpkt_cdiv(long long a, long long b) {
  return (a + b - 1) / b;
}

static inline bool tpkt_aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Above 48 KB a block gets dynamic shared memory only on request.
template <typename Kernel>
static cudaError_t tpkt_allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// What a launch would otherwise ask the runtime on every call is kept per
// device (the first TPKT_MAX_DEVICES; a device past them is asked every
// time). One memo per kernel instantiation: a function-local static of
// the templated launch function.
constexpr int TPKT_MAX_DEVICES = 64;

// The most dynamic shared memory already granted to one kernel.
struct TpktSmemMemo {
  std::mutex mu;
  size_t granted[TPKT_MAX_DEVICES] = {};
};

// tpkt_allow_smem, made once per device and size: the request holds for
// the device it was made on.
template <typename Kernel>
static cudaError_t tpkt_allow_smem_once(Kernel kernel, size_t bytes,
                                        TpktSmemMemo& memo) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const bool kept = dev >= 0 && dev < TPKT_MAX_DEVICES;
  if (kept) {
    std::lock_guard<std::mutex> lock(memo.mu);
    if (memo.granted[dev] >= bytes) return cudaSuccess;
  }
  e = tpkt_allow_smem(kernel, bytes);
  if (e == cudaSuccess && kept) {
    std::lock_guard<std::mutex> lock(memo.mu);
    if (memo.granted[dev] < bytes) memo.granted[dev] = bytes;
  }
  return e;
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

// The resident grid last computed for one kernel on each device.
struct TpktGridMemo {
  struct Entry {
    bool set;
    size_t smem;
    int cap;
    long long blocks;
  };
  std::mutex mu;
  Entry dev[TPKT_MAX_DEVICES] = {};
};

// tpkt_allow_smem and tpkt_resident_blocks for the current device, asked
// of the runtime once per (device, smem, cap) and answered from `memo`
// after that.
template <typename Kernel>
static cudaError_t tpkt_resident_grid(Kernel kernel, TpktGridMemo& memo,
                                      int threads, size_t smem, int cap,
                                      long long* blocks) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const bool kept = dev >= 0 && dev < TPKT_MAX_DEVICES;
  if (kept) {
    std::lock_guard<std::mutex> lock(memo.mu);
    const TpktGridMemo::Entry& m = memo.dev[dev];
    if (m.set && m.smem == smem && m.cap == cap) {
      *blocks = m.blocks;
      return cudaSuccess;
    }
  }
  e = tpkt_allow_smem(kernel, smem);
  if (e == cudaSuccess)
    e = tpkt_resident_blocks(kernel, threads, smem, cap, blocks);
  if (e == cudaSuccess && kept) {
    std::lock_guard<std::mutex> lock(memo.mu);
    memo.dev[dev] = TpktGridMemo::Entry{true, smem, cap, *blocks};
  }
  return e;
}
