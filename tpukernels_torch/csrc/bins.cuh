// Private histogram bins of one block, shared by csrc/histogram.cu and
// the fused scan + histogram (csrc/scan.cuh, csrc/scan_histogram.cu).
//
// The TPU kernels keep one output block resident in VMEM across their
// sequential grid and add each grid step's counts into it. CUDA blocks
// run in parallel, so each block counts into its own int32 bins in
// shared memory with shared atomics, and adds each nonzero bin into the
// global histogram with one atomic when it is done. Counts are exact:
// every atomic is an integer add.
#pragma once

#include "common.cuh"

// Bins a block keeps in shared memory: 32768 int32 = 128 KB of the
// 227 KB a block may have. Above 48 KB the kernel's dynamic
// shared-memory limit is raised (tpkt_allow_smem). A histogram with more
// bins than this is counted with global atomics directly.
constexpr int TPKT_SMEM_BINS = 32768;

// One value into the bins. The unsigned compare drops negative values
// and values >= nbins with one test.
__device__ __forceinline__ void tpkt_bin_count(unsigned* bins, unsigned v,
                                               unsigned nbins) {
  if (v < nbins) atomicAdd(bins + v, 1u);
}

__device__ __forceinline__ void tpkt_bins_zero(unsigned* bins, int nbins) {
  for (int b = threadIdx.x; b < nbins; b += blockDim.x) bins[b] = 0;
}

// Adds the block's bins into the global histogram; the caller has
// synchronised the block after its last count.
__device__ __forceinline__ void tpkt_bins_merge(const unsigned* bins,
                                                unsigned* out, int nbins) {
  for (int b = threadIdx.x; b < nbins; b += blockDim.x) {
    const unsigned c = bins[b];
    if (c) atomicAdd(out + b, c);
  }
}

template <typename Kernel>
static cudaError_t tpkt_allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}
