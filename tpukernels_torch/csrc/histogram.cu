// Histogram: counts of the int32 values of x that lie in [0, nbins).
//
// Replaces both TPU kernels of tpukernels/kernels/histogram.py:
// _hist_mxu_kernel (nbins <= 256: hi/lo nibble one-hot matmuls on the
// MXU, which a TPU uses because it has no scatter worth using) and
// _hist_kernel (any nbins: a broadcast compare per (element, bin)). On a
// GPU shared-memory atomics are cheap, so one kernel does both: a
// grid-stride loop of 16-byte loads, each value counted into the block's
// private bins (bins.cuh) and merged once per block into scratch bins,
// which the last block to finish moves to the output and leaves zero, so
// the output needs no fill launch. About two blocks a SM keep the merge
// near 264 * nbins atomics. Above TPKT_SMEM_BINS bins the same loop
// counts with global atomics into the output, which the caller zeroed.
//
// Bound on the card: bytes, 4 per element read; the merge adds
// blocks * nbins atomics, and one value repeated everywhere serialises
// the shared atomics on one address.
#include "bins.cuh"

constexpr int kHistThreads = 512;
constexpr int kUnroll = 4;  // 16-byte loads in flight a thread

// SHARED: acc is nbins zeroed scratch bins and count a zeroed word, both
// left zero; out is written whole. Otherwise out starts zeroed.
template <bool SHARED>
__global__ void __launch_bounds__(kHistThreads)
    histogram_kernel(const int* __restrict__ x, long long n, long long n4,
                     unsigned* __restrict__ out, unsigned* acc,
                     unsigned* count, int nbins) {
  extern __shared__ unsigned s_bins[];
  __shared__ bool s_last;
  unsigned* bins = SHARED ? s_bins : out;
  if (SHARED) {
    tpkt_bins_zero(s_bins, nbins);
    __syncthreads();
  }
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const uint4* x4 = reinterpret_cast<const uint4*>(x);
  long long i = tid;
  for (; i + (kUnroll - 1) * stride < n4; i += kUnroll * stride) {
    uint4 q[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) q[u] = x4[i + u * stride];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      tpkt_bin_count(bins, q[u].x, nbins);
      tpkt_bin_count(bins, q[u].y, nbins);
      tpkt_bin_count(bins, q[u].z, nbins);
      tpkt_bin_count(bins, q[u].w, nbins);
    }
  }
  for (; i < n4; i += stride) {
    const uint4 q = x4[i];
    tpkt_bin_count(bins, q.x, nbins);
    tpkt_bin_count(bins, q.y, nbins);
    tpkt_bin_count(bins, q.z, nbins);
    tpkt_bin_count(bins, q.w, nbins);
  }
  for (long long j = 4 * n4 + tid; j < n; j += stride)
    tpkt_bin_count(bins, static_cast<unsigned>(x[j]), nbins);
  if (SHARED) {
    __syncthreads();
    tpkt_bins_merge(s_bins, acc, nbins);
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      s_last = atomicAdd(count, 1u) == gridDim.x - 1;
      __threadfence();
    }
    __syncthreads();
    if (s_last) {
      tpkt_bins_move(acc, out, nbins);
      if (threadIdx.x == 0) *count = 0;
    }
  }
}

template <bool SHARED>
static int launch(const int* x, long long n, unsigned* out,
                  unsigned* scratch, int nbins, int blocks_per_sm,
                  void* stream) {
  static TpktGridMemo memo;  // the runtime is asked once per device
  auto kernel = histogram_kernel<SHARED>;
  const size_t smem = SHARED ? static_cast<size_t>(nbins) * 4 : 0;
  long long blocks = 0;
  const cudaError_t e = tpkt_resident_grid(kernel, memo, kHistThreads, smem,
                                           blocks_per_sm, &blocks);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long need = tpkt_cdiv(tpkt_cdiv(n, 4), kHistThreads);
  if (blocks > need) blocks = need;
  const long long n4 = tpkt_aligned16(x) ? n / 4 : 0;
  // scratch: the count of finished blocks in its first 8 bytes, then bins
  kernel<<<static_cast<unsigned>(blocks), kHistThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      x, n, n4, out, scratch == nullptr ? nullptr : scratch + 2, scratch,
      nbins);
  return static_cast<int>(cudaGetLastError());
}

// n >= 1; blocks_per_sm: the grid's cap a SM. Up to TPKT_SMEM_BINS bins:
// out is nbins int32 that need not be zeroed, scratch is 8 + 4 * nbins
// bytes, zero before the first launch and left zero by every launch.
// Above: out is nbins zeroed int32, scratch is unused.
TPKT_EXPORT int tpkt_histogram(const void* x, void* out, void* scratch,
                               long long n, int nbins, int blocks_per_sm,
                               void* stream) {
  const int* xi = static_cast<const int*>(x);
  unsigned* bins = static_cast<unsigned*>(out);
  if (nbins > TPKT_SMEM_BINS)
    return launch<false>(xi, n, bins, nullptr, nbins, blocks_per_sm, stream);
  if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(xi, n, bins, static_cast<unsigned*>(scratch), nbins,
                      blocks_per_sm, stream);
}
