// Fused inclusive scan + histogram of n int32 elements: one read of x.
//
// Replaces tpukernels/kernels/scan_histogram.py:_fused_kernel. Bound on
// the card: bytes, 8 per element (read x once, write the scan), against
// the 12 of the unfused pair (csrc/scan.cu then csrc/histogram.cu read x
// twice). It is the scan kernel of scan.cuh, whose tile loop also counts
// each element into its block's private bins while the element is in
// registers; a block merges its bins into scratch bins when the tiles
// run out, and the last block moves them to the histogram. With more than
// TPKT_SMEM_BINS bins it counts with global atomics into the histogram,
// which the caller zeroed. The ragged tail is masked, so nothing is
// padded and no pad count has to come back out of bin 0, as the
// reference's does.
#include "scan.cuh"

using lookback::launch;
using lookback::kGlobalBins;
using lookback::kSharedBins;

template <int V>
static int fused_v(const void* x, void* out, void* hist, void* state,
                   long long n, int nbins, void* stream) {
  auto* bins = static_cast<unsigned*>(hist);
  return nbins <= TPKT_SMEM_BINS
             ? launch<unsigned, V, kSharedBins>(x, out, state, n, bins,
                                                nbins, stream)
             : launch<unsigned, V, kGlobalBins>(x, out, state, n, bins,
                                                nbins, stream);
}

// tile_steps and state as for tpkt_scan. Up to TPKT_SMEM_BINS bins hist
// need not be zeroed and state holds 4 * nbins more bytes, zero like the
// rest; above, hist is nbins zeroed int32.
TPKT_EXPORT int tpkt_scan_histogram(const void* x, void* out, void* hist,
                                    void* state, long long n, int nbins,
                                    int tile_steps, void* stream) {
  switch (tile_steps) {
    case 1: return fused_v<1>(x, out, hist, state, n, nbins, stream);
    case 2: return fused_v<2>(x, out, hist, state, n, nbins, stream);
    case 4: return fused_v<4>(x, out, hist, state, n, nbins, stream);
    case 8: return fused_v<8>(x, out, hist, state, n, nbins, stream);
    case 16: return fused_v<16>(x, out, hist, state, n, nbins, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
