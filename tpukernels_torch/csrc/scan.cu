// Inclusive prefix sum of n float32 or int32 elements.
//
// Replaces tpukernels/kernels/scan.py:_scan_kernel (with scan_block, its
// MXU row scan). Bound on the card: bytes, 8 per element (read x, write
// out), once: a single pass with decoupled look-back, described with
// the device code in scan.cuh. int32 is scanned as uint32, which wraps
// mod 2^32 like the reference. The exclusive scan is the wrapper's
// one-element shift of this kernel's result, as in the reference.
#include "scan.cuh"

using lookback::launch;
using lookback::kNoBins;

template <int V>
static int scan_v(const void* x, void* out, void* state, long long n,
                  int is_float, void* stream) {
  return is_float
             ? launch<float, V, kNoBins>(x, out, state, n, nullptr, 0, stream)
             : launch<unsigned, V, kNoBins>(x, out, state, n, nullptr, 0,
                                            stream);
}

// tile_steps: tile size / 1024 (1, 2, 4, 8 or 16); state: tiles + 1 64-bit
// words, zero before the first launch (see launch in scan.cuh).
TPKT_EXPORT int tpkt_scan(const void* x, void* out, void* state, long long n,
                          int tile_steps, int is_float, void* stream) {
  switch (tile_steps) {
    case 1: return scan_v<1>(x, out, state, n, is_float, stream);
    case 2: return scan_v<2>(x, out, state, n, is_float, stream);
    case 4: return scan_v<4>(x, out, state, n, is_float, stream);
    case 8: return scan_v<8>(x, out, state, n, is_float, stream);
    case 16: return scan_v<16>(x, out, state, n, is_float, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// For timing only: the int32 scan at the largest tile on a grid of at
// most `cap` blocks a SM (0: all that are resident) and, with first_path,
// every look-back answered with an empty prefix, which leaves `out`
// wrong. *per_sm receives the blocks a SM the runtime reports resident.
// No wrapper calls it; chip_smoke.py does, to tell the look-back's serial
// chain from the blocks a SM.
TPKT_EXPORT int tpkt_scan_probe(const void* x, void* out, void* state,
                                long long n, int cap, int first_path,
                                int* per_sm, void* stream) {
  if (per_sm != nullptr) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, lookback::scan_tiles<unsigned, 16, kNoBins, false>,
        lookback::kThreads, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return first_path
             ? launch<unsigned, 16, kNoBins, true>(x, out, state, n, nullptr,
                                                   0, stream, cap)
             : launch<unsigned, 16, kNoBins, false>(x, out, state, n,
                                                    nullptr, 0, stream, cap);
}
