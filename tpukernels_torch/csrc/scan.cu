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

// tile_steps: tile size / 1024 (1, 2, 4, 8 or 16); state: tiles + 1 zeroed
// 64-bit words (see launch in scan.cuh).
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
