// Single-pass inclusive scan with decoupled look-back, and the same
// pass counting a histogram: the device code of csrc/scan.cu and
// csrc/scan_histogram.cu.
//
// The TPU's _scan_kernel (tpukernels/kernels/scan.py) carries the running
// total from one grid step to the next in an SMEM scalar: its grid runs
// in order on one core. CUDA blocks run in parallel and in no order, so
// the carry across tiles is a decoupled look-back (Merrill & Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", NVIDIA
// 2016):
//
// - A block takes the next tile index from a global counter, never from
//   blockIdx.x: every tile before it then belongs to a block that is
//   already running, so waiting on it cannot deadlock.
// - It loads the tile (16-byte loads, coalesced), scans it in registers
//   (each thread's 4 elements, then the warp by __shfl_up_sync, then
//   the block's 8 warp totals) and publishes the tile total as an
//   AGGREGATE in its status word.
// - One warp then reads the status words of the 32 tiles before it at
//   once, waits until each has published, and adds aggregates up to and
//   including the nearest PREFIX (a tile's total through itself); with
//   none in the window it adds all 32 and steps back 32 tiles.
// - It publishes its own PREFIX, adds its exclusive prefix to the tile
//   and stores it.
//
// A status word is 64 bits, flag in the high half and the value's bits
// in the low half, written and read whole (volatile), so a reader never
// sees a flag without its value. Blocks stay resident and loop over
// tiles until the counter passes the last one.
//
// Bound on the card: bytes. Each element is read once and written once
// (8 B, 12 B for the unfused scan + histogram pair); the look-back adds
// 8 B of status per tile of 1024..16384 elements. int32 adds are done in
// uint32 so that they wrap mod 2^32, as the reference's (scan.py:20-27);
// float32 tile prefixes are summed in an order that depends on which
// predecessors had published, so float32 results may differ between runs
// in the last bits.
#pragma once

#include "bins.cuh"

namespace lookback {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStep = kThreads * 4;  // elements of one 16-byte load a thread
constexpr unsigned kFull = 0xffffffffu;

// status word flags (0: the tile has published nothing yet)
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kPrefix = 2ull << 32;

// histogram modes of scan_tiles
constexpr int kNoBins = 0, kSharedBins = 1, kGlobalBins = 2;

template <typename T>
__device__ __forceinline__ T from_bits(unsigned b);
template <>
__device__ __forceinline__ unsigned from_bits<unsigned>(unsigned b) {
  return b;
}
template <>
__device__ __forceinline__ float from_bits<float>(unsigned b) {
  return __uint_as_float(b);
}
__device__ __forceinline__ unsigned to_bits(unsigned v) { return v; }
__device__ __forceinline__ unsigned to_bits(float v) {
  return __float_as_uint(v);
}

template <typename T>
__device__ __forceinline__ T warp_inclusive(T v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T up = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v = up + v;
  }
  return v;
}

// the value of the lane before, 0 in lane 0
template <typename T>
__device__ __forceinline__ T lane_before(T incl, int lane) {
  const T up = __shfl_up_sync(kFull, incl, 1);
  return lane == 0 ? T(0) : up;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  return v;
}

template <typename T>
__device__ __forceinline__ void publish(unsigned long long* status,
                                        long long tile,
                                        unsigned long long flag, T value) {
  *reinterpret_cast<volatile unsigned long long*>(status + tile) =
      flag | to_bits(value);
}

// The exclusive prefix of tile `tile` > 0, read by one whole warp.
template <typename T>
__device__ T look_back(const unsigned long long* status, long long tile,
                       int lane) {
  const volatile unsigned long long* words = status;
  T prefix = T(0);
  for (long long end = tile - 1;; end -= 32) {
    const long long idx = end - lane;  // lane 0: the nearest predecessor
    unsigned long long w;
    do {
      // before tile 0 stands the empty prefix; tile 0 itself is always a
      // PREFIX, so no lane past it is summed
      w = idx >= 0 ? words[idx] : kPrefix;
    } while (__any_sync(kFull, (w >> 32) == 0));
    const unsigned done = __ballot_sync(kFull, (w & kPrefix) != 0);
    const int last = done ? __ffs(done) - 1 : 31;
    const T v = lane <= last ? from_bits<T>(static_cast<unsigned>(w)) : T(0);
    prefix = warp_sum(v) + prefix;
    if (done) return prefix;
  }
}

// Four consecutive elements from i, zeros past n; one 16-byte load when
// all four are in range and the pointer is 16-byte aligned.
template <typename T>
__device__ __forceinline__ void load4(const T* x, long long i, long long n,
                                      bool vec, T (&v)[4]) {
  if (vec && i + 4 <= n) {
    const uint4 q = *reinterpret_cast<const uint4*>(x + i);
    v[0] = from_bits<T>(q.x);
    v[1] = from_bits<T>(q.y);
    v[2] = from_bits<T>(q.z);
    v[3] = from_bits<T>(q.w);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = i + k < n ? x[i + k] : T(0);
  }
}

template <typename T>
__device__ __forceinline__ void store4(T* out, long long i, long long n,
                                       const T (&v)[4]) {
  if (i + 4 <= n) {  // out is a fresh allocation: 16-byte aligned
    *reinterpret_cast<uint4*>(out + i) =
        make_uint4(to_bits(v[0]), to_bits(v[1]), to_bits(v[2]),
                   to_bits(v[3]));
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (i + k < n) out[i + k] = v[k];
  }
}

// Inclusive scan of x[0, n) into out, tiles of V * kStep elements; with
// BINS != kNoBins it also counts the values in [0, nbins) into hist
// (uint32 only). counter and status start zeroed; status has one word
// per tile. vec: x is 16-byte aligned.
template <typename T, int V, int BINS>
__global__ void __launch_bounds__(kThreads)
    scan_tiles(const T* __restrict__ x, T* __restrict__ out,
               unsigned long long* status, unsigned* counter, long long n,
               long long tiles, bool vec, unsigned* hist, int nbins) {
  extern __shared__ unsigned s_bins[];
  __shared__ T s_off[kWarps];
  __shared__ long long s_tile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned* bins = BINS == kSharedBins ? s_bins : hist;
  if (BINS == kSharedBins) tpkt_bins_zero(s_bins, nbins);

  for (;;) {
    __syncthreads();  // the previous tile's readers of s_tile, s_off are done
    if (threadIdx.x == 0) s_tile = atomicAdd(counter, 1u);
    __syncthreads();
    const long long tile = s_tile;
    if (tile >= tiles) break;

    // warp w owns V chunks of 128 consecutive elements of the tile; lane
    // l holds elements 4l..4l+3 of each chunk
    const long long base = tile * (V * kStep) +
                           static_cast<long long>(warp) * (V * 128) +
                           4 * lane;
    T v[V][4];
#pragma unroll
    for (int j = 0; j < V; ++j) load4(x, base + j * 128, n, vec, v[j]);
    if (BINS != kNoBins) {
#pragma unroll
      for (int j = 0; j < V; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (base + j * 128 + k < n)
            tpkt_bin_count(bins, to_bits(v[j][k]), nbins);
    }

    // the warp's chunks in order: the thread's 4, then across lanes
    T carry = T(0);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      v[j][1] = v[j][0] + v[j][1];
      v[j][2] = v[j][1] + v[j][2];
      v[j][3] = v[j][2] + v[j][3];
      const T incl = warp_inclusive(v[j][3], lane);
      const T before = carry + lane_before(incl, lane);
#pragma unroll
      for (int k = 0; k < 4; ++k) v[j][k] = before + v[j][k];
      carry = carry + __shfl_sync(kFull, incl, 31);
    }
    if (lane == 0) s_off[warp] = carry;
    __syncthreads();

    // warp 0: the tile total, the look-back, each warp's offset
    if (warp == 0) {
      const T incl = warp_inclusive(lane < kWarps ? s_off[lane] : T(0), lane);
      const T total = __shfl_sync(kFull, incl, kWarps - 1);
      T prefix = T(0);
      if (tile == 0) {
        if (lane == 0) publish(status, 0, kPrefix, total);
      } else {
        if (lane == 0) publish(status, tile, kAggregate, total);
        prefix = look_back<T>(status, tile, lane);
        if (lane == 0) publish(status, tile, kPrefix, prefix + total);
      }
      const T before = lane_before(incl, lane);
      if (lane < kWarps) s_off[lane] = prefix + before;
    }
    __syncthreads();

    const T off = s_off[warp];
#pragma unroll
    for (int j = 0; j < V; ++j) {
#pragma unroll
      for (int k = 0; k < 4; ++k) v[j][k] = off + v[j][k];
      store4(out, base + j * 128, n, v[j]);
    }
  }
  // every thread passed the loop's barriers after its last count
  if (BINS == kSharedBins) tpkt_bins_merge(s_bins, hist, nbins);
}

// Launches scan_tiles with one resident grid. state: tiles + 1 zeroed
// 64-bit words, the tile counter then one status word a tile.
template <typename T, int V, int BINS>
static int launch(const void* x, void* out, void* state, long long n,
                  unsigned* hist, int nbins, void* stream) {
  auto kernel = scan_tiles<T, V, BINS>;
  const size_t smem =
      BINS == kSharedBins ? static_cast<size_t>(nbins) * sizeof(unsigned)
                          : 0;
  const long long tiles = tpkt_cdiv(n, V * kStep);
  long long blocks = 0;
  cudaError_t e = tpkt_allow_smem(kernel, smem);
  if (e == cudaSuccess)
    e = tpkt_resident_blocks(kernel, kThreads, smem, 0, &blocks);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (blocks > tiles) blocks = tiles;
  auto* words = static_cast<unsigned long long*>(state);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(out), words + 1,
      reinterpret_cast<unsigned*>(words), n, tiles, tpkt_aligned16(x), hist,
      nbins);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lookback
