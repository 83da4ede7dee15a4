// SAXPY: out = alpha * x + y over n float32 elements.
//
// Replaces tpukernels/kernels/vector_add.py:_saxpy_kernel (the VPU pass
// over (rows, 128) blocks). Bound on the card: bytes. Each element
// moves 12 bytes (read x, read y, write out) for 2 flops, far below the
// ~20 flop/byte the H100 needs before its fp32 units limit, so the
// kernel's only job is to keep HBM busy:
//
// - 16-byte vectors (float4) where all three pointers are 16-byte
//   aligned; a scalar loop for the tail, and for every element when a
//   pointer is not aligned;
// - each thread puts UNROLL independent float4 loads of x and of y in
//   flight before it uses any of them (a block covers UNROLL * blockDim
//   float4s a trip, neighbouring threads on neighbouring vectors);
// - streaming hints: loads and stores evict-first (ld/st.global.cs),
//   since nothing is read twice;
// - the wrapper sizes the grid to the whole work, one trip a block: on
//   the H100 that beat a grid of a few blocks a SM walking the work in
//   a grid-stride loop (chip_smoke.py times both at 2^26; PERF.md), as
//   blocks that finish make room for new ones; the loop stays so that
//   any grid is right.
//
// TMA buys nothing here: it moves tiles between device and shared
// memory, and a one-dimensional stream with no reuse has no use for
// shared memory; registers are the shortest path from load to store.
#include "common.cuh"

namespace {

constexpr int UNROLL = 4;

__device__ __forceinline__ float4 axpy(float alpha, float4 a, float4 b) {
  return make_float4(fmaf(alpha, a.x, b.x), fmaf(alpha, a.y, b.y),
                     fmaf(alpha, a.z, b.z), fmaf(alpha, a.w, b.w));
}

__global__ void saxpy_kernel(const float* __restrict__ x,
                             const float* __restrict__ y,
                             float* __restrict__ out, long long n,
                             long long n4, float alpha) {
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const float4* y4 = reinterpret_cast<const float4*>(y);
  float4* o4 = reinterpret_cast<float4*>(out);
  const long long bd = blockDim.x;
  const long long stride = (long long)gridDim.x * bd * UNROLL;
  for (long long i = (long long)blockIdx.x * bd * UNROLL + threadIdx.x;
       i < n4; i += stride) {
    if (i + (UNROLL - 1) * bd < n4) {
      float4 a[UNROLL], b[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        a[u] = __ldcs(x4 + i + u * bd);
        b[u] = __ldcs(y4 + i + u * bd);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        __stcs(o4 + i + u * bd, axpy(alpha, a[u], b[u]));
    } else {  // the last, partial trip
      for (long long j = i; j < n4; j += bd)
        __stcs(o4 + j, axpy(alpha, __ldcs(x4 + j), __ldcs(y4 + j)));
    }
  }
  const long long tid = (long long)blockIdx.x * bd + threadIdx.x;
  for (long long i = 4 * n4 + tid; i < n; i += (long long)gridDim.x * bd)
    out[i] = fmaf(alpha, x[i], y[i]);
}

}  // namespace

// blocks: grid size chosen by the wrapper; threads: block size.
TPKT_EXPORT int tpkt_saxpy(const void* x, const void* y, void* out,
                           long long n, float alpha, int blocks,
                           int threads, void* stream) {
  const bool vec = tpkt_aligned16(x) && tpkt_aligned16(y) &&
                   tpkt_aligned16(out);
  const long long n4 = vec ? n / 4 : 0;
  saxpy_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<float*>(out), n, n4, alpha);
  return static_cast<int>(cudaGetLastError());
}
