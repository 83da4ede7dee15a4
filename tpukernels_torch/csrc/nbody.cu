// All-pairs softened gravity: a_i = sum_j m_j (r_j - r_i)
// (|r_j - r_i|^2 + eps2)^(-3/2) for n bodies in float32 SoA arrays.
//
// Replaces tpukernels/kernels/nbody.py:_forces_kernel. The TPU kernel
// holds a (bi,) column of i-bodies per grid step against (bi, bj)
// lane chunks of the resident j-set; here one thread owns one i-body
// and the block stages tiles of bj j-bodies through shared memory as
// (x, y, z, m) float4s (the GPU Gems 3 ch. 31 pattern): every thread
// of the block reads the same tile entry, a broadcast.
//
// Bound on the card: operations. A pair costs 20 flops and one
// reciprocal square root for 16 bytes of shared memory, and the j-set
// (1 MiB at 65 536 bodies) comes from L2; the reference's CostEstimate
// counts the same 20 flops per pair. At 65 536 bodies there are only
// about 500 threads per SM, so the time is the instructions each thread
// issues per pair: 13 and one shared load, with |r|^2 built as three
// FMAs from eps2 and the reciprocal square root as the bare MUFU.RSQ
// (rsqrtf adds a compare and two multiplies per pair to handle
// denormal inputs; |r|^2 + eps2 is never one unless eps is 0 and two
// bodies nearly coincide, where a flushed input gives inf, as 0 does).
// The loop is unrolled so that the independent pairs of a thread fill
// the pipelines between the three accumulator chains.
//
// Self-pairs are not skipped: their dr = 0 contributes 0 when eps2 > 0
// and NaN (0 * inf) when eps2 == 0, as in the reference. The last tile
// is padded with zero-mass bodies at the origin, the reference's own
// padding, so a ragged n needs no branch in the pair loop.
//
// Precision: rsqrt.approx is approximate (relative error below 2^-22),
// |r|^2 is summed from eps2 up in FMAs, and the sum over j runs in j
// order within a thread, not in XLA's order; so the result agrees with
// the plain PyTorch version within a band, not bitwise: rtol 2e-3,
// atol 2e-4 after the integration step (the C golden checker's bar,
// c/nbody.c).
#include "common.cuh"

namespace {

__device__ __forceinline__ float rsqrt_approx(float v) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__global__ void __launch_bounds__(1024)
nbody_forces_kernel(const float* __restrict__ px, const float* __restrict__ py,
                    const float* __restrict__ pz, const float* __restrict__ m,
                    float* __restrict__ ax, float* __restrict__ ay,
                    float* __restrict__ az, int n, float eps2, int bj) {
  extern __shared__ float4 tile[];  // bj bodies: (x, y, z, m)
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  const float xi = live ? px[i] : 0.0f;
  const float yi = live ? py[i] : 0.0f;
  const float zi = live ? pz[i] : 0.0f;
  float sx = 0.0f, sy = 0.0f, sz = 0.0f;

  for (int j0 = 0; j0 < n; j0 += bj) {
    for (int t = threadIdx.x; t < bj; t += blockDim.x) {
      const int j = j0 + t;
      tile[t] = j < n ? make_float4(px[j], py[j], pz[j], m[j])
                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    __syncthreads();
#pragma unroll 8
    for (int t = 0; t < bj; ++t) {
      const float4 b = tile[t];
      const float dx = b.x - xi;
      const float dy = b.y - yi;
      const float dz = b.z - zi;
      const float r2 = fmaf(dz, dz, fmaf(dy, dy, fmaf(dx, dx, eps2)));
      const float inv = rsqrt_approx(r2);
      const float wgt = b.w * inv * inv * inv;  // m_j / r^3
      sx += wgt * dx;
      sy += wgt * dy;
      sz += wgt * dz;
    }
    __syncthreads();  // the tile is refilled only after every thread used it
  }
  if (live) {
    ax[i] = sx;
    ay[i] = sy;
    az[i] = sz;
  }
}

}  // namespace

// bi: i-bodies (threads) per block, a multiple of 32 up to 1024;
// bj: j-bodies per shared tile, 1..3072 (48 KB of float4s, the most a
// block gets without asking for dynamic shared memory).
TPKT_EXPORT int tpkt_nbody_forces(const void* px, const void* py,
                                  const void* pz, const void* m, void* ax,
                                  void* ay, void* az, int n, float eps2,
                                  int bi, int bj, void* stream) {
  if (n < 1 || bi < 32 || bi > 1024 || bi % 32 || bj < 1 || bj > 3072)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(tpkt_cdiv(n, bi));
  nbody_forces_kernel<<<grid, bi, bj * sizeof(float4),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(px), static_cast<const float*>(py),
      static_cast<const float*>(pz), static_cast<const float*>(m),
      static_cast<float*>(ax), static_cast<float*>(ay),
      static_cast<float*>(az), n, eps2, bj);
  return static_cast<int>(cudaGetLastError());
}
