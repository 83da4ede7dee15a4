// All-pairs softened gravity: a_i = sum_j m_j (r_j - r_i)
// (|r_j - r_i|^2 + eps2)^(-3/2) for n bodies in float32 SoA arrays.
//
// Replaces tpukernels/kernels/nbody.py:_forces_kernel. The TPU kernel
// holds a (bi,) column of i-bodies per grid step against (bi, bj)
// lane chunks of the resident j-set. Here a block owns bi i-bodies;
// its threads form S groups, and each thread of a group holds R of
// the block's i-bodies in registers. Group g walks its own 1/S of the
// j-range, staging tiles of bj / S bodies through its own part of
// shared memory as (x, y, z, m) float4s: every thread of the group
// reads the same tile entry, a broadcast.
//
// Bound on the card: operations, 20 flops and one reciprocal square
// root a pair (the reference's CostEstimate counts the same 20 flops);
// the j-set (1 MiB at 65 536 bodies) comes from L2. What the card
// issues a pair is 12 FP32 instructions (3 FADD for dr, 3 FFMA for
// |r|^2 built from eps2 up, 3 FMUL for m * inv * inv * inv, 3 FFMA
// into the sums), one MUFU.RSQ and one shared load: 14 issue slots a
// pair with one i-body a thread. The bare MUFU.RSQ stands for rsqrtf,
// which adds a compare and two multiplies a pair for denormal inputs;
// |r|^2 + eps2 is never one unless eps is 0 and two bodies nearly
// coincide, where a flushed input gives inf, as 0 does.
//
// What R and S do about it. Each broadcast float4 feeds R pairs, so a
// pair costs 13 + 1/R slots, and a thread carries R independent
// accumulator chains, which hide the FFMA and MUFU latency. The S
// groups multiply the threads of a block by S / R against one thread an
// i-body: at 65 536 bodies and bi = 256 that is 8 warps a scheduler,
// not 4. A group syncs only its own warps (bar.sync with the group's
// id and thread count). At the end the S partial sums of each i-body
// are added through shared memory in the fixed order 0..S-1, so two
// calls give the same bits. The block the plan launches is at most
// kMaxThreads, and __launch_bounds__ names it with kMinBlocks blocks a
// SM: 64 registers a thread, 8 warps a scheduler at two blocks a SM.
//
// The geometry comes from tpukernels_torch/kernels/nbody.py:plan_forces
// (checked pair by pair on the CPU): T = bi / R rounded up to a warp
// threads a group, thread t of a group owning the block's i-bodies
// t + k T (k < R; those past bi or n are computed and not stored);
// group g the j-range [g per, (g + 1) per), per a multiple of the tile.
//
// Self-pairs are not skipped: their dr = 0 contributes 0 when eps2 > 0
// and NaN (0 * inf) when eps2 == 0, as in the reference. The j-range is
// padded with zero-mass bodies at the origin, the reference's own
// padding, so a ragged n needs no branch in the pair loop.
//
// Precision: rsqrt.approx is approximate (relative error below 2^-22),
// |r|^2 is summed from eps2 up in FMAs, and the sum over j runs in j
// order within a group, then over the groups in order, not in XLA's
// order; so the result agrees with the plain PyTorch version within a
// band, not bitwise: rtol 2e-3, atol 2e-4 after the integration step
// (the C golden checker's bar, c/nbody.c).
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 512;  // threads of the default plan's block
constexpr int kMinBlocks = 2;     // 65 536 / (512 * 2) = 64 registers

__device__ __forceinline__ float rsqrt_approx(float v) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// the warps of one group: named barrier 1 + g over its t threads
__device__ __forceinline__ void group_sync(int g, int t) {
  asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "r"(t) : "memory");
}

template <int R, int S>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
nbody_forces_kernel(const float* __restrict__ px,
                    const float* __restrict__ py,
                    const float* __restrict__ pz,
                    const float* __restrict__ m, float* __restrict__ ax,
                    float* __restrict__ ay, float* __restrict__ az, int n,
                    float eps2, int bi, int tile, int per) {
  extern __shared__ float4 smem[];  // S tiles of `tile` bodies
  const int T = blockDim.x / S;     // threads a group
  const int g = threadIdx.x / T;
  const int t = threadIdx.x - g * T;
  const int i0 = blockIdx.x * bi;
  float4* own = smem + g * tile;

  float xi[R], yi[R], zi[R], sx[R], sy[R], sz[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int i = i0 + t + k * T;
    const bool live = t + k * T < bi && i < n;
    xi[k] = live ? px[i] : 0.0f;
    yi[k] = live ? py[i] : 0.0f;
    zi[k] = live ? pz[i] : 0.0f;
    sx[k] = sy[k] = sz[k] = 0.0f;
  }

  const int jend = (g + 1) * per;
  for (int j0 = g * per; j0 < jend; j0 += tile) {
    for (int u = t; u < tile; u += T) {
      const int j = j0 + u;
      own[u] = j < n ? make_float4(px[j], py[j], pz[j], m[j])
                     : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    group_sync(g, T);
    const float4* const end = own + tile;
    // 16 pairs an iteration
#pragma unroll (16 / R)
    for (const float4* p = own; p < end; ++p) {
      const float4 b = *p;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const float dx = b.x - xi[k];
        const float dy = b.y - yi[k];
        const float dz = b.z - zi[k];
        const float r2 = fmaf(dz, dz, fmaf(dy, dy, fmaf(dx, dx, eps2)));
        const float inv = rsqrt_approx(r2);
        const float wgt = b.w * inv * inv * inv;  // m_j / r^3
        sx[k] = fmaf(wgt, dx, sx[k]);
        sy[k] = fmaf(wgt, dy, sy[k]);
        sz[k] = fmaf(wgt, dz, sz[k]);
      }
    }
    group_sync(g, T);  // the tile is refilled only after the group used it
  }

  // the partial sums, [group][component][R T], over the tiles
  float* part = reinterpret_cast<float*>(smem);
  const int w = R * T;
  __syncthreads();  // every group is done with its tile
#pragma unroll
  for (int k = 0; k < R; ++k) {
    part[(g * 3 + 0) * w + t + k * T] = sx[k];
    part[(g * 3 + 1) * w + t + k * T] = sy[k];
    part[(g * 3 + 2) * w + t + k * T] = sz[k];
  }
  __syncthreads();
  for (int q = threadIdx.x; q < 3 * bi; q += blockDim.x) {
    const int c = q / bi;
    const int li = q - c * bi;
    const int i = i0 + li;
    if (i >= n) continue;
    float acc = part[c * w + li];
#pragma unroll
    for (int h = 1; h < S; ++h) acc += part[(h * 3 + c) * w + li];
    (c == 0 ? ax : c == 1 ? ay : az)[i] = acc;
  }
}

template <int R, int S>
cudaError_t launch(const float* px, const float* py, const float* pz,
                   const float* m, float* ax, float* ay, float* az, int n,
                   float eps2, int bi, int tile, int per, unsigned grid,
                   int threads, size_t smem, cudaStream_t stream) {
  nbody_forces_kernel<R, S><<<grid, threads, smem, stream>>>(
      px, py, pz, m, ax, ay, az, n, eps2, bi, tile, per);
  return cudaGetLastError();
}

}  // namespace

// The launch of kernels/nbody.py:plan_forces. bi: i-bodies a block, a
// multiple of 32 up to 1024; r: i-bodies a thread, 2 or 4; s: groups a
// block, 1, 2, 4 or 8; tile: j-bodies a group stages at once; per:
// j-bodies a group walks, a multiple of tile, with s * per >= n. A
// group has T = bi / r threads rounded up to a warp, a block s T, at
// most kMaxThreads; s tiles take at most 48 KB (3072 float4s).
TPKT_EXPORT int tpkt_nbody_forces(const void* px, const void* py,
                                  const void* pz, const void* m, void* ax,
                                  void* ay, void* az, int n, float eps2,
                                  int bi, int r, int s, int tile, int per,
                                  void* stream) {
  if (n < 1 || bi < 32 || bi > 1024 || bi % 32 || (r != 2 && r != 4) ||
      (s != 1 && s != 2 && s != 4 && s != 8) || tile < 1 || per < tile ||
      per % tile || static_cast<long long>(s) * per < n)
    return static_cast<int>(cudaErrorInvalidValue);
  const int t = static_cast<int>((tpkt_cdiv(bi, r) + 31) / 32 * 32);
  const int threads = s * t;
  if (threads > kMaxThreads || s * tile > 3072)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      std::max(s * tile * sizeof(float4), 3 * s * r * t * sizeof(float));
  const unsigned grid = static_cast<unsigned>(tpkt_cdiv(n, bi));
  auto* st = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const float*>(px);
  const auto* y = static_cast<const float*>(py);
  const auto* z = static_cast<const float*>(pz);
  const auto* w = static_cast<const float*>(m);
  auto* fx = static_cast<float*>(ax);
  auto* fy = static_cast<float*>(ay);
  auto* fz = static_cast<float*>(az);
#define TPKT_NBODY_CASE(RR, SS)                                           \
  if (r == RR && s == SS)                                                 \
    return static_cast<int>(launch<RR, SS>(x, y, z, w, fx, fy, fz, n,    \
                                           eps2, bi, tile, per, grid,     \
                                           threads, smem, st));
  TPKT_NBODY_CASE(2, 1)
  TPKT_NBODY_CASE(2, 2)
  TPKT_NBODY_CASE(2, 4)
  TPKT_NBODY_CASE(2, 8)
  TPKT_NBODY_CASE(4, 1)
  TPKT_NBODY_CASE(4, 2)
  TPKT_NBODY_CASE(4, 4)
  TPKT_NBODY_CASE(4, 8)
#undef TPKT_NBODY_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
