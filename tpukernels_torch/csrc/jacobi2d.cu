// 2-D 5-point Jacobi, temporally blocked: one launch runs `sweeps`
// (1..8) fused sweeps of an (h, w) float32 grid, x -> y.
//
// Replaces tpukernels/kernels/stencil.py:_jacobi2d_small_kernel and
// _jacobi2d_blocked_kernel. The TPU needed two paths because a grid
// either fits its VMEM or must be cut into row slabs with ghost rows;
// here one kernel serves every size.
//
// Bound on the card: one sweep alone moves 8 bytes per cell for 5
// flops, so it would be bound by HBM. Fusing k sweeps per launch cuts
// HBM traffic to 8/k bytes per cell-sweep; what is left is shared-
// memory and ALU work on the tile. Design: a block owns a TH x TW tile
// and loads it plus a halo of `sweeps` cells on every side into shared
// memory, then runs the sweeps ping-ponging between two shared buffers
// and writes back only its owned cells. A cell at distance d from the
// loaded region's edge is exact for d sweeps, so with a halo equal to
// the number of sweeps the owned cells stay exact (the argument of the
// TPU kernel's ghost band, now in both dimensions); sweep s updates
// only the cells at distance >= s, the rest are dead. Neighbouring
// blocks still read the old grid, so a launch reads x and writes a
// different buffer y; the wrapper alternates two buffers between
// launches.
//
// Dirichlet boundary: the interior test uses the TRUE (h, w); boundary
// cells and the halo outside the grid are held as loaded. The sum is
// ((N + S) + W) + E, times 0.25 — the order of the reference, so the
// result is bitwise that of the plain PyTorch sweep.
#include "common.cuh"

namespace {

constexpr int TH = 32;        // owned rows per block
constexpr int TW = 64;        // owned columns per block
constexpr int HALO_MAX = 8;   // most fused sweeps per launch
constexpr int SH = TH + 2 * HALO_MAX;
constexpr int SW = TW + 2 * HALO_MAX;
constexpr int BX = 32, BY = 8;  // block of threads

__global__ void __launch_bounds__(BX * BY)
jacobi2d_kernel(const float* __restrict__ x, float* __restrict__ y, int h,
                int w, int sweeps) {
  __shared__ float buf[2][SH][SW];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int r0 = blockIdx.y * TH - sweeps;  // grid row of buf row 0
  const int c0 = blockIdx.x * TW - sweeps;  // grid col of buf col 0
  const int eh = TH + 2 * sweeps, ew = TW + 2 * sweeps;

  for (int r = ty; r < eh; r += BY) {
    const int gr = r0 + r;
    for (int c = tx; c < ew; c += BX) {
      const int gc = c0 + c;
      buf[0][r][c] = (gr >= 0 && gr < h && gc >= 0 && gc < w)
                         ? x[(long long)gr * w + gc]
                         : 0.0f;
    }
  }
  __syncthreads();

  int cur = 0;
  for (int s = 1; s <= sweeps; ++s) {
    for (int r = s + ty; r < eh - s; r += BY) {
      const int gr = r0 + r;
      const bool row_in = gr > 0 && gr < h - 1;
      for (int c = s + tx; c < ew - s; c += BX) {
        const int gc = c0 + c;
        float v = buf[cur][r][c];
        if (row_in && gc > 0 && gc < w - 1) {
          const float n = buf[cur][r - 1][c];
          const float so = buf[cur][r + 1][c];
          const float we = buf[cur][r][c - 1];
          const float e = buf[cur][r][c + 1];
          v = (((n + so) + we) + e) * 0.25f;
        }
        buf[cur ^ 1][r][c] = v;
      }
    }
    cur ^= 1;
    __syncthreads();
  }

  for (int r = ty; r < TH; r += BY) {
    const int gr = blockIdx.y * TH + r;
    if (gr >= h) break;
    for (int c = tx; c < TW; c += BX) {
      const int gc = blockIdx.x * TW + c;
      if (gc < w) y[(long long)gr * w + gc] = buf[cur][r + sweeps][c + sweeps];
    }
  }
}

}  // namespace

TPKT_EXPORT int tpkt_jacobi2d_pass(const void* x, void* y, int h, int w,
                                   int sweeps, void* stream) {
  if (sweeps < 1 || sweeps > HALO_MAX || h < 1 || w < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(tpkt_cdiv(w, TW)),
            static_cast<unsigned>(tpkt_cdiv(h, TH)));
  jacobi2d_kernel<<<grid, dim3(BX, BY), 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), h, w, sweeps);
  return static_cast<int>(cudaGetLastError());
}
