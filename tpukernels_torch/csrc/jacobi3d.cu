// 3-D 7-point Jacobi, temporally blocked: one launch runs `sweeps`
// (1..4) fused sweeps of a (d, h, w) float32 grid, x -> y.
//
// Replaces tpukernels/kernels/stencil.py:_jacobi3d_small_kernel and
// _jacobi3d_blocked_kernel. The TPU needed two paths because a grid
// either fits its VMEM or is cut into z-slabs of whole (h, w) planes
// with ghost planes; a 384^2 plane alone (576 KiB) is more than a
// block's 227 KB of shared memory, so here one kernel serves every size
// with tiles cut in all three dimensions.
//
// Bound on the card: one sweep alone moves 8 bytes per cell for 6
// flops, so it would be bound by HBM. Fusing k sweeps per launch cuts
// HBM traffic to 8/k bytes per cell-sweep (plus the halo re-reads,
// mostly from L2); what is left is shared-memory traffic and the
// instructions around it. Design: a block owns a TZ x TY x TX tile and
// loads it plus a halo of `sweeps` cells on every side into ONE shared
// buffer, every copy in flight at once (cp.async, zero-filled outside
// the grid). Sweep s updates only the cells at distance >= s from the
// loaded region's edge: they stay exact (the argument of the 2-D
// kernel, now in three dimensions), so after `sweeps` sweeps the owned
// cells, those at distance >= sweeps, are exact. Each thread owns a few
// (y, x) columns of the loaded tile and marches them along z, keeping
// the z-1, z and z+1 values of its columns in registers: a cell-update
// reads four in-plane neighbours and the z+1 cell from shared memory
// and writes one value. The update is in place: every thread computes
// planes z and z+1 from the old values, the block synchronises, then
// writes them. Plane z+2 is overwritten only after the next barrier,
// and the old plane z+1 is still in the registers that need it, so one
// buffer serves and two blocks fit on an SM. The sweep count is a
// template parameter, so the tile's extents are constants and each
// neighbour is an immediate offset from the column's pointer.
//
// The fusion depth is bounded by shared memory: with the halo at its
// most, HALO3D_MAX = 4, the buffer holds (16+8) x (16+8) x (32+8)
// floats, 92,160 bytes. The wrapper clamps k to HALO3D_MAX (below the
// reference's 8); the result is bitwise the same at every k.
//
// Dirichlet boundary: the interior test uses the TRUE (d, h, w), so the
// output has the input's shape and nothing is padded; boundary cells
// and the halo outside the grid keep their loaded values. The sum is
// ((((z-1 + z+1) + y-1) + y+1) + x-1) + x+1, then times (1.0f/6.0f) —
// the reference's order, with no multiply-add to contract — so the
// result is bitwise that of the plain PyTorch sweep.
//
// Blocks run in no order and neighbouring blocks still read the old
// grid, so a launch reads x and writes a different buffer y; the
// wrapper alternates two buffers between launches.
#include "common.cuh"

namespace {

constexpr int TZ = 16;          // owned planes per block
constexpr int TY = 16;          // owned rows per block
constexpr int TX = 32;          // owned columns per block
constexpr int HALO3D_MAX = 4;   // most fused sweeps per launch
constexpr int THREADS = 512;
// (y, x) columns of the loaded tile per thread, at the largest halo
constexpr int NCOL =
    ((TY + 2 * HALO3D_MAX) * (TX + 2 * HALO3D_MAX) + THREADS - 1) / THREADS;

// 4-byte global -> shared copy that does not hold the thread; src_size
// 0 writes a zero and reads nothing
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           bool read) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(read ? 4 : 0)
               : "memory");
}

static_assert(TZ % 2 == 0, "a sweep updates its planes two at a time");

// S: the sweeps of this launch, and the halo
template <int S>
__global__ void __launch_bounds__(THREADS, 2)
jacobi3d_kernel(const float* __restrict__ x, float* __restrict__ y, int d,
                int h, int w) {
  constexpr int EZ = TZ + 2 * S, EY = TY + 2 * S, EX = TX + 2 * S;
  constexpr int PLANE = EY * EX;
  extern __shared__ float buf[];  // [EZ][EY][EX]
  const int tid = threadIdx.x;
  const int z0 = blockIdx.z * TZ - S;  // grid plane of buf plane 0
  const int y0 = blockIdx.y * TY - S;
  const int x0 = blockIdx.x * TX - S;
  const long long hw = static_cast<long long>(h) * w;

  // this thread's columns: offset in a plane, distance from the loaded
  // tile's edge (-1 past the plane), grid offset of the (y, x) cell
  int off[NCOL], dist[NCOL];
  long long cell[NCOL];
  bool in_grid[NCOL], inner[NCOL];
#pragma unroll
  for (int j = 0; j < NCOL; ++j) {
    off[j] = tid + j * THREADS;
    const int ty = off[j] / EX, tx = off[j] % EX;
    dist[j] = off[j] < PLANE
                  ? min(min(ty, EY - 1 - ty), min(tx, EX - 1 - tx))
                  : -1;
    const int gy = y0 + ty, gx = x0 + tx;
    cell[j] = static_cast<long long>(gy) * w + gx;
    in_grid[j] = dist[j] >= 0 && gy >= 0 && gy < h && gx >= 0 && gx < w;
    inner[j] = gy > 0 && gy < h - 1 && gx > 0 && gx < w - 1;
  }

  for (int z = 0; z < EZ; ++z) {
    const int gz = z0 + z;
    const bool z_in = gz >= 0 && gz < d;
#pragma unroll
    for (int j = 0; j < NCOL; ++j) {
      if (dist[j] >= 0) {
        const bool read = z_in && in_grid[j];
        copy_async(buf + z * PLANE + off[j],
                   read ? x + (gz * hw + cell[j]) : x, read);
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

#pragma unroll 1
  for (int s = 1; s <= S; ++s) {
    // sweep s updates planes [s, EZ - s), an even count (TZ is even),
    // two per barrier: planes z, z+1 and z+2 are all read before the
    // barrier and planes z and z+1 written after it, so every read sees
    // the values of sweep s-1; z-1 of plane z comes from registers
    float below[NCOL], cur[NCOL];
    float* col[NCOL];
#pragma unroll
    for (int j = 0; j < NCOL; ++j) {
      col[j] = buf + s * PLANE + off[j];
      if (dist[j] >= s) {
        below[j] = col[j][-PLANE];
        cur[j] = col[j][0];
      }
    }
#pragma unroll 1
    for (int z = s; z < EZ - s; z += 2) {
      const int gz = z0 + z;
      const bool in0 = gz > 0 && gz < d - 1;
      const bool in1 = gz + 1 > 0 && gz + 1 < d - 1;
      float next0[NCOL], next1[NCOL];
#pragma unroll
      for (int j = 0; j < NCOL; ++j) {
        if (dist[j] >= s) {  // every neighbour lies inside the buffer
          const float* c = col[j];
          const float a1 = c[PLANE], a2 = c[2 * PLANE];
          const float m0 =
              (((((below[j] + a1) + c[-EX]) + c[EX]) + c[-1]) + c[1]) *
              (1.0f / 6.0f);
          const float m1 =
              (((((cur[j] + a2) + c[PLANE - EX]) + c[PLANE + EX]) +
                c[PLANE - 1]) + c[PLANE + 1]) *
              (1.0f / 6.0f);
          next0[j] = (in0 && inner[j]) ? m0 : cur[j];
          next1[j] = (in1 && inner[j]) ? m1 : a1;
          below[j] = a1;
          cur[j] = a2;
        }
      }
      __syncthreads();  // every read of planes z and z+1 is done
#pragma unroll
      for (int j = 0; j < NCOL; ++j) {
        if (dist[j] >= s) {
          col[j][0] = next0[j];
          col[j][PLANE] = next1[j];
        }
        col[j] += 2 * PLANE;
      }
    }
    __syncthreads();  // plane writes of sweep s are seen by sweep s+1
  }

#pragma unroll 4
  for (int z = 0; z < TZ; ++z) {
    const int gz = blockIdx.z * TZ + z;
    if (gz >= d) break;
#pragma unroll
    for (int j = 0; j < NCOL; ++j) {
      if (in_grid[j] && dist[j] >= S) {  // an owned cell
        y[gz * hw + cell[j]] = buf[(z + S) * PLANE + off[j]];
      }
    }
  }
}

template <int S>
cudaError_t launch(const float* x, float* y, int d, int h, int w,
                   cudaStream_t stream) {
  constexpr int smem = (TZ + 2 * S) * (TY + 2 * S) * (TX + 2 * S) * 4;
  // above 48 KB a block gets dynamic shared memory only on request; the
  // request is per device, so it is made on every call
  cudaError_t err = cudaFuncSetAttribute(
      jacobi3d_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)  // leave L1 the least, so more blocks fit an SM
    err = cudaFuncSetAttribute(jacobi3d_kernel<S>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  dim3 grid(static_cast<unsigned>(tpkt_cdiv(w, TX)),
            static_cast<unsigned>(tpkt_cdiv(h, TY)),
            static_cast<unsigned>(tpkt_cdiv(d, TZ)));
  jacobi3d_kernel<S><<<grid, THREADS, smem, stream>>>(x, y, d, h, w);
  return cudaGetLastError();
}

}  // namespace

TPKT_EXPORT int tpkt_jacobi3d_pass(const void* x, void* y, int d, int h,
                                   int w, int sweeps, void* stream) {
  const auto* in = static_cast<const float*>(x);
  auto* out = static_cast<float*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  if (d < 1 || h < 1 || w < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (sweeps) {
    case 1: return static_cast<int>(launch<1>(in, out, d, h, w, st));
    case 2: return static_cast<int>(launch<2>(in, out, d, h, w, st));
    case 3: return static_cast<int>(launch<3>(in, out, d, h, w, st));
    case 4: return static_cast<int>(launch<4>(in, out, d, h, w, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
