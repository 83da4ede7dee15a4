// 2-D 5-point Jacobi, temporally blocked: one launch runs `sweeps`
// (1..8) fused sweeps of an (h, w) float32 grid, x -> y.
//
// Replaces tpukernels/kernels/stencil.py:_jacobi2d_small_kernel and
// _jacobi2d_blocked_kernel. The TPU needed two paths because a grid
// either fits its VMEM or must be cut into row slabs with ghost rows;
// here one kernel serves every size.
//
// Bound on the card (H100 SXM, 4096^2 x 1000 sweeps at k = 8, 125
// launches): the roofline of the whole call, 5 flops a cell-sweep at 67
// TFLOP/s, is 1.25 ms; those 5 flops are 5 instructions (4 adds and a
// multiply, no FMA), so at 128 fp32 lanes a clock an SM the instruction
// floor is ~2.5 ms; every launch reads and writes the 64 MiB grid, which
// the 50 MB L2 cannot hold, so the 125 passes need at least 125 x 8 B x
// 4096^2 / 3.35 TB/s = 5.01 ms. The pass floor binds. The kernel has to
// keep the sweeps of a pass on chip and cheap enough to hide under the
// pass's HBM traffic.
//
// Design: a register wavefront along y. A block is one warp. It owns a
// strip of columns and a segment of rows and marches down the segment
// one row a step. Each lane holds V = 4 adjacent columns, so a warp
// loads a strip LOAD_W = 128 columns wide and owns the middle 128 - 2 *
// halo, halo = sweeps rounded up to V (so every lane's columns are all
// owned or all halo, and a row of a lane is one 16-byte copy). A step
// brings one new row (level 0) from a small per-warp ring of cp.async
// copies RING - 1 rows ahead, then computes every level s = 1..sweeps
// once: level s at row r - 2s from level s-1's rows r-2s-1 .. r-2s+1,
// which were made in the three steps before. So the levels of one step
// do not depend on each other and issue side by side, and each level
// keeps only its last three rows, in registers (3 x V floats a lane a
// level). N and S are a lane's own registers; W and E of its edge
// columns come from the neighbouring lanes by warp shuffles. There is
// no shared-memory tile and no block barrier: shared memory holds only
// the copies in flight, each read back by the lane that asked for it.
// Level `sweeps` of each owned row is stored, 16 bytes a lane. The sweep
// count is a template parameter, so each level's registers are named at
// compile time: ptxas must report no spills.
//
// The exact-cell argument: a value at level s is exact when it lies at
// distance >= s from the loaded window's edge, in x and in y (its
// dependence cone then lies inside the window). The window is the strip
// (halo >= sweeps columns beyond the owned ones on each side) by the
// segment's rows with `sweeps` rows above and below; the warp stores
// level `sweeps` only at its owned columns and rows. Values outside the
// window (rows the ring did not load, the lanes' missing neighbours) are
// never exact and never stored. Cells outside the grid load as 0.
// Redundancy at 4096^2, k = 8: 128/112 in x, (147 + 24)/147 in y (the
// level lag of 2 rows adds `sweeps` steps a segment), 1.33 in all.
//
// Dirichlet boundary: the interior test uses the TRUE (h, w); boundary
// cells are held as loaded. Rows are tested only in the steps at which
// some level is at row 0 or h - 1 inside the window (a select on the
// row); columns are held by a lane-constant bit mask in every update
// (one LOP3 a cell, all ones but at column 0 and w - 1). Neither is a
// branch: with a branch around each cell, a step fell into blocks that
// did not overlap, and the strips that meet the boundary, 12 % of the
// warps, set the length of every launch. Every warp runs the same code:
// a second copy of the march for strips without a boundary column made
// the launch slower, not faster (most likely the two copies compete for
// the instruction cache). The sum is (((N + S) + W) + E) * 0.25f, the order of the
// reference, through __fadd_rn / __fmul_rn: a level's product feeds the
// next level's adds, and these intrinsics are never contracted into an
// FMA, so the result is bitwise that of the plain PyTorch sweep.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W): 4096^2 x
// 1000 at k = 8 in 7.76 ms, 1.55x the pass floor; 174 registers a thread
// at k = 8, no spills.
//
// Warps run in no order and neighbouring warps still read the old grid,
// so a launch reads x and writes a different buffer y; the wrapper
// alternates two buffers between launches.
//
// The launch geometry (halo, owned strip, segment, grid) is make_plan
// below; tpukernels_torch/kernels/stencil.py:plan2d computes the same,
// and the wrapper checks the two agree (tpkt_jacobi2d_plan) before a
// shape's first launch.
#include "common.cuh"

namespace {

constexpr int V = 4;               // columns a lane holds
constexpr int LANES = 32;
constexpr int LOAD_W = V * LANES;  // columns a warp loads
constexpr int HALO_MAX = 8;        // most fused sweeps per launch
constexpr int RING = 8;            // rows of a warp's copy ring
constexpr int SEG_MIN = 16;        // fewest owned rows a segment
// warps a launch aims at: 8 a SM on the H100's 132 SMs, one wave
constexpr int FILL_WARPS = 132 * 8;
constexpr unsigned FULL = 0xffffffffu;
static_assert(V == 4, "a lane's columns of a row are one float4");

struct Plan {
  int halo;   // loaded columns beyond the owned ones, each side
  int strip;  // owned columns a warp
  int seg;    // owned rows a warp
  int nx, ny; // strips, segments
};

Plan make_plan(int h, int w, int sweeps) {
  Plan p;
  p.halo = (sweeps + V - 1) / V * V;
  p.strip = LOAD_W - 2 * p.halo;
  p.nx = static_cast<int>(tpkt_cdiv(w, p.strip));
  const int nseg = FILL_WARPS / p.nx > 1 ? FILL_WARPS / p.nx : 1;
  const int seg = static_cast<int>(tpkt_cdiv(h, nseg));
  p.seg = seg > SEG_MIN ? seg : SEG_MIN;
  p.ny = static_cast<int>(tpkt_cdiv(h, p.seg));
  return p;
}

// global -> shared copies that do not hold the thread; src_size 0
// writes zeros and reads nothing
__device__ __forceinline__ void copy16(float4* dst, const float* src,
                                       bool read) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(read ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      bool read) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(read ? 4 : 0)
               : "memory");
}

// a ? b : c as a select. Written as a ternary, the compiler moves the
// stencil's adds into a branch around each cell, which splits the
// level loop into blocks that do not overlap.
__device__ __forceinline__ float pick(bool a, float b, float c) {
  float r;
  asm("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %1, 0;\n\t"
      "selp.f32 %0, %2, %3, p;\n\t}"
      : "=f"(r)
      : "r"(static_cast<int>(a)), "f"(b), "f"(c));
  return r;
}

// One warp's march of `S` sweeps. Boundary columns are held by a
// lane-constant mask in every update, boundary rows only in the steps
// that reach them (run).
template <int S>
struct March {
  const float* x;
  float* y;
  int h, w;
  int lo, hi;        // loaded rows [lo, hi): `S` beyond the owned ones
  int r0, r1;        // owned rows [r0, r1)
  int c;             // the lane's first column
  bool own;          // the lane's columns are owned
  bool vec_in, vec_out;
  unsigned keep[V];  // all ones where column c + j is not on the boundary
  float4* ring;      // [RING][LANES]
  int lane;
  // set by run()
  int slot;          // ring slot of the row this step consumes
  int rlo, rn;       // the window's rows in the grid: [rlo, rlo + rn)
  bool col_in;       // the lane's columns lie in the grid (vec_in)
  long long src;     // offset in x of the next row to fetch, column c
  long long dst;     // offset in y of the row level S reaches next
  float lv[S][3][V]; // levels 0..S-1, slot t % 3 holds step t's row

  // copy row r into ring slot `at`, one commit group (empty past the
  // window, so the wait count stays one group a step)
  __device__ __forceinline__ void fetch(int r, int at) {
    float4* d = ring + at * LANES + lane;
    const bool row = static_cast<unsigned>(r - rlo) < static_cast<unsigned>(rn);
    if (vec_in) {
      const bool read = row && col_in;
      copy16(d, read ? x + src : x, read);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const bool read = row && c + j >= 0 && c + j < w;
        copy4(reinterpret_cast<float*>(d) + j, read ? x + src + j : x, read);
      }
    }
    src += w;
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  // level s+1 at row q from level s's rows q-1, q, q+1 (slots P, P+1,
  // P+2 mod 3). ROWS: row q may be a boundary row.
  template <int P, bool ROWS>
  __device__ __forceinline__ void update(const float (&a)[3][V], int q,
                                         float (&out)[V]) const {
    const float* n = a[P];
    const float* m = a[(P + 1) % 3];
    const float* s = a[(P + 2) % 3];
    const float wl = __shfl_up_sync(FULL, m[V - 1], 1);
    const float er = __shfl_down_sync(FULL, m[0], 1);
    const bool row_in = (q > 0) & (q < h - 1);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float we = j > 0 ? m[j - 1] : wl;
      const float ea = j < V - 1 ? m[j + 1] : er;
      float v = __fmul_rn(
          __fadd_rn(__fadd_rn(__fadd_rn(n[j], s[j]), we), ea), 0.25f);
      if (ROWS) {
        v = pick(row_in & (keep[j] != 0u), v, m[j]);
      } else {  // one LOP3: v where kept, else the held value
        v = __uint_as_float((__float_as_uint(v) & keep[j]) |
                            (__float_as_uint(m[j]) & ~keep[j]));
      }
      out[j] = v;
    }
  }

  // step t: row r = lo + t arrives; level s moves to row r - 2s
  template <int P, bool ROWS>
  __device__ __forceinline__ void step(int t) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(RING - 2) : "memory");
    const float4 got = ring[slot * LANES + lane];
    const int r = lo + t;
    float out[V];
    update<P, ROWS>(lv[S - 1], r - 2 * S, out);
#pragma unroll
    for (int s = S - 1; s >= 1; --s)
      update<P, ROWS>(lv[s - 1], r - 2 * s, lv[s][P]);
    lv[0][P][0] = got.x;
    lv[0][P][1] = got.y;
    lv[0][P][2] = got.z;
    lv[0][P][3] = got.w;

    const int q = r - 2 * S;
    if (own && static_cast<unsigned>(q - r0) < static_cast<unsigned>(r1 - r0)) {
      float* d = y + dst;
      if (vec_out && c + V <= w) {
        *reinterpret_cast<float4*>(d) =
            make_float4(out[0], out[1], out[2], out[3]);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j)
          if (c + j < w) d[j] = out[j];
      }
    }
    dst += w;
    // the slot of row r - 1, read a step ago and used by this step's
    // level 1, takes row r + RING - 1
    const int prev = slot == 0 ? RING - 1 : slot - 1;
    fetch(r + RING - 1, prev);
    slot = slot == RING - 1 ? 0 : slot + 1;
  }

  // steps t.. up to `end`, three at a time (t stays a multiple of 3, so
  // step t uses slot t % 3); returns the next step
  template <bool ROWS>
  __device__ __forceinline__ int march_to(int t, int end) {
#pragma unroll 1
    for (; t < end; t += 3) {
      step<0, ROWS>(t);
      step<1, ROWS>(t + 1);
      step<2, ROWS>(t + 2);
    }
    return t;
  }

  __device__ __forceinline__ void run() {
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < V; ++j) lv[s][i][j] = 0.0f;
    rlo = lo > 0 ? lo : 0;
    rn = (hi < h ? hi : h) - rlo;
    col_in = c >= 0 && c < w;
    src = static_cast<long long>(lo) * w + c;
#pragma unroll
    for (int i = 0; i < RING - 1; ++i) fetch(lo + i, i);
    slot = 0;
    dst = static_cast<long long>(lo - 2 * S) * w + c;
    // the last owned row leaves level S at step (r1 - 1 + 2S) - lo
    const int steps = (r1 - 1 + 2 * S) - lo + 1;
    // level s is at row lo + t - 2s: the steps at which a level is at
    // row 0 or h - 1 inside the window test the row, the rest do not
    int a0 = 0, b0 = 0, a1 = 0, b1 = 0;
    if (lo <= 0) a0 = 2 - lo, b0 = 2 * S - lo + 1;
    if (hi >= h) a1 = h + 1 - lo, b1 = h + 2 * S - lo;
    int t = march_to<false>(0, a0 / 3 * 3);
    t = march_to<true>(t, (b0 + 2) / 3 * 3);
    t = march_to<false>(t, a1 / 3 * 3);
    t = march_to<true>(t, (b1 + 2) / 3 * 3);
    march_to<false>(t, steps);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
};

template <int S>
__global__ void __launch_bounds__(LANES, 8)
jacobi2d_kernel(const float* __restrict__ x, float* __restrict__ y, int h,
                int w, Plan p, bool vec_in, bool vec_out) {
  __shared__ float4 ring[RING * LANES];
  const int lane = threadIdx.x;
  const int ix = blockIdx.x % p.nx, iy = blockIdx.x / p.nx;
  const int c0 = ix * p.strip - p.halo;  // the strip's first loaded column
  const int r0 = iy * p.seg;
  const int r1 = r0 + p.seg < h ? r0 + p.seg : h;
  const int c = c0 + V * lane;
  const bool own = lane >= p.halo / V && lane < LANES - p.halo / V && c < w;
  unsigned keep[V];
#pragma unroll
  for (int j = 0; j < V; ++j) keep[j] = c + j > 0 && c + j < w - 1 ? ~0u : 0u;
  March<S> m{x, y, h, w, r0 - S, r1 + S, r0, r1, c, own, vec_in, vec_out,
             {keep[0], keep[1], keep[2], keep[3]}, ring, lane};
  m.run();
}

template <int S>
cudaError_t launch(const float* x, float* y, int h, int w,
                   cudaStream_t stream) {
  const Plan p = make_plan(h, w, S);
  const bool vec_in = w % V == 0 && tpkt_aligned16(x);
  const bool vec_out = w % V == 0 && tpkt_aligned16(y);
  const long long blocks = static_cast<long long>(p.nx) * p.ny;
  jacobi2d_kernel<S><<<static_cast<unsigned>(blocks), LANES, 0, stream>>>(
      x, y, h, w, p, vec_in, vec_out);
  return cudaGetLastError();
}

}  // namespace

TPKT_EXPORT int tpkt_jacobi2d_pass(const void* x, void* y, int h, int w,
                                   int sweeps, void* stream) {
  const auto* in = static_cast<const float*>(x);
  auto* out = static_cast<float*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  if (h < 1 || w < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (sweeps) {
    case 1: return static_cast<int>(launch<1>(in, out, h, w, st));
    case 2: return static_cast<int>(launch<2>(in, out, h, w, st));
    case 3: return static_cast<int>(launch<3>(in, out, h, w, st));
    case 4: return static_cast<int>(launch<4>(in, out, h, w, st));
    case 5: return static_cast<int>(launch<5>(in, out, h, w, st));
    case 6: return static_cast<int>(launch<6>(in, out, h, w, st));
    case 7: return static_cast<int>(launch<7>(in, out, h, w, st));
    case 8: return static_cast<int>(launch<8>(in, out, h, w, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The launch geometry of one pass: out[0..4] = halo, owned strip width,
// segment height, strips, segments (stencil.py:plan2d computes the same).
TPKT_EXPORT int tpkt_jacobi2d_plan(int h, int w, int sweeps, int* out) {
  if (h < 1 || w < 1 || sweeps < 1 || sweeps > HALO_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(h, w, sweeps);
  out[0] = p.halo;
  out[1] = p.strip;
  out[2] = p.seg;
  out[3] = p.nx;
  out[4] = p.ny;
  return 0;
}
