// 3-D 7-point Jacobi, temporally blocked: one launch runs `sweeps`
// (1..8) fused sweeps of a (d, h, w) float32 grid, x -> y.
//
// Replaces tpukernels/kernels/stencil.py:_jacobi3d_small_kernel and
// _jacobi3d_blocked_kernel. The TPU needed two paths because a grid
// either fits its VMEM or is cut into z-slabs of whole (h, w) planes
// with ghost planes; here one kernel serves every size.
//
// Bound on the card (H100 SXM, 384^3 x 8 sweeps): the grid is 226 MB,
// more than the 50 MB L2, so every launch reads and writes it from HBM:
// 8 B a cell a pass, 0.1352 ms for one pass. The 6 flops of a
// cell-sweep (5 adds and a multiply, no FMA) at 67 TFLOP/s are 0.041
// ms for all 8 sweeps. So the kernel has to fuse as many sweeps a pass
// as it can keep on chip, at few instructions and little shared-memory
// traffic a cell-sweep.
//
// Design: a z-march, the 2-D kernel's register wavefront (jacobi2d.cu)
// one dimension up. A block owns a (y, x) tile of columns and a segment
// of planes in z. It loads a window of the tile with a halo of `sweeps`
// rows in y and HX columns in x (sweeps rounded up to V, so that a
// lane's columns are one 16-byte copy), and the segment's planes with
// `sweeps` planes before and after it; it marches through the planes
// one a step. There is no halo in z beyond those planes: the window
// holds whole columns of the march. A thread holds V = 4 adjacent
// columns of R rows; a warp is LY rows of LANES / LY lanes; a block W
// warps stacked in y. A step brings one new plane (level 0) from a
// per-thread ring of `depth` slots of cp.async copies, then computes
// every level s = 1..sweeps once: level s at plane p - s from level
// s-1's planes p - s - 1 (held), p - s (held) and p - s + 1 (made by
// level s-1 earlier in this step). Each level keeps only its last two
// planes, in registers, in two slots named at compile time (the step is
// unrolled by two). In-plane neighbours come from registers (rows of
// the thread), warp shuffles (x, and y between the lane rows of a warp)
// and, for the warp's top and bottom rows only, a small shared array
// per level: a level's new plane publishes those two rows, which the
// next step reads, so a step needs one block barrier. Level `sweeps` of
// each owned cell is stored, 16 bytes a thread a row. The sweep count
// is a template parameter, so each level's registers are named at
// compile time: ptxas must report no spills. (LY, R) is a table by
// sweep count: the registers a thread has (255 at one 256-thread block
// a SM) must hold 8 * sweeps * R values of state, so the deeper the
// fusion, the fewer rows a thread and the smaller the window against
// its halo (at 384^3 the cells loaded and swept a pass are 1.59x the
// grid's at k = 4, 2.89x at k = 8).
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W): 384^3 x 8
// at k = 4 (two passes) in 0.45 ms, 1.7x the passes' HBM floor; one
// pass at k = 8 takes 0.77 ms, so it is not the default. 232..255
// registers a thread, no spills.
//
// The exact-cell argument (jacobi2d.cu's, in three dimensions): a value
// at level s is exact when it lies at distance >= s from the loaded
// window's edge in x, y and z. Values outside the window (planes not
// yet loaded, the lanes' and warps' missing neighbours, a ring slot or
// shared row not yet written) are never exact and never stored. Cells
// outside the grid load as 0.
//
// Dirichlet boundary: the interior test uses the TRUE (d, h, w); cells
// on the boundary are held as loaded. Columns and rows are held by a
// thread-constant bit mask in every update (one LOP3 a cell after one
// AND); planes 0 and d - 1 by a select on the plane, only in the steps
// at which some level is at one of them. Neither is a branch around a
// cell (jacobi2d.cu says why). The sum is ((((z-1 + z+1) + y-1) + y+1)
// + x-1) + x+1, then * (1/6), the order of the reference, through
// __fadd_rn / __fmul_rn, which are never contracted into an FMA: the
// result is bitwise that of the plain PyTorch sweep.
//
// Blocks run in no order and neighbouring blocks still read the old
// grid, so a launch reads x and writes a different buffer y; the
// wrapper alternates two buffers between launches.
//
// The launch geometry is make_plan below; tpukernels_torch/kernels/
// stencil.py:plan3d computes the same, and the wrapper checks the two
// agree (tpkt_jacobi3d_plan) before a shape's first launch.
#include "common.cuh"

namespace {

constexpr int V = 4;            // columns a thread holds: one float4
constexpr int LANES = 32;
constexpr int HALO3D_MAX = 8;   // most fused sweeps per launch
constexpr int RING_MAX = 3;     // most plane slots of a thread's ring
constexpr int SEG_MIN = 16;     // fewest owned planes a segment
constexpr int WARPS = 8;        // warps a block, stacked in y
constexpr unsigned FULL = 0xffffffffu;

// The thread at each sweep count S: lane rows a warp and rows a thread
// (index S; stencil.py:GEOMETRY3D holds the same table).
constexpr int kLaneRows[HALO3D_MAX + 1] = {0, 1, 1, 2, 2, 2, 2, 2, 2};
constexpr int kRows[HALO3D_MAX + 1] = {0, 8, 8, 4, 4, 3, 3, 2, 2};

template <int S>
struct Geo {
  static constexpr int W = WARPS, LY = kLaneRows[S], R = kRows[S];
  static constexpr int LX = LANES / LY;           // lanes a row of a warp
  static constexpr int T = W * LANES;             // threads a block
  static constexpr int WX = V * LX;               // columns a block loads
  static constexpr int WY = W * LY * R;           // rows a block loads
  static constexpr int HX = (S + V - 1) / V * V;  // halo columns a side
  static constexpr int EDGE = W * 2 * LX;         // float4s a level's edges
  static_assert(LANES % LY == 0 && WX > 2 * HX && WY > 2 * S,
                "a block owns cells");
};

struct Plan {
  int halo;    // loaded columns beyond the owned ones, each side
  int strip;   // owned columns a block
  int rows;    // owned rows a block
  int seg;     // owned planes a block
  int nx, ny, nz;
};

// z-segments are cut for the fewest waves x steps a block: a block
// marches seg + 2 * sweeps steps, and the launch takes that many steps
// once a wave of `sms` blocks (one a SM of the card)
Plan make_plan(int d, int h, int w, int s, int sms) {
  Plan p;
  const int wx = V * LANES / kLaneRows[s];
  const int wy = WARPS * kLaneRows[s] * kRows[s];
  p.halo = (s + V - 1) / V * V;
  p.strip = wx - 2 * p.halo;
  p.rows = wy - 2 * s;
  p.nx = static_cast<int>(tpkt_cdiv(w, p.strip));
  p.ny = static_cast<int>(tpkt_cdiv(h, p.rows));
  const long long bxy = static_cast<long long>(p.nx) * p.ny;
  const int most = d / SEG_MIN > 1 ? d / SEG_MIN : 1;
  long long best = -1;
  for (int n = 1; n <= most; ++n) {
    const int seg = static_cast<int>(tpkt_cdiv(d, n));
    const int nz = static_cast<int>(tpkt_cdiv(d, seg));
    const long long cost = tpkt_cdiv(bxy * nz, sms) * (seg + 2 * s);
    if (best < 0 || cost < best) {
      best = cost;
      p.seg = seg;
      p.nz = nz;
    }
  }
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

// a ? b : c as a select, not a branch around the stencil's adds
__device__ __forceinline__ float pick(bool a, float b, float c) {
  float r;
  asm("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %1, 0;\n\t"
      "selp.f32 %0, %2, %3, p;\n\t}"
      : "=f"(r)
      : "r"(static_cast<int>(a)), "f"(b), "f"(c));
  return r;
}

// One thread's march of `S` sweeps.
template <int S>
struct March {
  using G = Geo<S>;
  static constexpr int R = G::R;
  const float* x;
  float* y;
  int d, h, w;
  int lo, len;        // first loaded plane (S before the owned ones), owned
  int c;              // the thread's first column
  int g0;             // the thread's first row
  int depth;          // ring slots
  int ly;             // the thread's lane row in its warp
  bool vec_in, vec_out;
  bool own_col;       // the thread's columns are owned
  unsigned own_row;   // bit r: row g0 + r is owned
  unsigned row_in;    // bit r: row g0 + r lies in the grid
  unsigned keepx[V];  // all ones where column c + j is not on the boundary
  unsigned keepy[R];  // all ones where row g0 + r is not on the boundary
  float4* ring;       // [depth][R][T] float4s, this thread's at + 0
  float4* edge;       // [S levels][2 parities][W warps][top, bottom][LX]
  int north, south;   // edge offsets of the rows above and below
  int top, bottom;    // edge offsets of the thread's own edge rows
  // set by run()
  int rs, ws;         // ring slots read and written this step
  int plo, phi;       // planes the ring copies: [plo, phi)
  long long src;      // offset in x of the next plane to fetch, row g0, col c
  long long dst;      // offset in y of the plane level S reaches next
  long long hw;
  float lv[S][2][R][V];  // levels 0..S-1, slot t % 2 holds step t's plane

  // copy plane `pl` into ring slot ws, one commit group (empty outside
  // the planes to copy, so the wait count stays one group a step)
  __device__ __forceinline__ void fetch(int pl) {
    const bool plane = pl >= plo && pl < phi;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float4* dp = ring + (ws * R + r) * G::T;
      const long long o = src + static_cast<long long>(r) * w;
      const bool row = plane && ((row_in >> r) & 1u);
      if (vec_in) {
        const bool read = row && c >= 0 && c < w;
        copy16(dp, read ? x + o : x, read);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const bool read = row && c + j >= 0 && c + j < w;
          copy4(reinterpret_cast<float*>(dp) + j, read ? x + o + j : x,
                read);
        }
      }
    }
    src += hw;
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  // until the plane of this step has landed: all but the newest
  // depth - 1 groups (the count is an immediate)
  __device__ __forceinline__ void wait_ring() const {
    switch (depth) {
      case 1: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
      case 2: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
      default: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    }
  }

  // the rows above row 0 and below row R-1 of level `lvl`'s plane m,
  // made a step ago: from the lane row above / below in the warp, or at
  // the warp's top and bottom from the warp above / below (parity par)
  __device__ __forceinline__ void neighbours(int lvl, int par,
                                             const float (&m)[R][V],
                                             float (&up)[V],
                                             float (&dn)[V]) const {
    const float4* e = edge + (lvl * 2 + par) * G::EDGE;
    if (G::LY == 1) {
      const float4 u = e[north], b = e[south];
      up[0] = u.x, up[1] = u.y, up[2] = u.z, up[3] = u.w;
      dn[0] = b.x, dn[1] = b.y, dn[2] = b.z, dn[3] = b.w;
      return;
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      up[j] = __shfl_up_sync(FULL, m[R - 1][j], G::LX);
      dn[j] = __shfl_down_sync(FULL, m[0][j], G::LX);
    }
    if (ly == 0) {
      const float4 u = e[north];
      up[0] = u.x, up[1] = u.y, up[2] = u.z, up[3] = u.w;
    }
    if (ly == G::LY - 1) {
      const float4 b = e[south];
      dn[0] = b.x, dn[1] = b.y, dn[2] = b.z, dn[3] = b.w;
    }
  }

  // the warp's top and bottom rows of level `lvl`'s new plane n
  __device__ __forceinline__ void publish(int lvl, int par,
                                          const float (&n)[R][V]) const {
    float4* e = edge + (lvl * 2 + par) * G::EDGE;
    if (ly == 0) e[top] = make_float4(n[0][0], n[0][1], n[0][2], n[0][3]);
    if (ly == G::LY - 1)
      e[bottom] = make_float4(n[R - 1][0], n[R - 1][1], n[R - 1][2],
                              n[R - 1][3]);
  }

  // level s's plane q from level s-1's planes q-1 (a), q (m) and q+1
  // (n); up / dn: m's rows beyond the thread's. ZB: q may be plane 0 or
  // d - 1 (plane_in false there)
  template <bool ZB>
  __device__ __forceinline__ void update(const float (&a)[R][V],
                                         const float (&m)[R][V],
                                         const float (&n)[R][V],
                                         const float (&up)[V],
                                         const float (&dn)[V],
                                         bool plane_in,
                                         float (&out)[R][V]) const {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float wl = __shfl_up_sync(FULL, m[r][V - 1], 1);
      const float er = __shfl_down_sync(FULL, m[r][0], 1);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float no = r > 0 ? m[r - 1][j] : up[j];
        const float so = r < R - 1 ? m[r + 1][j] : dn[j];
        const float we = j > 0 ? m[r][j - 1] : wl;
        const float ea = j < V - 1 ? m[r][j + 1] : er;
        float v = __fmul_rn(
            __fadd_rn(
                __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(a[r][j], n[r][j]),
                                              no),
                                    so),
                          we),
                ea),
            1.0f / 6.0f);
        const unsigned k = keepx[j] & keepy[r];
        if (ZB) {
          v = pick(plane_in & (k != 0u), v, m[r][j]);
        } else {  // one LOP3: v where kept, else the held value
          v = __uint_as_float((__float_as_uint(v) & k) |
                              (__float_as_uint(m[r][j]) & ~k));
        }
        out[r][j] = v;
      }
    }
  }

  __device__ __forceinline__ void store(const float (&v)[R][V]) const {
    if (!own_col) return;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (!((own_row >> r) & 1u)) continue;
      float* p = y + dst + static_cast<long long>(r) * w;
      if (vec_out && c + V <= w) {
        *reinterpret_cast<float4*>(p) =
            make_float4(v[r][0], v[r][1], v[r][2], v[r][3]);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j)
          if (c + j < w) p[j] = v[r][j];
      }
    }
  }

  // step t: plane p = lo + t arrives (level 0); level s moves to p - s
  template <int P, bool ZB>
  __device__ __forceinline__ void step(int t) {
    // the slot read a step ago takes plane p + depth - 1
    fetch(lo + t + depth - 1);
    wait_ring();
    float nw[R][V];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 g = ring[(rs * R + r) * G::T];
      nw[r][0] = g.x, nw[r][1] = g.y, nw[r][2] = g.z, nw[r][3] = g.w;
    }
    ws = rs;
    rs = rs + 1 == depth ? 0 : rs + 1;
#pragma unroll
    for (int s = 1; s <= S; ++s) {
      const int q = lo + t - s;
      float up[V], dn[V], out[R][V];
      neighbours(s - 1, 1 - P, lv[s - 1][1 - P], up, dn);
      update<ZB>(lv[s - 1][P], lv[s - 1][1 - P], nw, up, dn,
                 (q > 0) & (q < d - 1), out);
      publish(s - 1, P, nw);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < V; ++j) {
          lv[s - 1][P][r][j] = nw[r][j];
          nw[r][j] = out[r][j];
        }
    }
    // nw is level S at plane lo + t - S: owned from step 2S on
    if (static_cast<unsigned>(t - 2 * S) < static_cast<unsigned>(len))
      store(nw);
    dst += hw;
    __syncthreads();  // this step's edge rows are seen by the next
  }

  __device__ __forceinline__ void run(int hi) {
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int j = 0; j < V; ++j) lv[s][i][r][j] = 0.0f;
    hw = static_cast<long long>(h) * w;
    plo = lo > 0 ? lo : 0;
    phi = hi < d ? hi : d;
    src = lo * hw + static_cast<long long>(g0) * w + c;
    ws = 0;
    for (int i = 0; i + 1 < depth; ++i) {
      fetch(lo + i);
      ws = i + 1;
    }
    rs = 0;
    dst = (lo - S) * hw + static_cast<long long>(g0) * w + c;
    const int steps = len + 2 * S;
    // level s is at plane lo + t - s: the steps at which a level is at
    // plane 0 or d - 1 inside the window test the plane, the rest do not
    int a0 = 0, b0 = 0, a1 = 0, b1 = 0;
    if (lo <= 0) a0 = 1 - lo, b0 = S - lo + 1;
    if (hi >= d) a1 = d - lo, b1 = d - lo + S;
#pragma unroll 1
    for (int t = 0; t < steps; t += 2) {
      if ((t + 2 > a0 && t < b0) || (t + 2 > a1 && t < b1)) {
        step<0, true>(t);
        step<1, true>(t + 1);
      } else {
        step<0, false>(t);
        step<1, false>(t + 1);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
};

template <int S>
__global__ void __launch_bounds__(Geo<S>::T, 1)
jacobi3d_kernel(const float* __restrict__ x, float* __restrict__ y, int d,
                int h, int w, Plan p, int depth, bool vec_in,
                bool vec_out) {
  using G = Geo<S>;
  extern __shared__ float4 smem[];
  const int tid = threadIdx.x;
  const int warp = tid / LANES, lane = tid % LANES;
  const int lx = lane % G::LX, ly = lane / G::LX;
  const int bx = blockIdx.x % p.nx, byz = blockIdx.x / p.nx;
  const int by = byz % p.ny, bz = byz / p.ny;
  const int i0 = (warp * G::LY + ly) * G::R;  // window row of row 0
  const int z0 = bz * p.seg;
  const int z1 = z0 + p.seg < d ? z0 + p.seg : d;
  March<S> m;
  m.x = x;
  m.y = y;
  m.d = d, m.h = h, m.w = w;
  m.lo = z0 - S;
  m.len = z1 - z0;
  m.c = bx * p.strip - G::HX + V * lx;
  m.g0 = by * p.rows - S + i0;
  m.depth = depth;
  m.ly = ly;
  m.vec_in = vec_in, m.vec_out = vec_out;
  m.own_col = lx >= G::HX / V && lx < G::LX - G::HX / V && m.c < w;
  m.own_row = 0, m.row_in = 0;
#pragma unroll
  for (int r = 0; r < G::R; ++r) {
    const int g = m.g0 + r;
    if (i0 + r >= S && i0 + r < G::WY - S && g < h) m.own_row |= 1u << r;
    if (g >= 0 && g < h) m.row_in |= 1u << r;
    m.keepy[r] = g > 0 && g < h - 1 ? ~0u : 0u;
  }
#pragma unroll
  for (int j = 0; j < V; ++j)
    m.keepx[j] = m.c + j > 0 && m.c + j < w - 1 ? ~0u : 0u;
  m.ring = smem + tid;
  m.edge = smem + depth * G::R * G::T;
  const int up = warp > 0 ? warp - 1 : 0;
  const int dn = warp < G::W - 1 ? warp + 1 : G::W - 1;
  m.north = (up * 2 + 1) * G::LX + lx;
  m.south = (dn * 2) * G::LX + lx;
  m.top = (warp * 2) * G::LX + lx;
  m.bottom = (warp * 2 + 1) * G::LX + lx;
  m.run(z1 + S);
}

template <int S>
size_t smem_bytes(int depth) {
  using G = Geo<S>;
  return sizeof(float4) *
         (static_cast<size_t>(depth) * G::R * G::T + S * G::EDGE * 2);
}

template <int S>
cudaError_t launch(const float* x, float* y, int d, int h, int w, int depth,
                   int sms, cudaStream_t stream) {
  // one request per device for the largest ring, so every depth fits;
  // the carveout is left to the runtime, which sizes it to the request
  static TpktSmemMemo memo;
  cudaError_t err =
      tpkt_allow_smem_once(jacobi3d_kernel<S>, smem_bytes<S>(RING_MAX), memo);
  if (err != cudaSuccess) return err;
  const Plan p = make_plan(d, h, w, S, sms);
  const bool vec_in = w % V == 0 && tpkt_aligned16(x);
  const bool vec_out = w % V == 0 && tpkt_aligned16(y);
  const long long blocks = static_cast<long long>(p.nx) * p.ny * p.nz;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  jacobi3d_kernel<S><<<static_cast<unsigned>(blocks), Geo<S>::T,
                       smem_bytes<S>(depth), stream>>>(
      x, y, d, h, w, p, depth, vec_in, vec_out);
  return cudaGetLastError();
}

}  // namespace

// One pass of `sweeps` (1..8) sweeps through a ring of `depth`
// (1..RING_MAX) plane slots a thread, planned for a card of `sms` SMs;
// the wrapper clamps depth.
TPKT_EXPORT int tpkt_jacobi3d_pass(const void* x, void* y, int d, int h,
                                   int w, int sweeps, int depth, int sms,
                                   void* stream) {
  const auto* in = static_cast<const float*>(x);
  auto* out = static_cast<float*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  if (d < 1 || h < 1 || w < 1 || depth < 1 || depth > RING_MAX || sms < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (sweeps) {
    case 1:
      return static_cast<int>(launch<1>(in, out, d, h, w, depth, sms, st));
    case 2:
      return static_cast<int>(launch<2>(in, out, d, h, w, depth, sms, st));
    case 3:
      return static_cast<int>(launch<3>(in, out, d, h, w, depth, sms, st));
    case 4:
      return static_cast<int>(launch<4>(in, out, d, h, w, depth, sms, st));
    case 5:
      return static_cast<int>(launch<5>(in, out, d, h, w, depth, sms, st));
    case 6:
      return static_cast<int>(launch<6>(in, out, d, h, w, depth, sms, st));
    case 7:
      return static_cast<int>(launch<7>(in, out, d, h, w, depth, sms, st));
    case 8:
      return static_cast<int>(launch<8>(in, out, d, h, w, depth, sms, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The launch geometry of one pass on a card of `sms` SMs: out[0..6] =
// halo, owned strip width, owned rows, segment planes, strips, row
// tiles, segments (stencil.py:plan3d computes the same).
TPKT_EXPORT int tpkt_jacobi3d_plan(int d, int h, int w, int sweeps, int sms,
                                   int* out) {
  if (d < 1 || h < 1 || w < 1 || sweeps < 1 || sweeps > HALO3D_MAX ||
      sms < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(d, h, w, sweeps, sms);
  out[0] = p.halo;
  out[1] = p.strip;
  out[2] = p.rows;
  out[3] = p.seg;
  out[4] = p.nx;
  out[5] = p.ny;
  out[6] = p.nz;
  return 0;
}
