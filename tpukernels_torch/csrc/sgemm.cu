// SGEMM: out = alpha * A @ B + beta * C, float32 out, any (m, n, k).
//
// Replaces tpukernels/kernels/sgemm.py:_sgemm_kernel in its three operand
// modes. One templated kernel; each block owns one BM x BN output tile
// and walks K in a loop inside the block (the TPU's sequential K grid
// axis), accumulating in float32 registers; the epilogue writes
// alpha * acc + beta * C and always reads C, so beta = 0 with NaN in C
// gives NaN as in the reference.
//
//   MODE_SPLIT3  ('high'): A and B arrive pre-split into bf16 hi/lo
//                halves (the wrapper does the split, as _split_bf16
//                does); the kernel sums hi*hi + hi*lo + lo*hi with
//                mma.sync m16n8k16 bf16 -> f32.
//   MODE_BF16    ('default'): one bf16 product, mma.sync as above.
//   MODE_FP32    ('float32'): full fp32 FMAs on the CUDA cores (SIMT),
//                8 x 8 outputs per thread.
//
// In the bf16 modes A is (m, k) and B is given transposed, (n, k), both
// row-major, so both tiles load the same way: 16-byte vector loads
// along k when k % 8 == 0, masked scalar loads otherwise. Ragged edges
// are masked in the loads (zeros) and the epilogue (no store), so the
// wrapper neither pads nor copies.
//
// Bound on the card at 1024^3: operations. 'high' is 3 x 2.15 GFLOP of
// bf16 tensor work; 'float32' is 2.15 GFLOP on the fp32 units. This
// first version uses mma.sync (not wgmma) with a single shared-memory
// stage and no TMA, so it sits well below either peak; the multi-stage
// TMA/wgmma pipeline is later work.
#include "common.cuh"

namespace {

enum Mode { MODE_SPLIT3 = 0, MODE_FP32 = 1, MODE_BF16 = 2 };

constexpr int BM = 128, BN = 128, THREADS = 256;

// ---- bf16 modes: mma.sync tiles ----------------------------------------
constexpr int BK16 = 32;           // k per shared-memory stage (bf16)
constexpr int LDS = BK16 + 8;      // padded row, in bf16 elements
constexpr int WM = 32, WN = 64;    // warp tile: 4 x 2 warps
constexpr int MT = WM / 16, NT = WN / 8;

// ---- fp32 mode: SIMT tiles ----------------------------------------------
constexpr int BK32 = 8;            // k per stage (fp32)
constexpr int LDA32 = BM + 4;      // A stored k-major, padded

template <int MODE>
struct Smem {
  static constexpr int NOPS = MODE == MODE_SPLIT3 ? 2 : 1;
  static constexpr int bytes =
      MODE == MODE_FP32
          ? (BK32 * LDA32 + BK32 * BN) * 4
          : NOPS * (BM + BN) * LDS * 2;
};

__device__ __forceinline__ void mma_bf16_16816(float* d, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ROWS x BK16 tile of a row-major (nrows, K) bf16 matrix -> smem[ROWS][LDS].
template <int ROWS>
__device__ __forceinline__ void load_bf16_tile(uint16_t* smem,
                                               const uint16_t* g, int nrows,
                                               int K, int row0, int k0,
                                               bool vec) {
  constexpr int CPR = BK16 / 8;  // 8-element chunks per row
  for (int ch = threadIdx.x; ch < ROWS * CPR; ch += THREADS) {
    const int r = ch / CPR, kc = (ch % CPR) * 8;
    const int gr = row0 + r, gk = k0 + kc;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (gr < nrows) {
      const uint16_t* p = g + (long long)gr * K + gk;
      if (vec) {
        if (gk < K) v = *reinterpret_cast<const uint4*>(p);
      } else {
        uint16_t t[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) t[j] = (gk + j < K) ? p[j] : 0;
        v.x = t[0] | (uint32_t(t[1]) << 16);
        v.y = t[2] | (uint32_t(t[3]) << 16);
        v.z = t[4] | (uint32_t(t[5]) << 16);
        v.w = t[6] | (uint32_t(t[7]) << 16);
      }
    }
    *reinterpret_cast<uint4*>(smem + r * LDS + kc) = v;
  }
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
sgemm_kernel(const void* __restrict__ a0, const void* __restrict__ a1,
             const void* __restrict__ b0, const void* __restrict__ b1,
             const float* __restrict__ c, float* __restrict__ out, int M,
             int N, int K, float alpha, float beta) {
  __shared__ __align__(16) unsigned char smem_raw[Smem<MODE>::bytes];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;

  if constexpr (MODE == MODE_FP32) {
    float* As = reinterpret_cast<float*>(smem_raw);  // [BK32][LDA32]
    float* Bs = As + BK32 * LDA32;                   // [BK32][BN]
    const float* A = static_cast<const float*>(a0);
    const float* B = static_cast<const float*>(b0);
    const int ty = tid / 16, tx = tid % 16;  // 16 x 16 threads, 8 x 8 each
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < K; k0 += BK32) {
      for (int e = tid; e < BM * BK32; e += THREADS) {
        const int r = e / BK32, kk = e % BK32;
        const int gr = m0 + r, gk = k0 + kk;
        As[kk * LDA32 + r] =
            (gr < M && gk < K) ? A[(long long)gr * K + gk] : 0.0f;
      }
      for (int e = tid; e < BK32 * BN; e += THREADS) {
        const int kk = e / BN, cc = e % BN;
        const int gk = k0 + kk, gc = n0 + cc;
        Bs[kk * BN + cc] =
            (gk < K && gc < N) ? B[(long long)gk * N + gc] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK32; ++kk) {
        float av[8], bv[8];
        const float4* ap = reinterpret_cast<const float4*>(As + kk * LDA32 + ty * 8);
        const float4* bp = reinterpret_cast<const float4*>(Bs + kk * BN + tx * 8);
        float4 t0 = ap[0], t1 = ap[1], u0 = bp[0], u1 = bp[1];
        av[0] = t0.x; av[1] = t0.y; av[2] = t0.z; av[3] = t0.w;
        av[4] = t1.x; av[5] = t1.y; av[6] = t1.z; av[7] = t1.w;
        bv[0] = u0.x; bv[1] = u0.y; bv[2] = u0.z; bv[3] = u0.w;
        bv[4] = u1.x; bv[5] = u1.y; bv[6] = u1.z; bv[7] = u1.w;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int gr = m0 + ty * 8 + i;
      if (gr >= M) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int gc = n0 + tx * 8 + j;
        if (gc < N) {
          const long long o = (long long)gr * N + gc;
          out[o] = alpha * acc[i][j] + beta * c[o];
        }
      }
    }
  } else {
    constexpr int NOPS = Smem<MODE>::NOPS;
    uint16_t* As = reinterpret_cast<uint16_t*>(smem_raw);  // [NOPS][BM][LDS]
    uint16_t* Bs = As + NOPS * BM * LDS;                     // [NOPS][BN][LDS]
    const uint16_t* Ag[2] = {static_cast<const uint16_t*>(a0),
                             static_cast<const uint16_t*>(a1)};
    const uint16_t* Bg[2] = {static_cast<const uint16_t*>(b0),
                             static_cast<const uint16_t*>(b1)};
    const bool vec = (K % 8) == 0;
    const int warp = tid / 32, lane = tid % 32;
    const int wm = (warp / 2) * WM, wn = (warp % 2) * WN;
    const int g = lane / 4, t = lane % 4;

    float acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;

    for (int k0 = 0; k0 < K; k0 += BK16) {
#pragma unroll
      for (int op = 0; op < NOPS; ++op) {
        load_bf16_tile<BM>(As + op * BM * LDS, Ag[op], M, K, m0, k0, vec);
        load_bf16_tile<BN>(Bs + op * BN * LDS, Bg[op], N, K, n0, k0, vec);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK16; kk += 16) {
        uint32_t af[NOPS][MT][4], bf[NOPS][NT][2];
#pragma unroll
        for (int op = 0; op < NOPS; ++op) {
          const uint16_t* as = As + op * BM * LDS;
          const uint16_t* bs = Bs + op * BN * LDS;
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            const uint16_t* p = as + (wm + i * 16 + g) * LDS + kk + 2 * t;
            af[op][i][0] = *reinterpret_cast<const uint32_t*>(p);
            af[op][i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS);
            af[op][i][2] = *reinterpret_cast<const uint32_t*>(p + 8);
            af[op][i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS + 8);
          }
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const uint16_t* p = bs + (wn + j * 8 + g) * LDS + kk + 2 * t;
            bf[op][j][0] = *reinterpret_cast<const uint32_t*>(p);
            bf[op][j][1] = *reinterpret_cast<const uint32_t*>(p + 8);
          }
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            mma_bf16_16816(acc[i][j], af[0][i], bf[0][j]);
            if constexpr (MODE == MODE_SPLIT3) {
              mma_bf16_16816(acc[i][j], af[0][i], bf[1][j]);  // hi * lo
              mma_bf16_16816(acc[i][j], af[1][i], bf[0][j]);  // lo * hi
            }
          }
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int gr = m0 + wm + i * 16 + g + (q >= 2 ? 8 : 0);
          const int gc = n0 + wn + j * 8 + 2 * t + (q & 1);
          if (gr < M && gc < N) {
            const long long o = (long long)gr * N + gc;
            out[o] = alpha * acc[i][j][q] + beta * c[o];
          }
        }
  }
}

}  // namespace

// mode: 0 split3 (a0/a1 = A hi/lo, b0/b1 = B^T hi/lo, bf16),
//       1 float32 (a0 = A (m,k), b0 = B (k,n), f32),
//       2 bf16    (a0 = A (m,k), b0 = B^T (n,k), bf16).
TPKT_EXPORT int tpkt_sgemm(int mode, const void* a0, const void* a1,
                           const void* b0, const void* b1, const void* c,
                           void* out, int M, int N, int K, float alpha,
                           float beta, void* stream) {
  if (M < 1 || N < 1 || K < 0) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(tpkt_cdiv(N, BN)),
            static_cast<unsigned>(tpkt_cdiv(M, BM)));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* cp = static_cast<const float*>(c);
  float* op = static_cast<float*>(out);
  switch (mode) {
    case MODE_SPLIT3:
      sgemm_kernel<MODE_SPLIT3><<<grid, THREADS, 0, s>>>(a0, a1, b0, b1, cp, op,
                                                         M, N, K, alpha, beta);
      break;
    case MODE_FP32:
      sgemm_kernel<MODE_FP32><<<grid, THREADS, 0, s>>>(a0, a1, b0, b1, cp, op,
                                                       M, N, K, alpha, beta);
      break;
    case MODE_BF16:
      sgemm_kernel<MODE_BF16><<<grid, THREADS, 0, s>>>(a0, a1, b0, b1, cp, op,
                                                       M, N, K, alpha, beta);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
