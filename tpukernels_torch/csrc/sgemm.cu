// SGEMM: out = alpha * A @ B + beta * C, float32 out, any (m, n, k).
//
// Replaces tpukernels/kernels/sgemm.py:_sgemm_kernel in its three operand
// modes (see sgemm.cuh for the modes, the tile and the compute step).
// Each block owns one BM x 128 output tile and walks K in a loop inside
// the block (the TPU's sequential K grid axis), one shared-memory stage
// of BK at a time: load, __syncthreads, compute, __syncthreads. The
// tile (BM 128/64, BK 32/64) and the grid order (ij/ji) are the
// wrapper's knobs, TPKT_SGEMM_{BM,BK,ORDER}. sgemm_pipelined.cu (B2) runs
// the same compute step on a ring of stages.
//
// In the bf16 modes A is (m, k) and B is given transposed, (n, k), both
// row-major, so both tiles load the same way: 16-byte loads along k when
// k % 8 == 0, masked scalar loads otherwise. In the fp32 mode A is
// (m, k), stored k-major in shared memory by scalar loads (it cannot be
// transposed on the way in otherwise), and B is (k, n). Ragged edges are masked in the loads (zeros) and the epilogue
// (no store), so the wrapper neither pads nor copies.
//
// Bound on the card at 1024^3: operations. 'high' is 3 x 2.15 GFLOP of
// bf16 tensor work; 'float32' is 2.15 GFLOP on the fp32 units. With one
// stage a block waits for each stage's loads before it computes, and
// mma.sync (not wgmma) sits well below either peak.
#include "sgemm.cuh"

namespace {

using namespace tpkt_gemm;

// ROWS x BK tile of a row-major (nrows, K) bf16 matrix -> smem[ROWS][LDS].
template <int ROWS, int BK, int LDS>
__device__ __forceinline__ void load_bf16_tile(uint16_t* smem,
                                               const uint16_t* g, int nrows,
                                               int K, int row0, int k0,
                                               bool vec) {
  constexpr int CPR = BK / 8;  // 8-element chunks per row
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

template <int MODE, int BM, int BK>
__global__ void __launch_bounds__(THREADS) sgemm_kernel(Args p) {
  using T = Tile<MODE, BM, BK>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int ti, tj;
  tile_of(p.ji, &ti, &tj);
  const int m0 = ti * BM, n0 = tj * BN;
  const int M = p.M, N = p.N, K = p.K;

  if constexpr (MODE == MODE_FP32) {
    float* As = reinterpret_cast<float*>(smem_raw);  // A^T [BK][LDA32]
    float* Bs = As + BK * T::LDA32;                  // B   [BK][BN]
    const float* A = static_cast<const float*>(p.a0);
    const float* B = static_cast<const float*>(p.b0);
    FmaAcc<BM, BK> acc;
    acc.init();
    for (int k0 = 0; k0 < K; k0 += BK) {
      // a warp reads 8 consecutive k of 4 rows and stores them to 32
      // distinct banks of the k-major tile
      for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
        const int kk = e / (8 * BM) * 8 + e % 8, r = e / 8 % BM;
        const int gr = m0 + r, gk = k0 + kk;
        As[kk * T::LDA32 + r] =
            (gr < M && gk < K) ? A[(long long)gr * K + gk] : 0.0f;
      }
      for (int e = threadIdx.x; e < BK * BN; e += THREADS) {
        const int kk = e / BN, cc = e % BN;
        const int gk = k0 + kk, gc = n0 + cc;
        Bs[kk * BN + cc] =
            (gk < K && gc < N) ? B[(long long)gk * N + gc] : 0.0f;
      }
      __syncthreads();
      acc.step(As, Bs);
      __syncthreads();
    }
    acc.store(p, m0, n0);
  } else {
    constexpr int NOPS = T::NOPS, LDS = T::LDS;
    uint16_t* As = reinterpret_cast<uint16_t*>(smem_raw);  // [NOPS][BM][LDS]
    uint16_t* Bs = As + NOPS * BM * LDS;                     // [NOPS][BN][LDS]
    const uint16_t* Ag[2] = {static_cast<const uint16_t*>(p.a0),
                             static_cast<const uint16_t*>(p.a1)};
    const uint16_t* Bg[2] = {static_cast<const uint16_t*>(p.b0),
                             static_cast<const uint16_t*>(p.b1)};
    const bool vec = (K % 8) == 0;
    MmaAcc<MODE, BM, BK> acc;
    acc.init();
    for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
      for (int op = 0; op < NOPS; ++op) {
        load_bf16_tile<BM, BK, LDS>(As + op * BM * LDS, Ag[op], M, K, m0, k0,
                                    vec);
        load_bf16_tile<BN, BK, LDS>(Bs + op * BN * LDS, Bg[op], N, K, n0, k0,
                                    vec);
      }
      __syncthreads();
      acc.step(As, Bs);
      __syncthreads();
    }
    acc.store(p, m0, n0);
  }
}

template <int MODE, int BM, int BK>
cudaError_t launch(const Args& p, cudaStream_t s) {
  constexpr int bytes = Tile<MODE, BM, BK>::STAGE_BYTES;
  cudaError_t e = allow_smem(sgemm_kernel<MODE, BM, BK>, bytes);
  if (e != cudaSuccess) return e;
  sgemm_kernel<MODE, BM, BK><<<grid_of(p, BM), THREADS, bytes, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

// mode: 0 split3 (a0/a1 = A hi/lo, b0/b1 = B^T hi/lo, bf16),
//       1 float32 (a0 = A (m,k), b0 = B (k,n), f32),
//       2 bf16    (a0 = A (m,k), b0 = B^T (n,k), bf16).
// bm 128 or 64, bn 128, bk 32 or 64; ji 0 for the 'ij' grid order, 1
// for 'ji'.
TPKT_EXPORT int tpkt_sgemm(int mode, const void* a0, const void* a1,
                           const void* b0, const void* b1, const void* c,
                           void* out, int M, int N, int K, float alpha,
                           float beta, int bm, int bn, int bk, int ji,
                           void* stream) {
  if (M < 1 || N < 1 || K < 0 || bn != BN)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args p{a0, a1, b0, b1, static_cast<const float*>(c),
               static_cast<float*>(out), M, N, K, K, K, alpha, beta, ji};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (mode) {
    case MODE_SPLIT3:
      e = TPKT_GEMM_BY_TILE(launch, MODE_SPLIT3, bm, bk, p, s);
      break;
    case MODE_FP32:
      e = TPKT_GEMM_BY_TILE(launch, MODE_FP32, bm, bk, p, s);
      break;
    case MODE_BF16:
      e = TPKT_GEMM_BY_TILE(launch, MODE_BF16, bm, bk, p, s);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
