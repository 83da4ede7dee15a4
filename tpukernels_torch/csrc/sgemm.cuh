// Device code shared by the two SGEMM kernels: sgemm.cu (B1, one
// shared-memory stage, synchronous loads) and sgemm_pipelined.cu (B2, a
// ring of `depth` stages fed by cp.async). Both take their tile from
// the same template parameters and run the SAME compute step on a
// loaded stage and the SAME epilogue, so at one tile and mode they sum
// every output in the same order: B2's result equals B1's bitwise.
//
// A block of 256 threads owns one BM x BN output tile (BN = 128; BM 128
// or 64) and walks K in stages of BK (32 or 64) elements.
//
//   MODE_SPLIT3 ('high'): bf16 hi/lo halves of A and B^T; per 16-wide k
//                chunk mma.sync m16n8k16 hi*hi, then hi*lo, then lo*hi.
//   MODE_BF16   ('default'): one bf16 product, mma.sync as above.
//   MODE_FP32   ('float32'): fp32 FMAs on the CUDA cores, each output
//                summed over k in order, (BM/16) x 8 outputs a thread.
//
// Shared-memory layout of one stage:
//   bf16 modes: NOPS x A[BM][BK+8], then NOPS x B^T[BN][BK+8] (bf16; the
//               8-element pad keeps the fragment loads conflict-free);
//   fp32 mode:  A^T[BK][BM+4], then B[BK][BN] (float).
#pragma once

#include <type_traits>

#include "common.cuh"

namespace tpkt_gemm {

enum Mode { MODE_SPLIT3 = 0, MODE_FP32 = 1, MODE_BF16 = 2 };

constexpr int THREADS = 256, BN = 128;

// Operands and shape of one call. bf16 modes: a0/a1 = A (M, lda) hi/lo,
// b0/b1 = B^T (N, ldb) hi/lo, row-major. fp32 mode: B1 reads A (M, K)
// and B (K, N); B2 reads A^T (K, lda) and B (K, ldb).
struct Args {
  const void* a0;
  const void* a1;
  const void* b0;
  const void* b1;
  const float* c;
  float* out;
  int M, N, K, lda, ldb;
  float alpha, beta;
  int ji;  // grid order: 0 'ij' (j fastest within a row of i), 1 'ji'
};

template <int MODE, int BM, int BK>
struct Tile {
  static constexpr int NOPS = MODE == MODE_SPLIT3 ? 2 : 1;
  // bf16 modes: 8 warps as WARPS_M x WARPS_N, 32 x WN outputs a warp
  static constexpr int LDS = BK + 8;
  static constexpr int WARPS_M = BM / 32, WARPS_N = 8 / WARPS_M;
  static constexpr int WN = BN / WARPS_N;
  static constexpr int MT = 2, NT = WN / 8;
  // fp32 mode: 16 x 16 threads, TM x TN outputs a thread
  static constexpr int LDA32 = BM + 4;
  static constexpr int TM = BM / 16, TN = BN / 16;
  static constexpr int STAGE_BYTES =
      MODE == MODE_FP32 ? BK * (LDA32 + BN) * 4 : NOPS * (BM + BN) * LDS * 2;
  static_assert(BM == 64 || BM == 128, "BM is 64 or 128");
  static_assert(BK % 16 == 0, "BK is a multiple of 16");
};

// Above 48 KB a block gets dynamic shared memory only on request; the
// request holds for the current device, so it is made on every call.
template <typename Kernel>
static cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

static inline dim3 grid_of(const Args& p, int bm) {
  const unsigned gm = static_cast<unsigned>(tpkt_cdiv(p.M, bm));
  const unsigned gn = static_cast<unsigned>(tpkt_cdiv(p.N, BN));
  return p.ji ? dim3(gm, gn) : dim3(gn, gm);
}

// (row, column) of the block's output tile, in tiles
__device__ __forceinline__ void tile_of(int ji, int* ti, int* tj) {
  *ti = ji ? blockIdx.x : blockIdx.y;
  *tj = ji ? blockIdx.y : blockIdx.x;
}

__device__ __forceinline__ void mma_bf16_16816(float* d, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---- bf16 modes ----------------------------------------------------------

template <int MODE, int BM, int BK>
struct MmaAcc {
  using T = Tile<MODE, BM, BK>;
  float v[T::MT][T::NT][4];
  int wm, wn, g, t;  // warp's tile offset; lane's group and thread

  __device__ __forceinline__ void init() {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    wm = (warp / T::WARPS_N) * 32;
    wn = (warp % T::WARPS_N) * T::WN;
    g = lane / 4;
    t = lane % 4;
#pragma unroll
    for (int i = 0; i < T::MT; ++i)
#pragma unroll
      for (int j = 0; j < T::NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) v[i][j][q] = 0.0f;
  }

  // One loaded stage: As = NOPS x [BM][LDS], Bs = NOPS x [BN][LDS].
  __device__ __forceinline__ void step(const uint16_t* As,
                                       const uint16_t* Bs) {
    constexpr int LDS = T::LDS, NOPS = T::NOPS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[NOPS][T::MT][4], bf[NOPS][T::NT][2];
#pragma unroll
      for (int op = 0; op < NOPS; ++op) {
        const uint16_t* as = As + op * BM * LDS;
        const uint16_t* bs = Bs + op * BN * LDS;
#pragma unroll
        for (int i = 0; i < T::MT; ++i) {
          const uint16_t* p = as + (wm + i * 16 + g) * LDS + kk + 2 * t;
          af[op][i][0] = *reinterpret_cast<const uint32_t*>(p);
          af[op][i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS);
          af[op][i][2] = *reinterpret_cast<const uint32_t*>(p + 8);
          af[op][i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS + 8);
        }
#pragma unroll
        for (int j = 0; j < T::NT; ++j) {
          const uint16_t* p = bs + (wn + j * 8 + g) * LDS + kk + 2 * t;
          bf[op][j][0] = *reinterpret_cast<const uint32_t*>(p);
          bf[op][j][1] = *reinterpret_cast<const uint32_t*>(p + 8);
        }
      }
#pragma unroll
      for (int i = 0; i < T::MT; ++i)
#pragma unroll
        for (int j = 0; j < T::NT; ++j) {
          mma_bf16_16816(v[i][j], af[0][i], bf[0][j]);
          if constexpr (MODE == MODE_SPLIT3) {
            mma_bf16_16816(v[i][j], af[0][i], bf[1][j]);  // hi * lo
            mma_bf16_16816(v[i][j], af[1][i], bf[0][j]);  // lo * hi
          }
        }
    }
  }

  // out = alpha * acc + beta * C; C is always read, so beta = 0 with NaN
  // in C gives NaN, as in the reference
  __device__ __forceinline__ void store(const Args& p, int m0, int n0) {
#pragma unroll
    for (int i = 0; i < T::MT; ++i)
#pragma unroll
      for (int j = 0; j < T::NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int gr = m0 + wm + i * 16 + g + (q >= 2 ? 8 : 0);
          const int gc = n0 + wn + j * 8 + 2 * t + (q & 1);
          if (gr < p.M && gc < p.N) {
            const long long o = (long long)gr * p.N + gc;
            p.out[o] = p.alpha * v[i][j][q] + p.beta * p.c[o];
          }
        }
  }
};

// ---- fp32 mode -----------------------------------------------------------

template <int BM, int BK>
struct FmaAcc {
  using T = Tile<MODE_FP32, BM, BK>;
  float v[T::TM][T::TN];
  int ty, tx;

  __device__ __forceinline__ void init() {
    ty = threadIdx.x / 16;
    tx = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < T::TM; ++i)
#pragma unroll
      for (int j = 0; j < T::TN; ++j) v[i][j] = 0.0f;
  }

  // One loaded stage: As = A^T[BK][LDA32], Bs = B[BK][BN].
  __device__ __forceinline__ void step(const float* As, const float* Bs) {
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[T::TM], bv[T::TN];
#pragma unroll
      for (int q = 0; q < T::TM / 4; ++q) {
        const float4 u = reinterpret_cast<const float4*>(
            As + kk * T::LDA32 + ty * T::TM)[q];
        av[4 * q] = u.x; av[4 * q + 1] = u.y;
        av[4 * q + 2] = u.z; av[4 * q + 3] = u.w;
      }
#pragma unroll
      for (int q = 0; q < T::TN / 4; ++q) {
        const float4 u = reinterpret_cast<const float4*>(
            Bs + kk * BN + tx * T::TN)[q];
        bv[4 * q] = u.x; bv[4 * q + 1] = u.y;
        bv[4 * q + 2] = u.z; bv[4 * q + 3] = u.w;
      }
#pragma unroll
      for (int i = 0; i < T::TM; ++i)
#pragma unroll
        for (int j = 0; j < T::TN; ++j) v[i][j] = fmaf(av[i], bv[j], v[i][j]);
    }
  }

  __device__ __forceinline__ void store(const Args& p, int m0, int n0) {
#pragma unroll
    for (int i = 0; i < T::TM; ++i) {
      const int gr = m0 + ty * T::TM + i;
      if (gr >= p.M) continue;
#pragma unroll
      for (int j = 0; j < T::TN; ++j) {
        const int gc = n0 + tx * T::TN + j;
        if (gc < p.N) {
          const long long o = (long long)gr * p.N + gc;
          p.out[o] = p.alpha * v[i][j] + p.beta * p.c[o];
        }
      }
    }
  }
};

}  // namespace tpkt_gemm

// Instantiate `launch<MODE, BM, BK>` (a function template of the including
// source) for the tile a call asks for; other tiles are refused.
#define TPKT_GEMM_BY_TILE(launch, MODE, bm, bk, ...)                    \
  ((bm) == 128 && (bk) == 32   ? launch<MODE, 128, 32>(__VA_ARGS__)     \
   : (bm) == 128 && (bk) == 64 ? launch<MODE, 128, 64>(__VA_ARGS__)     \
   : (bm) == 64 && (bk) == 32  ? launch<MODE, 64, 32>(__VA_ARGS__)      \
   : (bm) == 64 && (bk) == 64  ? launch<MODE, 64, 64>(__VA_ARGS__)      \
                               : cudaErrorInvalidValue)
