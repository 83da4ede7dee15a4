// SGEMM: out = alpha * A @ B + beta * C, float32 out, any (m, n, k).
//
// Replaces tpukernels/kernels/sgemm.py:_sgemm_kernel (the reference's
// depth-1 path) in its three operand modes. That kernel's K blocks are
// double-buffered by Pallas (`buf = 2 if depth == 1`), and so are these:
// each block owns one BM x BN output tile and walks K through a ring of
// two shared-memory stages of BK = 64, with one full and one empty
// mbarrier a stage. One producer warp issues the TMA copies of stage
// kk + 1 while the consumers compute stage kk:
//
//   'high'    (MODE_SPLIT3): A hi/lo (m, kp) and B^T hi/lo (n, kp), bf16,
//             arrive in 128-byte-swizzled tiles; each consumer warpgroup
//             (64 rows of the tile) issues wgmma.m64nBNk16 per 16 k,
//             hi*hi, then hi*lo, then lo*hi into one f32 accumulator.
//   'default' (MODE_BF16): one bf16 product, wgmma as above.
//   'float32' (MODE_FP32): A^T (k, m4) and B (k, n4), f32, unswizzled;
//             256 consumer threads run fp32 FMAs on the CUDA cores (no
//             tensor-core input keeps fp32's 24 bits), each output summed
//             over k in order.
//
// The wrapper hands every operand with rows padded with zeros to whole
// 16 bytes (TMA needs 16-byte global strides); TMA fills what lies past
// the edge of m, n or k with zeros, and still counts those bytes, so the
// expected transaction bytes of a stage are always the whole boxes.
// A slot goes back to the producer when every consumer thread has
// arrived on its empty barrier: after wgmma.wait_group 0 (the products
// no longer read it), or after the last FMA step that reads it.
// Tiles BM, BN in {64, 128} (TPKT_SGEMM_BM/BN); the grid order ij/ji
// (TPKT_SGEMM_ORDER).
//
// Bound on the card at 1024^3: operations ('high' 3 x 2.15 GFLOP of bf16
// tensor work, 0.0065 ms; 'float32' 2.15 GFLOP on the fp32 units,
// 0.0321 ms). The 128 x 64 default tile gives 128 blocks at 1024^2 for
// 132 SMs.
#include "hopper.cuh"

namespace {

using namespace tpkt_hopper;

enum Mode { MODE_SPLIT3 = 0, MODE_FP32 = 1, MODE_BF16 = 2 };

constexpr int BK = 64;     // k a stage: one 128-byte row of bf16
constexpr int STAGES = 2;  // the reference's depth-1 double buffer

struct Args {
  const float* c;
  float* out;
  int M, N, K;  // K: the k extent walked (bf16 modes: k padded to 8)
  float alpha, beta;
  int ji;  // grid order: 0 'ij' (j fastest within a row of i), 1 'ji'
};

template <int MODE, int BM, int BN>
struct Cfg {
  static constexpr bool BF16 = MODE != MODE_FP32;
  static constexpr int NOPS = MODE == MODE_SPLIT3 ? 2 : 1;
  // bf16: one warpgroup per 64 rows; fp32: 16 x 16 threads
  static constexpr int CONSUMERS = BF16 ? BM / 64 * 128 : 256;
  static constexpr int THREADS = CONSUMERS + 32;  // + the producer warp
  static constexpr int ELEM = BF16 ? 2 : 4;
  static constexpr int A_BYTES = BM * BK * ELEM, B_BYTES = BN * BK * ELEM;
  static constexpr int STAGE_BYTES = NOPS * (A_BYTES + B_BYTES);
  // the ring, 1024 bytes to align it for the swizzle, 2 barriers a stage
  static constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + 16 * STAGES;
  static_assert(BM == 64 || BM == 128, "BM is 64 or 128");
  static_assert(BN == 64 || BN == 128, "BN is 64 or 128");
  static_assert(A_BYTES % 1024 == 0 && B_BYTES % 1024 == 0,
                "every tile starts 1024-aligned");
};

// out = alpha * acc + beta * C at (r, c) inside the matrix; C is always
// read, so beta = 0 with NaN in C gives NaN, as in the reference
__device__ __forceinline__ void store_one(const Args& p, int r, int c,
                                          float acc) {
  if (r < p.M && c < p.N) {
    const long long o = (long long)r * p.N + c;
    p.out[o] = p.alpha * acc + p.beta * p.c[o];
  }
}

// Consumers of the bf16 modes: warpgroup wg owns rows wg*64.. of the
// tile, 64 x BN accumulators (BN/2 a thread).
template <int MODE, int BM, int BN>
__device__ __forceinline__ void consume_bf16(const Args& p,
                                             unsigned char* ring,
                                             uint64_t* full, uint64_t* empty,
                                             int nk, int m0, int n0) {
  using C = Cfg<MODE, BM, BN>;
  const int wg = threadIdx.x / 128;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  for (int kk = 0; kk < nk; ++kk) {
    const int s = kk % STAGES;
    mbar_wait(&full[s], (kk / STAGES) & 1);
    unsigned char* st = ring + s * C::STAGE_BYTES;
    // A hi [, A lo], B hi [, B lo]
    const uint64_t ah = desc_sw128(st + wg * 64 * BK * 2);
    const uint64_t bh = desc_sw128(st + C::NOPS * C::A_BYTES);
    fence_regs<BN / 2>(acc);
    wgmma_fence();
#pragma unroll
    for (int k16 = 0; k16 < BK / 16; ++k16) {
      const uint64_t o = 2 * k16;  // 32 bytes, in 16-byte units
      wgmma_bf16<BN>(acc, ah + o, bh + o);
      if constexpr (MODE == MODE_SPLIT3) {
        const uint64_t al = ah + (C::A_BYTES >> 4);
        const uint64_t bl = bh + (C::B_BYTES >> 4);
        wgmma_bf16<BN>(acc, ah + o, bl + o);  // hi * lo
        wgmma_bf16<BN>(acc, al + o, bh + o);  // lo * hi
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<BN / 2>(acc);
    mbar_arrive(&empty[s]);
  }
  // accumulator layout: warp w of the group holds rows 16w..16w+15; in
  // each 8-column chunk j, d[4j + q] is row g + 8*(q/2), column
  // 8j + 2t + q%2 (g = lane/4, t = lane%4)
  const int lane = threadIdx.x % 32, w = (threadIdx.x % 128) / 32;
  const int r0 = m0 + wg * 64 + w * 16 + lane / 4;
  const int c0 = n0 + 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      store_one(p, r0 + 8 * (q / 2), c0 + 8 * j + q % 2, acc[4 * j + q]);
}

// Consumers of the fp32 mode: 16 x 16 threads, thread (ty, tx) owns rows
// ty*TM.. and the columns 64q + 4tx .. +3 of the tile, so a warp reads
// B as consecutive float4s and A as two broadcast chunks.
template <int BM, int BN>
__device__ __forceinline__ void consume_fp32(const Args& p,
                                             unsigned char* ring,
                                             uint64_t* full, uint64_t* empty,
                                             int nk, int m0, int n0) {
  using C = Cfg<MODE_FP32, BM, BN>;
  constexpr int TM = BM / 16, TN = BN / 16;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float v[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) v[i][j] = 0.0f;
  for (int kk = 0; kk < nk; ++kk) {
    const int s = kk % STAGES;
    mbar_wait(&full[s], (kk / STAGES) & 1);
    const float* As = reinterpret_cast<const float*>(
        ring + s * C::STAGE_BYTES);          // A^T [BK][BM]
    const float* Bs = As + BK * BM;          // B   [BK][BN]
#pragma unroll 4
    for (int k = 0; k < BK; ++k) {
      float av[TM], bv[TN];
#pragma unroll
      for (int q = 0; q < TM / 4; ++q) {
        const float4 u =
            *reinterpret_cast<const float4*>(As + k * BM + ty * TM + 4 * q);
        av[4 * q] = u.x; av[4 * q + 1] = u.y;
        av[4 * q + 2] = u.z; av[4 * q + 3] = u.w;
      }
#pragma unroll
      for (int q = 0; q < TN / 4; ++q) {
        const float4 u =
            *reinterpret_cast<const float4*>(Bs + k * BN + 64 * q + 4 * tx);
        bv[4 * q] = u.x; bv[4 * q + 1] = u.y;
        bv[4 * q + 2] = u.z; bv[4 * q + 3] = u.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) v[i][j] = fmaf(av[i], bv[j], v[i][j]);
    }
    mbar_arrive(&empty[s]);
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      store_one(p, m0 + ty * TM + i, n0 + 64 * (j / 4) + 4 * tx + j % 4,
                v[i][j]);
}

template <int MODE, int BM, int BN>
__global__ void __launch_bounds__(Cfg<MODE, BM, BN>::THREADS)
    sgemm_kernel(const __grid_constant__ CUtensorMap ma0,
                 const __grid_constant__ CUtensorMap ma1,
                 const __grid_constant__ CUtensorMap mb0,
                 const __grid_constant__ CUtensorMap mb1, Args p) {
  using C = Cfg<MODE, BM, BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * C::STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  const int ti = p.ji ? blockIdx.x : blockIdx.y;
  const int tj = p.ji ? blockIdx.y : blockIdx.x;
  const int m0 = ti * BM, n0 = tj * BN;
  const int nk = (p.K + BK - 1) / BK;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], C::CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= C::CONSUMERS) {  // the producer warp; one lane issues
    if (threadIdx.x == C::CONSUMERS) {
      for (int kk = 0; kk < nk; ++kk) {
        const int s = kk % STAGES;
        // round r of slot s waits for the consumers' release of round r-1
        mbar_wait(&empty[s], ((kk / STAGES) & 1) ^ 1);
        unsigned char* st = ring + s * C::STAGE_BYTES;
        mbar_expect_tx(&full[s], C::STAGE_BYTES);
        if constexpr (C::BF16) {
          tma_load_2d(st, &ma0, &full[s], kk * BK, m0);
          tma_load_2d(st + C::NOPS * C::A_BYTES, &mb0, &full[s], kk * BK, n0);
          if constexpr (C::NOPS == 2) {
            tma_load_2d(st + C::A_BYTES, &ma1, &full[s], kk * BK, m0);
            tma_load_2d(st + 2 * C::A_BYTES + C::B_BYTES, &mb1, &full[s],
                        kk * BK, n0);
          }
        } else {
          tma_load_2d(st, &ma0, &full[s], m0, kk * BK);
          tma_load_2d(st + C::A_BYTES, &mb0, &full[s], n0, kk * BK);
        }
      }
    }
    return;
  }
  if constexpr (C::BF16)
    consume_bf16<MODE, BM, BN>(p, ring, full, empty, nk, m0, n0);
  else
    consume_fp32<BM, BN>(p, ring, full, empty, nk, m0, n0);
}

struct Maps {
  CUtensorMap a0, a1, b0, b1;
};

template <int MODE, int BM, int BN>
int launch(const Maps& m, const Args& p, cudaStream_t s) {
  using C = Cfg<MODE, BM, BN>;
  // above 48 KB a block gets dynamic shared memory only on request; the
  // request holds for the current device, so it is made on every call
  cudaError_t e = cudaFuncSetAttribute(
      sgemm_kernel<MODE, BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned gm = static_cast<unsigned>(tpkt_cdiv(p.M, BM));
  const unsigned gn = static_cast<unsigned>(tpkt_cdiv(p.N, BN));
  const dim3 grid = p.ji ? dim3(gm, gn) : dim3(gn, gm);
  sgemm_kernel<MODE, BM, BN><<<grid, C::THREADS, C::SMEM_BYTES, s>>>(
      m.a0, m.a1, m.b0, m.b1, p);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int by_tile(int bm, int bn, const Maps& m, const Args& p, cudaStream_t s) {
  if (bm == 128 && bn == 128) return launch<MODE, 128, 128>(m, p, s);
  if (bm == 128 && bn == 64) return launch<MODE, 128, 64>(m, p, s);
  if (bm == 64 && bn == 128) return launch<MODE, 64, 128>(m, p, s);
  if (bm == 64 && bn == 64) return launch<MODE, 64, 64>(m, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// mode: 0 split3 (a0/a1 = A hi/lo (M, lda), b0/b1 = B^T hi/lo (N, ldb),
//         bf16, lda = ldb = K = k padded to a multiple of 8),
//       1 float32 (a0 = A^T (K, lda), b0 = B (K, ldb), f32; lda >= M and
//         ldb >= N multiples of 4),
//       2 bf16 (as split3, a1/b1 unused).
// Every operand 16-byte aligned. bm, bn 64 or 128, bk 64; ji 0 for the
// 'ij' grid order, 1 for 'ji'. Returns 0, a CUDA error, or a negative
// value when a tensor map cannot be encoded (see tpkt_encode_2d).
TPKT_EXPORT int tpkt_sgemm(int mode, const void* a0, const void* a1,
                           const void* b0, const void* b1, const void* c,
                           void* out, int M, int N, int K, int lda, int ldb,
                           float alpha, float beta, int bm, int bn, int bk,
                           int ji, void* stream) {
  const bool bf16 = mode != MODE_FP32;
  const int vec = bf16 ? 8 : 4;
  if (M < 1 || N < 1 || K < 0 || bk != BK || lda % vec || ldb % vec ||
      (mode != MODE_SPLIT3 && mode != MODE_FP32 && mode != MODE_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  Maps m = {};
  if (K > 0) {  // with K = 0 no stage is loaded and the maps are not read
    int rc = 0;
    if (bf16) {
      const auto t = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
      const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
      rc = tpkt_encode_2d(&m.a0, t, 2, a0, M, K, lda, bm, BK, sw);
      if (rc == 0) rc = tpkt_encode_2d(&m.b0, t, 2, b0, N, K, ldb, bn, BK, sw);
      if (rc == 0 && mode == MODE_SPLIT3) {
        rc = tpkt_encode_2d(&m.a1, t, 2, a1, M, K, lda, bm, BK, sw);
        if (rc == 0)
          rc = tpkt_encode_2d(&m.b1, t, 2, b1, N, K, ldb, bn, BK, sw);
      }
    } else {
      const auto t = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
      const auto sw = CU_TENSOR_MAP_SWIZZLE_NONE;
      rc = tpkt_encode_2d(&m.a0, t, 4, a0, K, M, lda, BK, bm, sw);
      if (rc == 0) rc = tpkt_encode_2d(&m.b0, t, 4, b0, K, N, ldb, BK, bn, sw);
    }
    if (rc != 0) return rc;
  }
  const Args p{static_cast<const float*>(c), static_cast<float*>(out), M, N,
               K, alpha, beta, ji};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case MODE_SPLIT3:
      return by_tile<MODE_SPLIT3>(bm, bn, m, p, s);
    case MODE_FP32:
      return by_tile<MODE_FP32>(bm, bn, m, p, s);
    default:
      return by_tile<MODE_BF16>(bm, bn, m, p, s);
  }
}
