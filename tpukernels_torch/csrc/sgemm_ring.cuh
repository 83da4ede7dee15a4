// The SGEMM kernel of the port, out = alpha * A @ B + beta * C, with the
// number of shared-memory stages as a template parameter: the device and
// launch code shared by csrc/sgemm.cu (B1, two stages) and
// csrc/sgemm_pipelined.cu (B2, a ring of `depth` stages).
//
// Each block owns one BM x BN output tile and walks K through a ring of
// STAGES shared-memory stages of BK = 64, with one full and one empty
// mbarrier a stage. One producer warp issues the TMA copies of the
// stages ahead while the consumers compute stage kk:
//
//   'high'    (MODE_SPLIT3): A hi/lo (m, kp) and B^T hi/lo (n, kp), bf16,
//             arrive in 128-byte-swizzled tiles; each consumer warpgroup
//             (64 rows of the tile) issues wgmma.m64nBNk16 per 16 k,
//             hi*hi, then hi*lo, then lo*hi into one f32 accumulator.
//   'default' (MODE_BF16): one bf16 product, wgmma as above.
//   'float32' (MODE_FP32): six bf16 products, as the reference's
//             'float32' (bf16 x 6). A and B^T arrive as three bf16 pieces
//             each (x = x1 + x2 + x3 to 24 bits), the pieces of one
//             operand stacked in one matrix ((3m, kp) and (3n, kp)) and
//             copied through one tensor map. Per 16 k: a3*b1, a1*b3,
//             a2*b2, a2*b1, a1*b2, a1*b1. The tensor core does not keep
//             every bit of an f32 accumulator, and what it drops from a
//             running sum over all of k grows faster than the contract
//             allows, so each stage's products (64 k) are summed in the
//             tensor core from zero and the stage's sum is added to the
//             output's accumulator with a float32 add.
//
// Every output is summed over the k16 chunks and the stages in the same
// order whatever STAGES is, so at one tile, mode and grid order the
// result does not depend on the stage count: B2 equals B1 bitwise at
// every depth.
//
// The operands come with rows padded with zeros to whole 16 bytes (TMA
// needs 16-byte global strides; csrc/sgemm_prep.cu writes them); TMA
// fills what lies past the edge of a matrix with zeros, and still counts
// those bytes, so the expected transaction bytes of a stage are always
// the whole boxes. Round r of slot s waits on parity r & 1 (consumers,
// "full") or (r & 1) ^ 1 (the producer, "empty", which a fresh barrier
// passes). A slot goes back to the producer when every consumer thread
// has arrived on its empty barrier, after the wgmma group that read it
// has completed: the consumers wait for each stage's group
// (wgmma.wait_group 0) and release its slot at once. Leaving one group in
// flight on three stages (Cfg::IN_FLIGHT 1: wait_group 1, the slot before
// the one just issued released) hands every slot back a stage later and
// measured slower or equal at every size (an NVIDIA H100 80GB HBM3:
// 'high' 4096^3 at 128 x 64 0.889 ms against 0.746), so no entry runs it;
// it stays for tpkt_sgemm_pipelined_probe to measure.
#pragma once

#include "hopper.cuh"

// Internal linkage throughout: each source that includes this header is
// a shared library of its own, with its own kernels; a static of a
// function with external linkage (launch's memo) would be one object for
// every library in the process.
namespace tpkt_gemm {
namespace {

using namespace tpkt_hopper;

enum Mode { MODE_SPLIT3 = 0, MODE_FP32 = 1, MODE_BF16 = 2 };

constexpr int BK = 64;  // k a stage: one 128-byte row of bf16

struct Args {
  const float* c;
  float* out;
  int M, N, K;  // K: the k extent walked (bf16 modes: k padded to 8)
  float alpha, beta;
  int ji;  // grid order: 0 'ij' (j fastest within a row of i), 1 'ji'
};

// IN_FLIGHT: the wgmma groups the consumers of 'high' and 'default'
// leave in flight, 0 or (three or more stages) 1. A compile-time choice:
// with the wait's count chosen at run time ptxas serialises the wgmma
// pipeline (it warns so) and every kernel here ran about a fifth slower.
template <int MODE, int BM, int BN, int STAGES, int IN_FLIGHT = 0>
struct Cfg {
  // bf16 matrices an operand: hi/lo, three pieces, or one
  static constexpr int NOPS =
      MODE == MODE_SPLIT3 ? 2 : MODE == MODE_FP32 ? 3 : 1;
  static constexpr int CONSUMERS = BM / 64 * 128;  // a warpgroup per 64 rows
  static constexpr int THREADS = CONSUMERS + 32;   // + the producer warp
  static constexpr int A_BYTES = BM * BK * 2, B_BYTES = BN * BK * 2;
  static constexpr int STAGE_BYTES = NOPS * (A_BYTES + B_BYTES);
  // the ring, 1024 bytes to align it for the swizzle, 2 barriers a stage
  static constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + 16 * STAGES;
  // 'float32' at 128 x 128 on three stages would need 295 984 B: that
  // instantiation is not built, and the knob set is refused
  static constexpr bool FITS = SMEM_BYTES <= 232448;  // a block's most
  static_assert(STAGES >= 2, "the producer needs a slot to fill");
  static_assert(IN_FLIGHT == 0 || (IN_FLIGHT == 1 && STAGES >= 3),
                "a group in flight needs a third slot");
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

// Consumers: warpgroup wg owns rows wg*64.. of the tile, 64 x BN
// accumulators (BN/2 a thread). 'float32' sums each stage's six products
// in the tensor core from zero (`part`) and adds the stage's sum to `acc`
// with a float32 add, so the bits the tensor core drops are dropped from
// a sum over 64 k, not from the running sum over all of k.
template <int MODE, int BM, int BN, int STAGES, int IN_FLIGHT>
__device__ __forceinline__ void consume(const Args& p, unsigned char* ring,
                                        uint64_t* full, uint64_t* empty,
                                        int nk, int m0, int n0) {
  using C = Cfg<MODE, BM, BN, STAGES, IN_FLIGHT>;
  constexpr int R = BN / 2;
  constexpr bool SIX = MODE == MODE_FP32;
  // the next piece of A or B in a stage, in the descriptor's 16-byte units
  constexpr uint64_t NA = C::A_BYTES >> 4, NB = C::B_BYTES >> 4;
  const int wg = threadIdx.x / 128;
  float acc[R], part[SIX ? R : 1];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < (SIX ? R : 1); ++i) part[i] = 0.0f;
  for (int kk = 0; kk < nk; ++kk) {
    const int s = kk % STAGES;
    mbar_wait(&full[s], (kk / STAGES) & 1);
    unsigned char* st = ring + s * C::STAGE_BYTES;
    // the stage: NOPS pieces of A (hi, lo | 1, 2, 3), then as many of B
    const uint64_t a = desc_sw128(st + wg * 64 * BK * 2);
    const uint64_t b = desc_sw128(st + C::NOPS * C::A_BYTES);
    if constexpr (SIX) {
      fence_regs<R>(part);
      wgmma_fence();
#pragma unroll
      for (int k16 = 0; k16 < BK / 16; ++k16) {
        const uint64_t o = 2 * k16;  // 32 bytes, in 16-byte units
        // smallest first; the stage's first product starts from zero
        wgmma_bf16<BN>(part, a + 2 * NA + o, b + o, k16 != 0);  // a3 * b1
        wgmma_bf16<BN>(part, a + o, b + 2 * NB + o);            // a1 * b3
        wgmma_bf16<BN>(part, a + NA + o, b + NB + o);           // a2 * b2
        wgmma_bf16<BN>(part, a + NA + o, b + o);                // a2 * b1
        wgmma_bf16<BN>(part, a + o, b + NB + o);                // a1 * b2
        wgmma_bf16<BN>(part, a + o, b + o);                     // a1 * b1
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<R>(part);
      mbar_arrive(&empty[s]);
#pragma unroll
      for (int i = 0; i < R; ++i) acc[i] += part[i];
    } else {
      fence_regs<R>(acc);
      wgmma_fence();
#pragma unroll
      for (int k16 = 0; k16 < BK / 16; ++k16) {
        const uint64_t o = 2 * k16;
        wgmma_bf16<BN>(acc, a + o, b + o);
        if constexpr (MODE == MODE_SPLIT3) {
          wgmma_bf16<BN>(acc, a + o, b + NB + o);  // hi * lo
          wgmma_bf16<BN>(acc, a + NA + o, b + o);  // lo * hi
        }
      }
      wgmma_commit();
      wgmma_wait<IN_FLIGHT>();
      fence_regs<R>(acc);
      if constexpr (IN_FLIGHT == 0) {
        mbar_arrive(&empty[s]);
      } else {
        // the group of stage kk - 1 has completed: its slot is free
        if (kk > 0) mbar_arrive(&empty[(kk - 1) % STAGES]);
      }
    }
  }
  if constexpr (IN_FLIGHT != 0 && !SIX) {
    wgmma_wait<0>();
    fence_regs<R>(acc);
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

template <int MODE, int BM, int BN, int STAGES, int IN_FLIGHT>
__global__ void __launch_bounds__(
    Cfg<MODE, BM, BN, STAGES, IN_FLIGHT>::THREADS)
    sgemm_ring_kernel(const __grid_constant__ CUtensorMap ma0,
                      const __grid_constant__ CUtensorMap ma1,
                      const __grid_constant__ CUtensorMap mb0,
                      const __grid_constant__ CUtensorMap mb1, Args p) {
  using C = Cfg<MODE, BM, BN, STAGES, IN_FLIGHT>;
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
        unsigned char* sb = st + C::NOPS * C::A_BYTES;
        mbar_expect_tx(&full[s], C::STAGE_BYTES);
        if constexpr (MODE == MODE_FP32) {
          // piece i of A is rows i*M.. of ma0's matrix, of B^T rows i*N..
          // of mb0's. A box that runs past a piece's rows brings rows of
          // the next piece (zeros past the last): they meet only outputs
          // past the edge of the matrix, which are not stored.
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            tma_load_2d(st + i * C::A_BYTES, &ma0, &full[s], kk * BK,
                        i * p.M + m0);
            tma_load_2d(sb + i * C::B_BYTES, &mb0, &full[s], kk * BK,
                        i * p.N + n0);
          }
        } else {
          tma_load_2d(st, &ma0, &full[s], kk * BK, m0);
          tma_load_2d(sb, &mb0, &full[s], kk * BK, n0);
          if constexpr (C::NOPS == 2) {
            tma_load_2d(st + C::A_BYTES, &ma1, &full[s], kk * BK, m0);
            tma_load_2d(sb + C::B_BYTES, &mb1, &full[s], kk * BK, n0);
          }
        }
      }
    }
    return;
  }
  consume<MODE, BM, BN, STAGES, IN_FLIGHT>(p, ring, full, empty, nk, m0,
                                           n0);
}

struct Maps {
  CUtensorMap a0, a1, b0, b1;
};

template <int MODE, int BM, int BN, int STAGES, int IN_FLIGHT = 0>
int launch(const Maps& m, const Args& p, cudaStream_t s) {
  using C = Cfg<MODE, BM, BN, STAGES, IN_FLIGHT>;
  if constexpr (!C::FITS) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    auto kernel = sgemm_ring_kernel<MODE, BM, BN, STAGES, IN_FLIGHT>;
    // above 48 KB a block gets dynamic shared memory only on request; the
    // request holds for one device, so it is made once per device
    static TpktSmemMemo allowed;
    cudaError_t e = tpkt_allow_smem_once(kernel, C::SMEM_BYTES, allowed);
    if (e != cudaSuccess) return static_cast<int>(e);
    const unsigned gm = static_cast<unsigned>(tpkt_cdiv(p.M, BM));
    const unsigned gn = static_cast<unsigned>(tpkt_cdiv(p.N, BN));
    const dim3 grid = p.ji ? dim3(gm, gn) : dim3(gn, gm);
    kernel<<<grid, C::THREADS, C::SMEM_BYTES, s>>>(m.a0, m.a1, m.b0, m.b1, p);
    return static_cast<int>(cudaGetLastError());
  }
}

template <int MODE, int STAGES>
int by_tile(int bm, int bn, const Maps& m, const Args& p, cudaStream_t s) {
  if (bm == 128 && bn == 128) return launch<MODE, 128, 128, STAGES>(m, p, s);
  if (bm == 128 && bn == 64) return launch<MODE, 128, 64, STAGES>(m, p, s);
  if (bm == 64 && bn == 128) return launch<MODE, 64, 128, STAGES>(m, p, s);
  if (bm == 64 && bn == 64) return launch<MODE, 64, 64, STAGES>(m, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The arguments of one call, checked, as the tensor maps and the kernel's
// arguments. The operands are bf16 matrices whose rows are lda = ldb = K
// elements, K = k padded to a multiple of 8.
// mode: 0 split3 (a0/a1 = A hi/lo (M, K), b0/b1 = B^T hi/lo (N, K)),
//       1 float32 (a0 = the three pieces of A one after another, (3M, K),
//         b0 = those of B^T, (3N, K); a1/b1 unused),
//       2 bf16 (a0 = A (M, K), b0 = B^T (N, K); a1/b1 unused).
// Every operand 16-byte aligned. bm, bn 64 or 128, bk 64; ji 0 for the
// 'ij' grid order, 1 for 'ji'. Returns 0, a CUDA error, or a negative
// value when a tensor map cannot be encoded (see tpkt_encode_2d).
inline int prepare(int mode, const void* a0, const void* a1, const void* b0,
                   const void* b1, const void* c, void* out, int M, int N,
                   int K, int lda, int ldb, float alpha, float beta, int bm,
                   int bn, int bk, int ji, Maps* m, Args* p) {
  if (M < 1 || N < 1 || K < 0 || bk != BK || lda % 8 || ldb % 8 ||
      (mode != MODE_SPLIT3 && mode != MODE_FP32 && mode != MODE_BF16) ||
      (mode == MODE_FP32 && (M > 0x7fffffff / 3 || N > 0x7fffffff / 3)))
    return static_cast<int>(cudaErrorInvalidValue);
  *m = Maps{};
  if (K > 0) {  // with K = 0 no stage is loaded and the maps are not read
    const auto t = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
    const uint64_t parts = mode == MODE_FP32 ? 3 : 1;
    int rc = tpkt_encode_2d(&m->a0, t, 2, a0, parts * M, K, lda, bm, BK, sw);
    if (rc == 0)
      rc = tpkt_encode_2d(&m->b0, t, 2, b0, parts * N, K, ldb, bn, BK, sw);
    if (rc == 0 && mode == MODE_SPLIT3) {
      rc = tpkt_encode_2d(&m->a1, t, 2, a1, M, K, lda, bm, BK, sw);
      if (rc == 0)
        rc = tpkt_encode_2d(&m->b1, t, 2, b1, N, K, ldb, bn, BK, sw);
    }
    if (rc != 0) return rc;
  }
  *p = Args{static_cast<const float*>(c), static_cast<float*>(out), M, N, K,
            alpha, beta, ji};
  return 0;
}

// One call on a ring of STAGES stages; the arguments of prepare. Invalid
// value also for 'float32' at 128 x 128 on three stages, which does not
// fit.
template <int STAGES>
int run(int mode, const void* a0, const void* a1, const void* b0,
        const void* b1, const void* c, void* out, int M, int N, int K,
        int lda, int ldb, float alpha, float beta, int bm, int bn, int bk,
        int ji, void* stream) {
  Maps m;
  Args p;
  const int rc = prepare(mode, a0, a1, b0, b1, c, out, M, N, K, lda, ldb,
                         alpha, beta, bm, bn, bk, ji, &m, &p);
  if (rc != 0) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case MODE_SPLIT3:
      return by_tile<MODE_SPLIT3, STAGES>(bm, bn, m, p, s);
    case MODE_FP32:
      return by_tile<MODE_FP32, STAGES>(bm, bn, m, p, s);
    default:
      return by_tile<MODE_BF16, STAGES>(bm, bn, m, p, s);
  }
}

}  // namespace
}  // namespace tpkt_gemm
