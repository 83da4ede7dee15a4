// Pipelined SGEMM: out = alpha * A @ B + beta * C, float32 out, any
// (m, n, k); the K stream of each tile walks a ring of shared-memory
// stages.
//
// Replaces tpukernels/kernels/sgemm.py:_sgemm_pipelined_kernel (the
// reference's depth 2/3 path). As there, each block owns one (i, j)
// output tile (BM x 128) and walks its nk K blocks through DEPTH slots:
// the copy of block kk + DEPTH - 1 is in flight (cp.async, one commit
// group per block) while block kk is computed. The grid order ('ij': j
// fastest within a row of i, 'ji': the transpose) stands in for the
// reference's grid permutation.
//
// Slot reuse, as in the reference: iteration kk issues the copy into
// slot (kk - 1) % DEPTH only after the __syncthreads() that follows
// cp.async.wait_group<DEPTH-2>, i.e. after every warp has finished
// iteration kk - 1's compute, the last read of that slot. The same
// barrier makes block kk's copy visible to every thread. A commit group
// is made every iteration, empty past the last block, so wait_group
// always counts blocks.
//
// The compute step and the epilogue are sgemm.cuh's, shared with B1
// (sgemm.cu): at the same tile and mode every output is summed in the
// same order, so B2 equals B1 bitwise, at every depth and order.
//
// cp.async copies 16 aligned bytes and cannot transpose, so the wrapper
// hands the kernel rows it can copy whole: in the bf16 modes A (m, lda)
// and B^T (n, ldb) with lda = ldb = k padded with zeros to a multiple of
// 8; in the fp32 mode A^T (k, lda) and B (k, ldb), m and n padded to a
// multiple of 4 (A^T is a copy the wrapper makes, as it makes B^T for
// the bf16 modes). The zeros add nothing, as the masked loads of B1 add
// nothing. Rows past the edge are zero-filled (src-size 0).
//
// Bound on the card at 1024^3: operations ('high' 3 x 2.15 GFLOP bf16
// tensor work, 'float32' 2.15 GFLOP fp32); the ring hides the load
// latency that B1 waits for at every stage. Shared memory:
// DEPTH x STAGE_BYTES of dynamic shared memory (split3 128 x 128 x 32:
// 40 960 B a stage), over 48 KB at depth 2, so the launch first raises
// the block's limit.
#include "sgemm.cuh"

namespace {

using namespace tpkt_gemm;

// 16 bytes global -> shared, or 16 zeros when !read (nothing is read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool read) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(read ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ROWS x COLS tile at (row0, col0) of a row-major (nrows, ld) matrix of
// ELEM-byte elements -> smem[ROWS][LDS]; ld is a multiple of 16/ELEM, so
// a 16-byte chunk lies wholly inside or wholly outside [0, ld).
template <int ROWS, int COLS, int LDS, int ELEM>
__device__ __forceinline__ void copy_tile(unsigned char* smem,
                                          const unsigned char* g, int nrows,
                                          int ld, int row0, int col0) {
  constexpr int PER = 16 / ELEM, CPR = COLS / PER;
  for (int ch = threadIdx.x; ch < ROWS * CPR; ch += THREADS) {
    const int r = ch / CPR, cc = (ch % CPR) * PER;
    const int gr = row0 + r, gc = col0 + cc;
    const bool in = gr < nrows && gc < ld;
    const unsigned char* src =
        in ? g + ((long long)gr * ld + gc) * ELEM : g;
    cp_async16(smem + (r * LDS + cc) * ELEM, src, in);
  }
}

template <int MODE, int BM, int BK>
__device__ __forceinline__ void copy_stage(unsigned char* st, const Args& p,
                                           int m0, int n0, int k0) {
  using T = Tile<MODE, BM, BK>;
  if constexpr (MODE == MODE_FP32) {
    // A^T rows k0.., columns m0..; B rows k0.., columns n0..
    copy_tile<BK, BM, T::LDA32, 4>(
        st, static_cast<const unsigned char*>(p.a0), p.K, p.lda, k0, m0);
    copy_tile<BK, BN, BN, 4>(st + BK * T::LDA32 * 4,
                             static_cast<const unsigned char*>(p.b0), p.K,
                             p.ldb, k0, n0);
  } else {
    const void* ag[2] = {p.a0, p.a1};
    const void* bg[2] = {p.b0, p.b1};
    unsigned char* bs = st + T::NOPS * BM * T::LDS * 2;
#pragma unroll
    for (int op = 0; op < T::NOPS; ++op) {
      copy_tile<BM, BK, T::LDS, 2>(st + op * BM * T::LDS * 2,
                                   static_cast<const unsigned char*>(ag[op]),
                                   p.M, p.lda, m0, k0);
      copy_tile<BN, BK, T::LDS, 2>(bs + op * BN * T::LDS * 2,
                                   static_cast<const unsigned char*>(bg[op]),
                                   p.N, p.ldb, n0, k0);
    }
  }
}

template <int MODE, int BM, int BK, int DEPTH>
__global__ void __launch_bounds__(THREADS) sgemm_pipelined_kernel(Args p) {
  using T = Tile<MODE, BM, BK>;
  extern __shared__ __align__(16) unsigned char ring[];
  int ti, tj;
  tile_of(p.ji, &ti, &tj);
  const int m0 = ti * BM, n0 = tj * BN;
  const int nk = (p.K + BK - 1) / BK;

  using Acc = typename std::conditional<MODE == MODE_FP32, FmaAcc<BM, BK>,
                                        MmaAcc<MODE, BM, BK>>::type;
  Acc acc;
  acc.init();

#pragma unroll
  for (int s = 0; s < DEPTH - 1; ++s) {  // prologue: fill the ring
    if (s < nk) copy_stage<MODE, BM, BK>(ring + s * T::STAGE_BYTES, p, m0,
                                         n0, s * BK);
    cp_async_commit();
  }
  for (int kk = 0; kk < nk; ++kk) {
    cp_async_wait<DEPTH - 2>();  // block kk has landed (this thread's part)
    __syncthreads();             // ... everyone's; slot (kk-1) % DEPTH free
    const int nxt = kk + DEPTH - 1;
    if (nxt < nk)
      copy_stage<MODE, BM, BK>(ring + (nxt % DEPTH) * T::STAGE_BYTES, p, m0,
                               n0, nxt * BK);
    cp_async_commit();
    const unsigned char* st = ring + (kk % DEPTH) * T::STAGE_BYTES;
    if constexpr (MODE == MODE_FP32) {
      const float* As = reinterpret_cast<const float*>(st);
      acc.step(As, As + BK * T::LDA32);
    } else {
      const uint16_t* As = reinterpret_cast<const uint16_t*>(st);
      acc.step(As, As + T::NOPS * BM * T::LDS);
    }
  }
  acc.store(p, m0, n0);
}

template <int MODE, int BM, int BK>
cudaError_t launch(const Args& p, int depth, cudaStream_t s) {
  const int bytes = depth * Tile<MODE, BM, BK>::STAGE_BYTES;
  cudaError_t e;
  if (depth == 2) {
    e = allow_smem(sgemm_pipelined_kernel<MODE, BM, BK, 2>, bytes);
    if (e == cudaSuccess)
      sgemm_pipelined_kernel<MODE, BM, BK, 2>
          <<<grid_of(p, BM), THREADS, bytes, s>>>(p);
  } else if (depth == 3) {
    e = allow_smem(sgemm_pipelined_kernel<MODE, BM, BK, 3>, bytes);
    if (e == cudaSuccess)
      sgemm_pipelined_kernel<MODE, BM, BK, 3>
          <<<grid_of(p, BM), THREADS, bytes, s>>>(p);
  } else {
    return cudaErrorInvalidValue;
  }
  return e == cudaSuccess ? cudaGetLastError() : e;
}

}  // namespace

// mode: 0 split3 (a0/a1 = A hi/lo (m, lda), b0/b1 = B^T hi/lo (n, ldb),
//         bf16, lda = ldb = k padded to a multiple of 8),
//       1 float32 (a0 = A^T (k, lda), b0 = B (k, ldb), f32; lda >= m and
//         ldb >= n multiples of 4),
//       2 bf16 (as split3, a1/b1 unused).
// Every operand 16-byte aligned. bm 128 or 64, bn 128, bk 32 or 64,
// depth 2 or 3; ji 0 for the 'ij' grid order, 1 for 'ji'.
TPKT_EXPORT int tpkt_sgemm_pipelined(int mode, const void* a0,
                                     const void* a1, const void* b0,
                                     const void* b1, const void* c,
                                     void* out, int M, int N, int K, int lda,
                                     int ldb, float alpha, float beta, int bm,
                                     int bn, int bk, int depth, int ji,
                                     void* stream) {
  const int vec = mode == MODE_FP32 ? 4 : 8;
  if (M < 1 || N < 1 || K < 0 || bn != BN || lda % vec || ldb % vec)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args p{a0, a1, b0, b1, static_cast<const float*>(c),
               static_cast<float*>(out), M, N, K, lda, ldb, alpha, beta, ji};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (mode) {
    case MODE_SPLIT3:
      e = TPKT_GEMM_BY_TILE(launch, MODE_SPLIT3, bm, bk, p, depth, s);
      break;
    case MODE_FP32:
      e = TPKT_GEMM_BY_TILE(launch, MODE_FP32, bm, bk, p, depth, s);
      break;
    case MODE_BF16:
      e = TPKT_GEMM_BY_TILE(launch, MODE_BF16, bm, bk, p, depth, s);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
