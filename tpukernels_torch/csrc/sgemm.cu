// SGEMM: out = alpha * A @ B + beta * C, float32 out, any (m, n, k).
//
// Replaces tpukernels/kernels/sgemm.py:_sgemm_kernel (the reference's
// depth-1 path) in its three operand modes. That kernel's K blocks are
// double-buffered by Pallas (`buf = 2 if depth == 1`), and so are these:
// the kernel of sgemm_ring.cuh (TMA tile loads on full/empty mbarriers
// feeding wgmma: three bf16 products for 'high', one for 'default', six
// for 'float32') instantiated with a ring of two stages. The reference's
// depth 2 is a hand-made ring of two slots, so csrc/sgemm_pipelined.cu at
// depth 2 is this same instantiation; its depth 3 is the ring this entry
// does not have.
//
// Tiles BM, BN in {64, 128} (TPKT_SGEMM_BM/BN), BK = 64; the grid order
// ij/ji (TPKT_SGEMM_ORDER).
//
// Bound on the card at 1024^3: operations ('high' 3 x 2.15 GFLOP of bf16
// tensor work, 0.0065 ms; 'float32' 6 x 2.15 GFLOP, 0.0130 ms). The 128 x 64 default tile gives 128 blocks at 1024^2 for
// 132 SMs.
#include "sgemm_ring.cuh"

constexpr int STAGES = 2;  // the reference's depth-1 double buffer

// The arguments of tpkt_gemm::run (sgemm_ring.cuh).
TPKT_EXPORT int tpkt_sgemm(int mode, const void* a0, const void* a1,
                           const void* b0, const void* b1, const void* c,
                           void* out, int M, int N, int K, int lda, int ldb,
                           float alpha, float beta, int bm, int bn, int bk,
                           int ji, void* stream) {
  return tpkt_gemm::run<STAGES>(mode, a0, a1, b0, b1, c, out, M, N, K, lda,
                                ldb, alpha, beta, bm, bn, bk, ji, stream);
}
