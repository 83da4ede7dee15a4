// Pipelined SGEMM: out = alpha * A @ B + beta * C, float32 out, any
// (m, n, k); the K stream of each tile walks a ring of `depth`
// shared-memory stages.
//
// Replaces tpukernels/kernels/sgemm.py:_sgemm_pipelined_kernel (the
// reference's depth 2/3 path). As there, each block owns one (i, j)
// output tile and walks its nk K blocks through `depth` slots, the
// copies of the blocks ahead in flight while block kk is computed; the
// grid order ('ij': j fastest within a row of i, 'ji': the transpose)
// stands in for the reference's grid permutation.
//
// It is the kernel of sgemm_ring.cuh (a TMA producer warp, full/empty
// mbarriers, wgmma consumers: three bf16 products for 'high', one for
// 'default', six for 'float32') instantiated with `depth` stages. The
// reference's depth 1 is double-buffered by Pallas and its depth 2 is a
// hand-made ring of two slots, so on this card depth 1 (csrc/sgemm.cu)
// and depth 2 at one tile are the same instantiation; depth 3 is the
// ring that entry does not have: the copies run two stages ahead. Every
// output is summed over the k16 chunks in the same order whatever the
// stage count, so this entry's result equals tpkt_sgemm's bitwise at the
// same tile, mode and order, at every depth.
//
// Bound on the card at 1024^3: operations ('high' 3 x 2.15 GFLOP bf16
// tensor work, 0.0065 ms; 'float32' 6 x 2.15 GFLOP, 0.0130 ms). Shared
// memory: depth x NOPS x (BM + BN) x 64 x 2 bytes (NOPS 2 for 'high', 3
// for 'float32', 1 for 'default'), 1024 to align the ring and 16 a stage
// for its barriers; split3 128 x 128 at depth 3 is 197 680 B, one block
// a SM; 'float32' 128 x 128 at depth 3 would be 295 984 B and is refused.
#include "sgemm_ring.cuh"

// The arguments of tpkt_gemm::run (sgemm_ring.cuh), and depth 2 or 3.
TPKT_EXPORT int tpkt_sgemm_pipelined(int mode, const void* a0,
                                     const void* a1, const void* b0,
                                     const void* b1, const void* c,
                                     void* out, int M, int N, int K, int lda,
                                     int ldb, float alpha, float beta, int bm,
                                     int bn, int bk, int depth, int ji,
                                     void* stream) {
  if (depth == 2)
    return tpkt_gemm::run<2>(mode, a0, a1, b0, b1, c, out, M, N, K, lda, ldb,
                             alpha, beta, bm, bn, bk, ji, stream);
  if (depth == 3)
    return tpkt_gemm::run<3>(mode, a0, a1, b0, b1, c, out, M, N, K, lda, ldb,
                             alpha, beta, bm, bn, bk, ji, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// For timing only: 'high' at depth 3 on a 128-row tile with every wgmma
// group waited for before the next is issued (in_flight 0, what
// tpkt_sgemm_pipelined runs) or with one group left in flight (1, see
// sgemm_ring.cuh); the result is the same bit for bit. No wrapper calls
// it; chip_smoke.py does, to keep the comparison that chose 0 measured.
TPKT_EXPORT int tpkt_sgemm_pipelined_probe(const void* a0, const void* a1,
                                           const void* b0, const void* b1,
                                           const void* c, void* out, int M,
                                           int N, int K, float alpha,
                                           float beta, int bn, int in_flight,
                                           int ji, void* stream) {
  using namespace tpkt_gemm;
  if (!in_flight)
    return run<3>(MODE_SPLIT3, a0, a1, b0, b1, c, out, M, N, K, K, K, alpha,
                  beta, 128, bn, BK, ji, stream);
  Maps m;
  Args p;
  const int rc = prepare(MODE_SPLIT3, a0, a1, b0, b1, c, out, M, N, K, K, K,
                         alpha, beta, 128, bn, BK, ji, &m, &p);
  if (rc != 0) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 128) return launch<MODE_SPLIT3, 128, 128, 3, 1>(m, p, s);
  if (bn == 64) return launch<MODE_SPLIT3, 128, 64, 3, 1>(m, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
