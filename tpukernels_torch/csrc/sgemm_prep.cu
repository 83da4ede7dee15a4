// Operand preparation of the SGEMM kernels: one launch that reads A
// (m, k) and B (k, n) in float32 and writes what csrc/sgemm.cu and
// csrc/sgemm_pipelined.cu take (sgemm_ring.cuh): bf16 matrices A' (m, kp)
// and B^T' (n, kp), kp = k rounded up to 8, the pad columns zeros:
//
//   'default' x rounded to nearest even to bf16;
//   'high'    hi = x rounded so, lo = (x - float(hi)) rounded the same
//             way: two matrices an operand;
//   'float32' three pieces, x1 = rn(x), x2 = rn(x - x1), x3 = rn(x - x1 -
//             x2) (both differences exact in float32), one after another
//             in one matrix an operand: (3m, kp) and (3n, kp).
//
// It has no counterpart among the TPU kernels: the reference splits and
// transposes in XLA, outside its Pallas kernels
// (tpukernels/kernels/sgemm.py:_split_bf16), and the port did so in seven
// PyTorch calls. Its plain version is kernels/sgemm.py:operands_plain,
// and for finite inputs the two agree bitwise.
//
// Bound on the card: bytes (each input element read once, each output
// written once: 16 MB at 1024^2 in 'high', 0.005 ms). One grid covers
// both matrices, one 64 x 64 tile of an output a block. A block reads its
// tile of the source into shared memory along whichever axis of the
// source is contiguous (so a transposed output is read coalesced too; the
// tile's rows are padded to 65 floats against bank conflicts), then each
// thread converts 8 consecutive outputs of a row and stores each piece
// with one 16-byte store.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

enum Mode { MODE_SPLIT3 = 0, MODE_FP32 = 1, MODE_BF16 = 2 };

constexpr int TILE = 64, THREADS = 256;

// The bf16 pieces d[0..] (R, ld) of one matrix X: X[r, c] =
// src[r * sr + c * sc] for c < C and 0 for C <= c < ld.
struct Job {
  const float* src;
  long long sr, sc;
  __nv_bfloat16* d[3];
  int R, C, ld;
  int tiles_c;  // tiles across ld
};

__device__ __forceinline__ unsigned pack2(__nv_bfloat16 x, __nv_bfloat16 y) {
  return static_cast<unsigned>(__bfloat16_as_ushort(x)) |
         (static_cast<unsigned>(__bfloat16_as_ushort(y)) << 16);
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
    sgemm_prep_kernel(Job ja, Job jb, int blocks_a) {
  constexpr int PIECES = MODE == MODE_SPLIT3 ? 2 : MODE == MODE_FP32 ? 3 : 1;
  __shared__ float tile[TILE][TILE + 1];
  const bool second = static_cast<int>(blockIdx.x) >= blocks_a;
  const Job j = second ? jb : ja;
  const int t = static_cast<int>(blockIdx.x) - (second ? blocks_a : 0);
  const int r0 = (t / j.tiles_c) * TILE, c0 = (t % j.tiles_c) * TILE;

  // read: 64 consecutive threads along the source's contiguous axis
  const int fast = threadIdx.x % TILE, slow = threadIdx.x / TILE;
  const bool along_c = j.sc == 1;
#pragma unroll 4
  for (int i = slow; i < TILE; i += THREADS / TILE) {
    const int r = along_c ? i : fast, c = along_c ? fast : i;
    const int gr = r0 + r, gc = c0 + c;
    tile[r][c] = gr < j.R && gc < j.C ? j.src[gr * j.sr + gc * j.sc] : 0.0f;
  }
  __syncthreads();

  // write: 8 threads a row, 8 consecutive outputs a thread
  const int chunk = (threadIdx.x % 8) * 8;
#pragma unroll
  for (int r = threadIdx.x / 8; r < TILE; r += THREADS / 8) {
    const int gr = r0 + r, gc = c0 + chunk;
    if (gr >= j.R || gc >= j.ld) continue;  // ld is a multiple of 8
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = tile[r][chunk + e];
    const long long at = static_cast<long long>(gr) * j.ld + gc;
#pragma unroll
    for (int piece = 0; piece < PIECES; ++piece) {
      __nv_bfloat16 h[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        h[e] = __float2bfloat16_rn(v[e]);
        v[e] -= __bfloat162float(h[e]);  // exact: h widens to float32
      }
      *reinterpret_cast<uint4*>(j.d[piece] + at) =
          make_uint4(pack2(h[0], h[1]), pack2(h[2], h[3]),
                     pack2(h[4], h[5]), pack2(h[6], h[7]));
    }
  }
}

// The job of one operand: PIECES outputs, d0 and d1 as given or, for
// 'float32', three one after another from d0.
Job job(int mode, const void* src, long long sr, long long sc, void* d0,
        void* d1, int R, int C, int ld) {
  auto* p0 = static_cast<__nv_bfloat16*>(d0);
  const long long part = static_cast<long long>(R) * ld;
  Job j{static_cast<const float*>(src), sr, sc,
        {p0, static_cast<__nv_bfloat16*>(d1), nullptr},
        R, C, ld, static_cast<int>(tpkt_cdiv(ld, TILE))};
  if (mode == MODE_FP32) {
    j.d[1] = p0 + part;
    j.d[2] = p0 + 2 * part;
  }
  return j;
}

long long blocks_of(const Job& j) { return tpkt_cdiv(j.R, TILE) * j.tiles_c; }

}  // namespace

// a: A (m, k) float32 with strides (a_rs, a_cs) in elements; b: B (k, n)
// with strides (b_rs, b_cs). lda = ldb = k rounded up to 8; every output
// bf16 and 16-byte aligned. mode as tpkt_sgemm's:
//   0 split3: a0/a1 = A hi/lo (m, lda), b0/b1 = B^T hi/lo (n, ldb);
//   1 float32: a0 = the three pieces of A, (3m, lda), b0 = those of B^T,
//     (3n, ldb); a1/b1 unused;
//   2 bf16: a0 = A (m, lda), b0 = B^T (n, ldb); a1/b1 unused.
// Returns 0 or a CUDA error.
TPKT_EXPORT int tpkt_sgemm_prep(int mode, const void* a, long long a_rs,
                                long long a_cs, const void* b, long long b_rs,
                                long long b_cs, void* a0, void* a1, void* b0,
                                void* b1, int m, int k, int n, int lda,
                                int ldb, void* stream) {
  if (m < 0 || n < 0 || k < 0 || lda % 8 || ldb % 8 || lda < k || ldb < k ||
      a0 == nullptr || b0 == nullptr ||
      (mode != MODE_SPLIT3 && mode != MODE_FP32 && mode != MODE_BF16) ||
      (mode == MODE_SPLIT3 && (a1 == nullptr || b1 == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  // B^T[r = nn, c = kk] = B[kk, nn]
  const Job ja = job(mode, a, a_rs, a_cs, a0, a1, m, k, lda);
  const Job jb = job(mode, b, b_cs, b_rs, b0, b1, n, k, ldb);
  const long long na = blocks_of(ja), nb = blocks_of(jb);
  if (na + nb == 0) return 0;
  if (na + nb > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(na + nb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks_a = static_cast<int>(na);
  switch (mode) {
    case MODE_SPLIT3:
      sgemm_prep_kernel<MODE_SPLIT3><<<grid, THREADS, 0, s>>>(ja, jb, blocks_a);
      break;
    case MODE_FP32:
      sgemm_prep_kernel<MODE_FP32><<<grid, THREADS, 0, s>>>(ja, jb, blocks_a);
      break;
    default:
      sgemm_prep_kernel<MODE_BF16><<<grid, THREADS, 0, s>>>(ja, jb, blocks_a);
  }
  return static_cast<int>(cudaGetLastError());
}
