// SAXPY: out = alpha * x + y over n float32 elements.
//
// Replaces tpukernels/kernels/vector_add.py:_saxpy_kernel (the VPU pass
// over (rows, 128) blocks). Bound on the card: bytes. Each element
// moves 12 bytes (read x, read y, write out) for 2 flops, far below the
// ~20 flop/byte the H100 needs before its fp32 units limit, so the
// kernel's only job is to keep HBM busy: a grid-stride loop with
// 16-byte vector loads and stores (float4) where all three pointers are
// 16-byte aligned, a scalar loop for the tail (and for unaligned
// pointers), and a grid sized to a few blocks per SM so each thread
// streams several vectors.
#include "common.cuh"

__global__ void saxpy_kernel(const float* __restrict__ x,
                             const float* __restrict__ y,
                             float* __restrict__ out, long long n,
                             long long n4, float alpha) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const float4* y4 = reinterpret_cast<const float4*>(y);
  float4* o4 = reinterpret_cast<float4*>(out);
  for (long long i = tid; i < n4; i += stride) {
    float4 a = x4[i];
    float4 b = y4[i];
    o4[i] = make_float4(alpha * a.x + b.x, alpha * a.y + b.y,
                        alpha * a.z + b.z, alpha * a.w + b.w);
  }
  for (long long i = 4 * n4 + tid; i < n; i += stride) {
    out[i] = alpha * x[i] + y[i];
  }
}

// blocks: grid size chosen by the wrapper; threads: block size.
TPKT_EXPORT int tpkt_saxpy(const void* x, const void* y, void* out,
                           long long n, float alpha, int blocks,
                           int threads, void* stream) {
  const bool vec = tpkt_aligned16(x) && tpkt_aligned16(y) &&
                   tpkt_aligned16(out);
  const long long n4 = vec ? n / 4 : 0;
  saxpy_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<float*>(out), n, n4, alpha);
  return static_cast<int>(cudaGetLastError());
}
