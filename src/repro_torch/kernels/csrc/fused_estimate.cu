// RaBitQ distance estimate, gathered by id: the approximate tier of graph
// search in one launch per hop.
//
//   s        = sum over set bits j of word w of codes[ids[b, k], w] of q[b, 32 w + j]
//   ip_xq    = (2 s - sum_q[b]) / sqrt_d
//   est_cos  = ip_xq / max(ip_xo[id], 1e-6)
//   out[b,k] = max(nv^2 + nq^2 - 2 nv nq est_cos, 0)   nv = norms[id], nq = norm_q[b]
//   out[b,k] = +inf where ids[b, k] < 0;  NaN where ids[b, k] >= n.
//
// codes is the int32 [n, W] code table (the uint32 words of the JAX package,
// bit for bit), q is f32 [B, d] with d <= 32 W (the rotated unit query), and
// sqrt_d points at one float on the card.
//
// Replaces the TPU kernel fused_estimate_pallas in
// src/repro/kernels/bitdot/bitdot.py, which took code rows that XLA had
// already gathered, unpacked a (TM, W) tile to {0,1} floats and contracted
// it on the matrix unit before the estimator algebra.  Here the kernel
// gathers by id, as gather_l2.cu does, so one launch replaces the gather,
// the unpack, the product and the twenty-odd elementwise ops of the plain
// version.  A block of 8 warps shares one query line b in shared memory
// (zero past d); each warp owns one id; lane j tests bit j of every word (a
// broadcast load of the word) and adds q[32 w + j]; a shuffle tree sums the
// lanes into s, and lane 0 applies the estimate in the plain version's
// order of operations.
//
// Bound on the card: bytes.  An id reads 4 W + 8 bytes from random rows of
// the code table and the two scalar arrays (24 B at d = 128) and does about
// 32 W / 2 + 12 flops.  At the drain's shape (B = 128, K = 24) the launch
// itself, not memory, sets the time.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kIdsPerBlock = 8;

__global__ void fused_estimate_kernel(const int32_t* __restrict__ codes,
                                      const float* __restrict__ norms,
                                      const float* __restrict__ ip_xo,
                                      const int32_t* __restrict__ ids,
                                      const float* __restrict__ q,
                                      const float* __restrict__ sum_q,
                                      const float* __restrict__ norm_q,
                                      const float* __restrict__ sqrt_d,
                                      float* __restrict__ out,
                                      int64_t n, int K, int W, int d) {
  extern __shared__ float q_s[];
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int qd = 32 * W;

  for (int j = threadIdx.x; j < qd; j += blockDim.x)
    q_s[j] = j < d ? q[(int64_t)b * d + j] : 0.f;
  __syncthreads();

  const int k = blockIdx.x * kIdsPerBlock + warp;
  if (k >= K) return;
  const int32_t id = ids[(int64_t)b * K + k];
  const bool valid = id >= 0 && id < n;
  float acc = 0.f;
  if (valid) {
    const int32_t* row = codes + (int64_t)id * W;
    for (int w = 0; w < W; ++w) {
      const uint32_t word = (uint32_t)__ldg(row + w);
      if ((word >> lane) & 1u) acc += q_s[32 * w + lane];
    }
  }
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane != 0) return;
  float v;
  if (id < 0) {
    v = CUDART_INF_F;
  } else if (!valid) {
    v = CUDART_NAN_F;
  } else {
    const float sq = sum_q[b];
    const float nq = norm_q[b];
    const float nv = __ldg(norms + id);
    const float ip_xq = (2.f * acc - sq) / *sqrt_d;
    const float est_cos = ip_xq / fmaxf(__ldg(ip_xo + id), 1e-6f);
    const float d2 = nv * nv + nq * nq - 2.f * nv * nq * est_cos;
    v = fmaxf(d2, 0.f);
  }
  out[(int64_t)b * K + k] = v;
}

}  // namespace

extern "C" int fused_estimate(const int32_t* codes, const float* norms,
                              const float* ip_xo, const int32_t* ids,
                              const float* q, const float* sum_q,
                              const float* norm_q, const float* sqrt_d,
                              float* out, int64_t n, int B, int K, int W,
                              int d, void* stream) {
  if (B == 0 || K == 0) return 0;
  dim3 grid((K + kIdsPerBlock - 1) / kIdsPerBlock, B);
  dim3 block(32 * kIdsPerBlock);
  size_t smem = sizeof(float) * 32 * (size_t)W;
  fused_estimate_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      codes, norms, ip_xo, ids, q, sum_q, norm_q, sqrt_d, out, n, K, W, d);
  return (int)cudaGetLastError();
}
