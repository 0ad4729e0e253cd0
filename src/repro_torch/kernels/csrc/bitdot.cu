// RaBitQ S+ contraction over packed sign codes, batched over queries.
//
//   out[b, k] = sum over set bits j of word w of codes[b, k, w] of q[b, 32 w + j]
//
// codes is int32 [B, K, W] (the uint32 words of the JAX package, bit for
// bit), q is f32 [B, 32 W] zero-padded past the vector dimension.
//
// Replaces the TPU kernel bitdot_pallas in src/repro/kernels/bitdot/bitdot.py,
// which unpacked a (TM, W) tile to {0,1} floats in vector registers and
// contracted it with the query on the matrix unit.  On Hopper there is no
// product worth the tensor cores here (one query line per code row), so the
// unpack and the multiply-add happen in the lanes: a block of 8 warps shares
// one query line b held in shared memory, each warp owns one code row, and
// lane j takes bit j of every word (a broadcast load of the word, a
// conflict-free shared-memory read of q[32 w + j]).  A shuffle tree sums the
// 32 lanes.
//
// Bound on the card: bytes.  A code row is 4 W bytes (16 B at d = 128) and
// does 32 W multiply-adds, 4 flops a byte.  At the main path's shapes
// (B = 128, K = 96) the whole input is under 300 KB, so the launch itself,
// not memory, sets the time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 8;

__global__ void bitdot_kernel(const int32_t* __restrict__ codes,
                              const float* __restrict__ q,
                              float* __restrict__ out, int K, int W) {
  extern __shared__ float q_s[];
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int qd = 32 * W;

  for (int j = threadIdx.x; j < qd; j += blockDim.x) q_s[j] = q[(int64_t)b * qd + j];
  __syncthreads();

  const int k = blockIdx.x * kRowsPerBlock + warp;
  if (k >= K) return;
  const int32_t* row = codes + ((int64_t)b * K + k) * W;
  float acc = 0.f;
  for (int w = 0; w < W; ++w) {
    const uint32_t word = (uint32_t)__ldg(row + w);
    if ((word >> lane) & 1u) acc += q_s[32 * w + lane];
  }
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) out[(int64_t)b * K + k] = acc;
}

}  // namespace

extern "C" int bitdot(const int32_t* codes, const float* q, float* out,
                      int B, int K, int W, void* stream) {
  if (B == 0 || K == 0) return 0;
  dim3 grid((K + kRowsPerBlock - 1) / kRowsPerBlock, B);
  dim3 block(32 * kRowsPerBlock);
  size_t smem = sizeof(float) * 32 * (size_t)W;
  bitdot_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(codes, q, out, K, W);
  return (int)cudaGetLastError();
}
