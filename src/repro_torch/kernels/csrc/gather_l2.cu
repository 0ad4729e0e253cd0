// Fused gather + squared L2 distance for the exact tier of graph search.
//
//   out[b, m] = sum_j (base[ids[b, m], j] - q[b, j])^2     (difference form)
//   out[b, m] = +inf where ids[b, m] < 0;  NaN where ids[b, m] >= n.
//
// Replaces the TPU kernels gather_l2_pallas (one row per grid step) and
// gather_l2_tiled_pallas (R row DMAs per grid step), both in
// src/repro/kernels/l2dist/l2dist.py.  One template serves both entry
// points: a block of R warps shares one query line b, and each warp owns one
// (b, m) row.  gather_l2 launches R = 1, gather_l2_tiled R = 8.
//
// Bound on the card: bytes.  Every output reads one base row of d floats
// (512 B at d = 128) from a random place in device memory, 2 flops a byte.
// The design keeps each row read to whole coalesced transactions: a warp's
// lanes read consecutive float4s of the row (one float4 a lane at d = 128),
// the query line sits in shared memory, and a shuffle tree sums the lanes.
// A ragged d (not a multiple of 4, or a misaligned base) takes the scalar
// path with the same lane-strided layout; base is never padded.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

template <bool VEC4>
__global__ void gather_l2_kernel(const float* __restrict__ base,
                                 const int32_t* __restrict__ ids,
                                 const float* __restrict__ q,
                                 float* __restrict__ out,
                                 int64_t n, int M, int d) {
  extern __shared__ float q_s[];
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rows_per_block = blockDim.x >> 5;

  for (int j = threadIdx.x; j < d; j += blockDim.x) q_s[j] = q[(int64_t)b * d + j];
  __syncthreads();

  const int m = blockIdx.x * rows_per_block + warp;
  if (m >= M) return;
  const int32_t id = ids[(int64_t)b * M + m];
  float acc = 0.f;
  if (id >= 0 && id < n) {
    const float* row = base + (int64_t)id * d;
    if (VEC4) {
      const float4* row4 = reinterpret_cast<const float4*>(row);
      for (int c = lane; c < (d >> 2); c += 32) {
        const float4 r = __ldg(row4 + c);
        const float d0 = r.x - q_s[4 * c + 0];
        const float d1 = r.y - q_s[4 * c + 1];
        const float d2 = r.z - q_s[4 * c + 2];
        const float d3 = r.w - q_s[4 * c + 3];
        acc += d0 * d0 + d1 * d1 + d2 * d2 + d3 * d3;
      }
    } else {
      for (int j = lane; j < d; j += 32) {
        const float diff = __ldg(row + j) - q_s[j];
        acc += diff * diff;
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    float v = acc;
    if (id < 0) v = CUDART_INF_F;
    else if (id >= n) v = CUDART_NAN_F;
    out[(int64_t)b * M + m] = v;
  }
}

int launch(const float* base, const int32_t* ids, const float* q, float* out,
           int64_t n, int B, int M, int d, int rows_per_block, cudaStream_t stream) {
  if (B == 0 || M == 0) return 0;
  dim3 grid((M + rows_per_block - 1) / rows_per_block, B);
  dim3 block(32 * rows_per_block);
  size_t smem = sizeof(float) * (size_t)d;
  const bool vec4 = (d % 4 == 0) && (reinterpret_cast<uintptr_t>(base) % 16 == 0);
  if (vec4)
    gather_l2_kernel<true><<<grid, block, smem, stream>>>(base, ids, q, out, n, M, d);
  else
    gather_l2_kernel<false><<<grid, block, smem, stream>>>(base, ids, q, out, n, M, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One (b, m) row per block.
int gather_l2(const float* base, const int32_t* ids, const float* q, float* out,
              int64_t n, int B, int M, int d, void* stream) {
  return launch(base, ids, q, out, n, B, M, d, 1, (cudaStream_t)stream);
}

// Eight rows of one query line per block.
int gather_l2_tiled(const float* base, const int32_t* ids, const float* q, float* out,
                    int64_t n, int B, int M, int d, void* stream) {
  return launch(base, ids, q, out, n, B, M, d, 8, (cudaStream_t)stream);
}

}  // extern "C"
