// Squared L2 distance of a batch of row tiles to one query line each.
//
//   out[b, m] = sum_j (rows[b, m, j] - q[b, j])^2      (difference form)
//
// rows is f32 [B, M, d] contiguous; q is f32 [B, d] with unit stride along
// d and any stride q_stride between lines (a column slice of a larger
// tensor needs no copy).
//
// Replaces the TPU kernel batched_l2_pallas in
// src/repro/kernels/l2dist/l2dist.py, which took the norm identity
// |r|^2 + |q|^2 - 2 r.q to put the cross term on the matrix unit.  On
// Hopper each [M, d] tile meets one query line, a batched matrix-vector
// product with nothing for the tensor cores, so the kernel keeps the
// difference form of the plain version: it costs nothing extra and decides
// the occlusion test's near-ties as the plain version does.
//
// Bound on the card: bytes.  Every output reads one row of d floats once,
// 3 flops per 4 bytes.  Three kernels; the wrapper (l2dist/ops.py::
// batched_kernel) picks one:
//
//  * batched_l2_rows, where every load can be 16-byte aligned (d % 4 == 0,
//    d <= 128, aligned rows and query lines, a query stride that is a
//    multiple of 4): l2_rows.cuh's register kernel.  A warp owns 2 rows of
//    one tile, reads its query line into registers beside them and issues
//    every load before it reduces; small blocks, all of them busy (at
//    M = 25 no warp of a block idles).
//  * batched_l2_ragged, for every other d <= 256 (MIPS's d + 1 = 129, whose
//    query line is a strided column of the candidate tile; a misaligned
//    pointer or stride; d = 130-256): the same register design with scalar
//    columns, lane l reading column l + 32 k of each row.
//  * batched_l2_blocks, for d > 256 (d = 960's selection and degree
//    alignment, [block, 64-65, 960]): a block of 8 warps shares one query
//    line in shared memory, each warp owns one (b, m) row, lanes read
//    consecutive float4s (scalar loads where d or rows is not aligned),
//    and a shuffle tree sums them.

#include <cuda_runtime.h>
#include <stdint.h>

#include "l2_rows.cuh"

namespace {

constexpr int kRowsPerBlock = 8;

template <bool VEC4>
__global__ void batched_l2_kernel(const float* __restrict__ rows,
                                  const float* __restrict__ q,
                                  float* __restrict__ out,
                                  int M, int d, int64_t q_stride) {
  extern __shared__ float q_s[];
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int j = threadIdx.x; j < d; j += blockDim.x) q_s[j] = q[(int64_t)b * q_stride + j];
  __syncthreads();

  const int m = blockIdx.x * kRowsPerBlock + warp;
  if (m >= M) return;
  const float* row = rows + ((int64_t)b * M + m) * d;
  float acc = 0.f;
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
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) out[(int64_t)b * M + m] = acc;
}

}  // namespace

extern "C" {

// A block of 8 rows of one tile: any d, any alignment, any q_stride.
int batched_l2_blocks(const float* rows, const float* q, float* out, int B, int M, int d,
                      int64_t q_stride, void* stream) {
  if (B == 0 || M == 0) return 0;
  dim3 grid((M + kRowsPerBlock - 1) / kRowsPerBlock, B);
  dim3 block(32 * kRowsPerBlock);
  size_t smem = sizeof(float) * (size_t)d;
  const bool vec4 = (d % 4 == 0) && (reinterpret_cast<uintptr_t>(rows) % 16 == 0);
  if (vec4)
    batched_l2_kernel<true><<<grid, block, smem, (cudaStream_t)stream>>>(rows, q, out, M, d, q_stride);
  else
    batched_l2_kernel<false><<<grid, block, smem, (cudaStream_t)stream>>>(rows, q, out, M, d, q_stride);
  return (int)cudaGetLastError();
}

// The register kernel: d % 4 == 0, d <= 128, rows, q and q_stride aligned.
int batched_l2_rows(const float* rows, const float* q, float* out, int B, int M, int d,
                    int64_t q_stride, void* stream) {
  return l2rows::launch<false, l2rows::kRows>(rows, nullptr, q, q_stride, out, 0, B, M,
                                              d, (cudaStream_t)stream);
}

// The register kernel with scalar columns: d <= 256, any alignment and
// q_stride.
int batched_l2_ragged(const float* rows, const float* q, float* out, int B, int M, int d,
                      int64_t q_stride, void* stream) {
  return l2rows::launch_ragged<false, l2rows::kRaggedRows>(rows, nullptr, q, q_stride, out,
                                                           0, B, M, d, (cudaStream_t)stream);
}

}  // extern "C"
