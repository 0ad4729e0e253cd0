// Fused gather + squared L2 distance for the exact tier of graph search.
//
//   out[b, m] = sum_j (base[ids[b, m], j] - q[b, j])^2     (difference form)
//   out[b, m] = +inf where ids[b, m] < 0;  NaN where ids[b, m] >= n.
//
// Replaces the TPU kernels gather_l2_pallas (one row per grid step) and
// gather_l2_tiled_pallas (R row DMAs per grid step), both in
// src/repro/kernels/l2dist/l2dist.py.
//
// Bound on the card: bytes.  Every output reads one base row of d floats
// (512 B at d = 128) from a random place in device memory, 2 flops a byte.
// Rows stay whole and coalesced and base is never copied or padded.  Each
// entry point launches one of three kernels, which the wrapper picks by d
// and alignment (l2dist/ops.py::tiled_kernel for gather_l2_tiled,
// ::one_row_kernel for gather_l2):
//
//  * d % 4 == 0, d <= 128, a 16-byte-aligned base and query line (d = 128
//    on every path): l2_rows.cuh's float4 register kernel, one float4 of
//    each row a lane -- gather_l2_rows with 2 rows a warp (gather_l2_tiled:
//    the drain's [128, 1], the build's [1024, 24]) and gather_l2_row1 with
//    one (gather_l2, whose unit is one (b, m) row: [128, 24] of
//    backend="kernel"; 4 rows of one line a block, b = blockIdx.y).  A
//    warp's row loads wait only for its ids: two dependent round trips (the
//    id, then the row with the query line), no shared memory and no
//    barrier.
//  * every other d <= 256 (MIPS's d + 1 = 129, a misaligned view, d =
//    130-256): the same design with scalar columns, lane l reading column
//    l + 32 k of each row -- gather_l2_ragged (4 rows a warp) and
//    gather_l2_ragged1 (one).
//  * d > 256: gather_l2_blocks, gather_l2_kernel below, for both -- at
//    d = 960 (GIST1M's width) the build's searches' [block, 64] and the
//    probing loop's exact tier's [B, 1], where one warp of each block's
//    eight has a row.
//
// gather_l2_kernel<VEC4> (gather_l2_blocks): a block of 8 warps shares one
// query line b staged in shared memory, each warp owns one (b, m) row and
// lanes read consecutive float4s of it (scalar loads where d % 4 != 0 or
// base is not 16-byte aligned), which a shuffle tree sums.  The register
// kernels' sums are its own to the bit where both read the same terms in
// the same lanes: one float4 a lane (d <= 128, aligned), or scalar columns.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "l2_rows.cuh"

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

// Eight rows of one query line a block: any d up to the shared memory's.
int launch_blocks(const float* base, const int32_t* ids, const float* q, float* out,
                  int64_t n, int B, int M, int d, cudaStream_t stream) {
  constexpr int kBlockRows = 8;
  if (B == 0 || M == 0) return 0;
  dim3 grid((M + kBlockRows - 1) / kBlockRows, B);
  dim3 block(32 * kBlockRows);
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

// The kernels behind gather_l2_tiled (R rows a warp) and gather_l2 (one);
// the wrapper picks one (l2dist/ops.py).
// Eight rows of one query line per block: any d, any alignment.
int gather_l2_blocks(const float* base, const int32_t* ids, const float* q, float* out,
                     int64_t n, int B, int M, int d, void* stream) {
  return launch_blocks(base, ids, q, out, n, B, M, d, (cudaStream_t)stream);
}

// The register kernel: d % 4 == 0, d <= 128, base and q 16-byte aligned.
int gather_l2_rows(const float* base, const int32_t* ids, const float* q, float* out,
                   int64_t n, int B, int M, int d, void* stream) {
  return l2rows::launch<true, l2rows::kRows>(base, ids, q, d, out, n, B, M, d,
                                             (cudaStream_t)stream);
}

// The register kernel with scalar columns: d <= 256, any alignment.
int gather_l2_ragged(const float* base, const int32_t* ids, const float* q, float* out,
                     int64_t n, int B, int M, int d, void* stream) {
  return l2rows::launch_ragged<true, l2rows::kRaggedRows>(base, ids, q, d, out, n, B, M, d,
                                                          (cudaStream_t)stream);
}

// gather_l2_rows with one row a warp.
int gather_l2_row1(const float* base, const int32_t* ids, const float* q, float* out,
                   int64_t n, int B, int M, int d, void* stream) {
  return l2rows::launch<true, 1>(base, ids, q, d, out, n, B, M, d, (cudaStream_t)stream);
}

// gather_l2_ragged with one row a warp.
int gather_l2_ragged1(const float* base, const int32_t* ids, const float* q, float* out,
                      int64_t n, int B, int M, int d, void* stream) {
  return l2rows::launch_ragged<true, 1>(base, ids, q, d, out, n, B, M, d,
                                        (cudaStream_t)stream);
}

}  // extern "C"
