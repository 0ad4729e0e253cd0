// The register kernel of the squared-L2 distances: gather_l2.cu's
// gather_l2_rows (rows gathered by id from base) and batched_l2.cu's
// batched_l2_rows (rows of contiguous [M, d] tiles).  Both compute
//
//   out[b, m] = sum_j (row(b, m)[j] - q[b, j])^2      (difference form)
//
// Bound on the card: bytes, 2-3 flops a byte.  What sets the time at the
// paths' shapes is latency: the chain of dependent round trips before the
// rows move, and how many row bytes are in flight while it runs.  So a
// warp owns kRows rows of one line b, one float4 of each a lane (d <= 128),
// and
//  * its lanes read the line's ids (when gathering) and the query line, into
//    registers, at once: neither waits for the other, and nothing waits at
//    a __syncthreads();
//  * every row's loads are issued before any row is reduced: lanes read
//    consecutive float4s of a row, whole and coalesced, with L1 skipped and
//    a 256-byte L2 fetch (ld.global.nc.L1::no_allocate.L2::256B), which
//    took 2-16% off these kernels' times on an H100;
//  * the R partial sums meet in a reduce-scatter (rows_sum): log2 R
//    exchanges that halve the rows a lane holds, then the rest of one
//    butterfly: R - 1 + 5 - log2 R shuffles for R rows (5 for 2) where R
//    butterflies take 5 R.
// Blocks are small (kThreads) and many, so even the drain's 128 rows spread
// over the SMs.  (Persistent blocks fed by bulk asynchronous copies,
// cp.async.bulk, through a ring of shared-memory stages measured slower on
// an H100 at every shape of the paths: 512-byte copies keep the copy engine
// busy, and whole tiles arrive later than a warp's own loads; PERF.md §6.)
//
// These kernels take d % 4 == 0, d <= 128 and 16-byte-aligned rows and
// query lines (a query stride that is a multiple of 4); the wrappers
// (l2dist/ops.py) send any other shape to the one-row-a-warp kernels.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace l2rows {

constexpr int kThreads = 128;
constexpr int kRows = 2;                    // rows a warp owns
constexpr int kMaxD = 128;                  // one float4 a lane a row

__device__ __forceinline__ float sq_diff(float4 r, float4 q) {
  const float d0 = r.x - q.x;
  const float d1 = r.y - q.y;
  const float d2 = r.z - q.z;
  const float d3 = r.w - q.w;
  return d0 * d0 + d1 * d1 + d2 * d2 + d3 * d3;
}

// Sums a[r] (r < R, R a power of two up to 16) over the warp's lanes: log2 R
// exchanges that each halve the rows a lane holds (a reduce-scatter), then
// the rest of a butterfly.  Every lane returns the sum of row lane / (32 / R).
// A row's partial sums meet in the pairs and the order of the one-row
// butterfly (xor 16, 8, 4, 2, 1) of the block kernels, so each sum is that
// butterfly's to the bit.
template <int R>
__device__ __forceinline__ float rows_sum(float (&a)[R], int lane) {
#pragma unroll
  for (int h = R / 2, mask = 16; h >= 1; h /= 2, mask /= 2) {
    const bool hi = (lane & mask) != 0;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const float send = hi ? a[i] : a[i + h];
      const float keep = hi ? a[i + h] : a[i];
      a[i] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
    }
  }
  float v = a[0];
#pragma unroll
  for (int mask = 16 / R; mask >= 1; mask /= 2) v += __shfl_xor_sync(0xffffffffu, v, mask);
  return v;
}

// A row's float4: read once, so L1 is skipped, and L2 fetches 256 bytes.
__device__ __forceinline__ float4 load_row(const float4* p) {
  float4 v;
  asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

// GATHER: row (b, m) is src[ids[b, m]], +inf where the id < 0 and NaN
// where it is >= n.  Otherwise row (b, m) is src[b M + m].
template <bool GATHER>
__global__ void __launch_bounds__(kThreads)
rows_kernel(const float* __restrict__ src, const int32_t* __restrict__ ids,
            const float* __restrict__ q, int64_t q_stride, float* __restrict__ out,
            int64_t n, int B, int M, int d) {
  constexpr int R = kRows;
  const int lane = threadIdx.x & 31;
  const int64_t w = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int groups = (M + R - 1) / R;
  if (w >= (int64_t)B * groups) return;
  const int64_t b = w / groups;
  const int m0 = (int)(w - b * groups) * R;
  const int nr = min(R, M - m0);
  const bool col = lane < (d >> 2);         // this lane's float4 is in the row
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  const int32_t my_id = GATHER && lane < nr ? __ldg(ids + b * M + m0 + lane) : -1;
  const float4 qv =
      col ? __ldg(reinterpret_cast<const float4*>(q + b * q_stride) + lane) : zero;

  float4 x[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    bool ok = r < nr;
    int64_t row = b * M + m0 + r;
    if (GATHER) {
      const int32_t id = __shfl_sync(0xffffffffu, my_id, r);
      ok = ok && id >= 0 && id < n;
      row = ok ? id : 0;
    }
    x[r] = ok && col ? load_row(reinterpret_cast<const float4*>(src + row * d) + lane) : zero;
  }
  float a[R];
#pragma unroll
  for (int r = 0; r < R; ++r) a[r] = col ? sq_diff(x[r], qv) : 0.f;
  float sum = rows_sum<R>(a, lane);
  const int r = lane / (32 / R);             // the row whose sum this lane holds
  if (GATHER) {
    const int32_t id = __shfl_sync(0xffffffffu, my_id, r);
    if (id < 0) sum = CUDART_INF_F;
    else if (id >= n) sum = CUDART_NAN_F;
  }
  if (lane % (32 / R) == 0 && r < nr) out[b * M + m0 + r] = sum;
}

// Launches the register kernel for d % 4 == 0, d <= kMaxD; returns
// cudaGetLastError().
template <bool GATHER>
int launch(const float* src, const int32_t* ids, const float* q, int64_t q_stride,
           float* out, int64_t n, int B, int M, int d, cudaStream_t stream) {
  if (B == 0 || M == 0) return 0;
  if (d % 4 != 0 || d > kMaxD) return (int)cudaErrorInvalidValue;
  const int64_t warps = (int64_t)B * ((M + kRows - 1) / kRows);
  const int64_t blocks = (warps * 32 + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  rows_kernel<GATHER><<<(unsigned)blocks, kThreads, 0, stream>>>(src, ids, q, q_stride,
                                                                 out, n, B, M, d);
  return (int)cudaGetLastError();
}

}  // namespace l2rows
