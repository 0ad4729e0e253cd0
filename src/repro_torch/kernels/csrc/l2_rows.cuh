// The register kernels of the squared-L2 distances: gather_l2.cu's
// gather_l2_rows / gather_l2_ragged (rows gathered by id from base) and
// batched_l2.cu's batched_l2_rows / batched_l2_ragged (rows of contiguous
// [M, d] tiles).  All compute
//
//   out[b, m] = sum_j (row(b, m)[j] - q[b, j])^2      (difference form)
//
// Bound on the card: bytes, 2-3 flops a byte.  What sets the time at the
// paths' shapes is latency: the chain of dependent round trips before the
// rows move, and how many row bytes are in flight while it runs.  So a
// warp owns R rows of one line b, and
//  * its lanes read the line's ids (when gathering) and the query line, into
//    registers, at once: neither waits for the other, and nothing waits at
//    a __syncthreads();
//  * every row's loads are issued before any row is reduced, whole and
//    coalesced, with L1 skipped (ld.global.nc.L1::no_allocate): each row
//    is read once;
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
// Two kernels share that design; the wrappers (l2dist/ops.py) pick one:
//  * rows_kernel, 2 rows a warp, one float4 of each row a lane, with a
//    256-byte L2 fetch (ld.global.nc.L1::no_allocate.L2::256B, which took
//    2-16% off its times on an H100): d % 4 == 0, d <= 128 and
//    16-byte-aligned rows and query lines (a query stride that is a
//    multiple of 4);
//  * ragged_kernel, 4 rows a warp, K = ceil(d / 32) scalar columns of each
//    row a lane (lane l holds column l + 32 k) and no L2 fetch size: any d
//    up to 256 and any row offset or query stride, since a float needs
//    only 4-byte alignment.  MIPS's augmented d + 1 = 129 (516-byte rows,
//    4-byte aligned) is its case: each k is one coalesced 128-byte warp
//    access, the 129th float one lane's load.  Each lane sums its columns
//    in k order and the lanes meet in the one-row butterfly's pairs, the
//    order of the block kernels' scalar loop, so a row's sum equals theirs
//    to the bit.  (Two other layouts measured slower on an H100 at d = 129:
//    float4s of each row's 16-byte-aligned window with the query shifted
//    to match, and loads aligned to 128-byte lines shuffled back into
//    columns; PERF.md §6.)
// Wider rows take the one-row-a-warp block kernels of gather_l2.cu and
// batched_l2.cu.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace l2rows {

constexpr int kThreads = 128;
constexpr int kRows = 2;                    // rows a warp owns (rows_kernel)
constexpr int kMaxD = 128;                  // one float4 a lane a row
constexpr int kRaggedRows = 4;             // rows a warp owns (ragged_kernel)
constexpr int kRaggedMaxK = 8;              // scalar columns a lane: d <= 256

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

// A row's float: read once, so L1 is skipped, and no L2 fetch size.  A
// 516-byte row that starts 4-byte aligned spans three 256-byte blocks, so
// load_row's 256-byte fetch reads up to 768 bytes for it: on an H100 at
// MIPS's d + 1 = 129 it cost the gather 11% (7.51 against 6.76 µs;
// PERF.md §6), and no L2 hint moved d = 128 or the contiguous tiles by more
// than 2%.
__device__ __forceinline__ float load_col(const float* p) {
  float v;
  asm volatile("ld.global.nc.L1::no_allocate.f32 %0, [%1];\n" : "=f"(v) : "l"(p));
  return v;
}

// The warp's place: line b, its first row m0 and how many of its R rows
// exist (nr); false for a warp past the last line.
template <int R>
__device__ __forceinline__ bool warp_rows(int B, int M, int64_t& b, int& m0, int& nr) {
  const int64_t w = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int groups = (M + R - 1) / R;
  if (w >= (int64_t)B * groups) return false;
  b = w / groups;
  m0 = (int)(w - b * groups) * R;
  nr = min(R, M - m0);
  return true;
}

// Row r of the warp: GATHER, src[ids[b, m0 + r]] (ok false, and row 0, for
// an id < 0 or >= n: no load); else src[b M + m0 + r].
template <bool GATHER>
__device__ __forceinline__ int64_t row_of(int32_t my_id, int r, int nr, int64_t b, int M,
                                          int m0, int64_t n, bool& ok) {
  ok = r < nr;
  if (!GATHER) return b * M + m0 + r;
  const int32_t id = __shfl_sync(0xffffffffu, my_id, r);
  ok = ok && id >= 0 && id < n;
  return ok ? id : 0;
}

// The lanes holding row sums write them: +inf where the id < 0 and NaN
// where it is >= n when gathering.
template <bool GATHER, int R>
__device__ __forceinline__ void store_sums(float sum, int32_t my_id, int lane, int nr,
                                           int64_t b, int M, int m0, int64_t n,
                                           float* __restrict__ out) {
  const int r = lane / (32 / R);             // the row whose sum this lane holds
  if (GATHER) {
    const int32_t id = __shfl_sync(0xffffffffu, my_id, r);
    if (id < 0) sum = CUDART_INF_F;
    else if (id >= n) sum = CUDART_NAN_F;
  }
  if (lane % (32 / R) == 0 && r < nr) out[b * M + m0 + r] = sum;
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
  int64_t b;
  int m0, nr;
  if (!warp_rows<R>(B, M, b, m0, nr)) return;
  const bool col = lane < (d >> 2);         // this lane's float4 is in the row
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  const int32_t my_id = GATHER && lane < nr ? __ldg(ids + b * M + m0 + lane) : -1;
  const float4 qv =
      col ? __ldg(reinterpret_cast<const float4*>(q + b * q_stride) + lane) : zero;

  float4 x[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    bool ok;
    const int64_t row = row_of<GATHER>(my_id, r, nr, b, M, m0, n, ok);
    x[r] = ok && col ? load_row(reinterpret_cast<const float4*>(src + row * d) + lane) : zero;
  }
  float a[R];
#pragma unroll
  for (int r = 0; r < R; ++r) a[r] = col ? sq_diff(x[r], qv) : 0.f;
  store_sums<GATHER, R>(rows_sum<R>(a, lane), my_id, lane, nr, b, M, m0, n, out);
}

// The same with K scalar columns a lane (column l + 32 k, k < K): any d <=
// 32 K, any alignment.  Columns past d read nothing and count as 0 on both
// sides, which leaves a lane's sum unchanged.
template <bool GATHER, int R, int K>
__global__ void __launch_bounds__(kThreads)
ragged_kernel(const float* __restrict__ src, const int32_t* __restrict__ ids,
              const float* __restrict__ q, int64_t q_stride, float* __restrict__ out,
              int64_t n, int B, int M, int d) {
  const int lane = threadIdx.x & 31;
  int64_t b;
  int m0, nr;
  if (!warp_rows<R>(B, M, b, m0, nr)) return;

  const int32_t my_id = GATHER && lane < nr ? __ldg(ids + b * M + m0 + lane) : -1;
  float qv[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = lane + 32 * k;
    qv[k] = j < d ? __ldg(q + b * q_stride + j) : 0.f;
  }

  float x[R][K];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    bool ok;
    const float* p = src + row_of<GATHER>(my_id, r, nr, b, M, m0, n, ok) * d;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = lane + 32 * k;
      x[r][k] = ok && j < d ? load_col(p + j) : 0.f;
    }
  }
  float a[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float diff = x[r][k] - qv[k];
      acc += diff * diff;
    }
    a[r] = acc;
  }
  store_sums<GATHER, R>(rows_sum<R>(a, lane), my_id, lane, nr, b, M, m0, n, out);
}

// Blocks of kThreads for one warp per R rows of each of B lines, or 0 if the
// grid would be too wide.
inline int64_t grid_blocks(int B, int M, int R) {
  const int64_t warps = (int64_t)B * ((M + R - 1) / R);
  const int64_t blocks = (warps * 32 + kThreads - 1) / kThreads;
  return blocks > 0x7fffffffLL ? 0 : blocks;
}

// Launches the float4 kernel for d % 4 == 0, d <= kMaxD; returns
// cudaGetLastError().
template <bool GATHER>
int launch(const float* src, const int32_t* ids, const float* q, int64_t q_stride,
           float* out, int64_t n, int B, int M, int d, cudaStream_t stream) {
  if (B == 0 || M == 0) return 0;
  const int64_t blocks = grid_blocks(B, M, kRows);
  if (d % 4 != 0 || d > kMaxD || blocks == 0) return (int)cudaErrorInvalidValue;
  rows_kernel<GATHER><<<(unsigned)blocks, kThreads, 0, stream>>>(src, ids, q, q_stride,
                                                                 out, n, B, M, d);
  return (int)cudaGetLastError();
}

// Launches the scalar kernel for 0 <= d <= 32 kRaggedMaxK, its K the
// fewest columns that cover d; returns cudaGetLastError().
template <bool GATHER>
int launch_ragged(const float* src, const int32_t* ids, const float* q, int64_t q_stride,
                  float* out, int64_t n, int B, int M, int d, cudaStream_t stream) {
  if (B == 0 || M == 0) return 0;
  constexpr int R = kRaggedRows;
  const int64_t blocks = grid_blocks(B, M, R);
  if (d < 0 || d > 32 * kRaggedMaxK || blocks == 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  static_assert(kRaggedMaxK == 8, "one case per K up to kRaggedMaxK");
#define L2_RAGGED_CASE(K)                                                        \
  case K:                                                                        \
    ragged_kernel<GATHER, R, K><<<grid, kThreads, 0, stream>>>(src, ids, q, q_stride, \
                                                               out, n, B, M, d); \
    break;
  switch (d <= 32 ? 1 : (d + 31) / 32) {
    L2_RAGGED_CASE(1)
    L2_RAGGED_CASE(2)
    L2_RAGGED_CASE(3)
    L2_RAGGED_CASE(4)
    L2_RAGGED_CASE(5)
    L2_RAGGED_CASE(6)
    L2_RAGGED_CASE(7)
    L2_RAGGED_CASE(8)
  }
#undef L2_RAGGED_CASE
  return (int)cudaGetLastError();
}

}  // namespace l2rows
