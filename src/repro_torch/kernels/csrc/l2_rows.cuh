// The register kernels of the squared-L2 distances: gather_l2.cu's
// gather_l2_rows / gather_l2_ragged and gather_l2_row1 / gather_l2_ragged1
// (rows gathered by id from base) and batched_l2.cu's batched_l2_rows /
// batched_l2_ragged (rows of contiguous [M, d] tiles).  All compute
//
//   out[b, m] = sum_j (row(b, m)[j] - q[b, j])^2      (difference form)
//
// Bound on the card: bytes, 2-3 flops a byte.  What sets the time at the
// paths' shapes is latency: the chain of dependent round trips before the
// rows move, and how many row bytes are in flight while it runs.  So a
// warp owns R rows of one line b, and
//  * its lanes read the line's ids (when gathering) and the query line into
//    registers, and nothing waits at a __syncthreads(): the rows' loads wait
//    for the ids alone, two dependent trips in all (ptxas issues the query
//    line's load beside the rows', after the ids' shuffle: it lands from L2
//    before rows from device memory);
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
// Two kernels share that design, each templated on the rows a warp owns
// (R): 2 and 4 for gather_l2_tiled and batched_l2, 1 for gather_l2, whose
// unit is one (b, m) row (at R = 1 rows_sum is the one-row butterfly).  The
// wrappers (l2dist/ops.py) pick one:
//  * rows_kernel, R = 2 (or 1), one float4 of each row a lane, with a
//    256-byte L2 fetch (ld.global.nc.L1::no_allocate.L2::256B, which took
//    2-16% off its times on an H100): d % 4 == 0, d <= 128 and
//    16-byte-aligned rows and query lines (a query stride that is a
//    multiple of 4);
//  * ragged_kernel, R = 4 (or 1), K = ceil(d / 32) scalar columns of each
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
constexpr int kWarps = kThreads / 32;
// rows a warp owns in gather_l2_tiled's and batched_l2's launches
constexpr int kRows = 2;                    // rows_kernel
constexpr int kRaggedRows = 4;              // ragged_kernel
constexpr int kMaxD = 128;                  // one float4 a lane a row
constexpr int kRaggedMaxK = 8;              // scalar columns a lane: d <= 256

// A float4's squared differences, rounded as the block kernels' `d0 * d0 +
// d1 * d1 + d2 * d2 + d3 * d3` compiles (their SASS): d1² first, then the
// others fused in.  Written out, since nvcc fused d0² first at one row a
// warp.
__device__ __forceinline__ float sq_diff(float4 r, float4 q) {
  const float d0 = r.x - q.x;
  const float d1 = r.y - q.y;
  const float d2 = r.z - q.z;
  const float d3 = r.w - q.w;
  return __fmaf_rn(d3, d3, __fmaf_rn(d2, d2, __fmaf_rn(d0, d0, __fmul_rn(d1, d1))));
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

// The warp's place (grid_for's grid): line b, its first row m0 and how many
// of its R rows exist (nr); false for a warp past the last line or row.
// R = 1 reads b and m0 off a 2-D grid, with no 64-bit division: on an H100
// the one-row kernel took 2.55 µs at ids [128, 24] this way against 2.71
// µs on the 1-D grid, where a 32-bit division bought nothing (PERF.md §6).
template <int R>
__device__ __forceinline__ bool warp_rows(int B, int M, int64_t& b, int& m0, int& nr) {
  if constexpr (R == 1) {
    b = blockIdx.y;
    m0 = blockIdx.x * kWarps + (threadIdx.x >> 5);
    nr = 1;
    return m0 < M;
  } else {
    const int64_t w = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
    const int groups = (M + R - 1) / R;
    if (w >= (int64_t)B * groups) return false;
    b = w / groups;
    m0 = (int)(w - b * groups) * R;
    nr = min(R, M - m0);
    return true;
  }
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

// R rows a warp.  GATHER: row (b, m) is src[ids[b, m]], +inf where the id
// < 0 and NaN where it is >= n.  Otherwise row (b, m) is src[b M + m].
template <bool GATHER, int R>
__global__ void __launch_bounds__(kThreads)
rows_kernel(const float* __restrict__ src, const int32_t* __restrict__ ids,
            const float* __restrict__ q, int64_t q_stride, float* __restrict__ out,
            int64_t n, int B, int M, int d) {
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

// The grid of kThreads blocks with one warp per R rows of each of B lines
// (warp_rows), or one of 0 blocks if it would be too wide: R = 1, rows
// along x and lines along y; else every line's warps along x.
inline dim3 grid_for(int B, int M, int R) {
  if (R == 1) return B > 65535 ? dim3(0) : dim3((M + kWarps - 1) / kWarps, B);
  const int64_t warps = (int64_t)B * ((M + R - 1) / R);
  const int64_t blocks = (warps * 32 + kThreads - 1) / kThreads;
  return dim3(blocks > 0x7fffffffLL ? 0 : (unsigned)blocks);
}

// Launches the float4 kernel, R rows a warp, for d % 4 == 0, d <= kMaxD;
// returns cudaGetLastError().
template <bool GATHER, int R>
int launch(const float* src, const int32_t* ids, const float* q, int64_t q_stride,
           float* out, int64_t n, int B, int M, int d, cudaStream_t stream) {
  if (B == 0 || M == 0) return 0;
  const dim3 grid = grid_for(B, M, R);
  if (d % 4 != 0 || d > kMaxD || grid.x == 0) return (int)cudaErrorInvalidValue;
  rows_kernel<GATHER, R><<<grid, kThreads, 0, stream>>>(src, ids, q, q_stride, out, n, B,
                                                        M, d);
  return (int)cudaGetLastError();
}

// Launches the scalar kernel, R rows a warp, for 0 <= d <= 32 kRaggedMaxK,
// its K the fewest columns that cover d; returns cudaGetLastError().
template <bool GATHER, int R>
int launch_ragged(const float* src, const int32_t* ids, const float* q, int64_t q_stride,
                  float* out, int64_t n, int B, int M, int d, cudaStream_t stream) {
  if (B == 0 || M == 0) return 0;
  const dim3 grid = grid_for(B, M, R);
  if (d < 0 || d > 32 * kRaggedMaxK || grid.x == 0) return (int)cudaErrorInvalidValue;
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
