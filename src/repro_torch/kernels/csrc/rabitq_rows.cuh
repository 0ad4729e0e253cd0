// The row body of the RaBitQ kernels: bitdot.cu's bitdot_rows (code rows
// already gathered, [B, K, W]) and fused_estimate.cu's fused_estimate (code
// rows gathered by id from the [n, W] table).  Both compute, for each code
// row and its query line q (d floats, d <= 32 W),
//
//   S+ = sum over set bits j of word w of the row of q[32 w + j]
//
// Bound on the card: bytes, and far under the launch.  A row is 4 W bytes
// (16 B at d = 128) and 32 W / 2 adds; a launch of the paths' [128, 24]
// rows moves 0.13-0.18 MB, 0.04-0.05 us of an H100's memory rate.  What
// sets the time is the launch floor, the chain of dependent memory trips
// after it (one for bitdot: the rows and the query line; two for
// fused_estimate: the ids, then the rows and the ids' scalars) and the
// instructions each warp issues before its last load.  So
//  * a warp owns kRows rows of one query line b, and lane 8 r + i loads word
//    i of a chunk of 8 words of row r: one load instruction, at most 32
//    bytes a row, for all of a chunk's words, which __shfl_sync hands to
//    every lane;
//  * the query line lives in registers: lane j loads q[32 w + j] of the
//    chunk's words itself (coalesced 128-byte lines that the warps of a
//    block, all of one query line, share through L1), 0 past d; no shared
//    memory, no __syncthreads(), and no address that waits on another load
//    but a row's on its id;
//  * every load of a chunk is issued before its first add, and the last
//    chunk's (the only one at W <= 8) before the rows are located; the
//    chunk's word count is a template parameter, so the adds unroll with
//    no branch between the shuffles;
//  * lane j adds q[32 w + j] for the words w of a row whose bit j is set, w
//    ascending, and the rows' lane sums meet in l2_rows.cuh's rows_sum, in
//    the pairs and order of one xor butterfly (16, 8, 4, 2, 1) a row.  That
//    is the order of the shared-memory kernels these replaced, one warp a
//    row, so S+ is theirs to the bit; kernels/bitdot/ref.py's
//    s_plus_kernel_order sums in the same order on the host.
// W past 8 words (d > 256; d = 960, GIST1M's width, gives W = 30: three
// full chunks and a last of 6 words) takes its full chunks first, in a loop.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "l2_rows.cuh"

namespace rabitq {

constexpr int kThreads = 128;               // 4 warps a block, all of one query line
constexpr int kRows = 4;                    // rows a warp owns
constexpr int kChunk = 8;                   // code words a chunk: a lane loads one
constexpr int kWarpRows = kRows * kThreads / 32;   // rows a block owns

// The block's query line b and the warp's first row k0 and row count nr
// (grid: ceil(K / kWarpRows) blocks by B); false past the last row.
__device__ __forceinline__ bool warp_rows(int K, int64_t& b, int& k0, int& nr) {
  b = blockIdx.y;
  k0 = blockIdx.x * kWarpRows + (threadIdx.x >> 5) * kRows;
  nr = min(kRows, K - k0);
  return nr > 0;
}

// The row whose words the lane loads: lane 8 r + i, row r of the warp (its
// last row where r >= kRows, and the warp's last existing row past K).
__device__ __forceinline__ int lane_row(int k0, int nr, int lane) {
  return k0 + min(lane / kChunk, nr - 1);
}

// The lane's query registers of the N words from w0: q[32 (w0 + i) + lane],
// 0 past d.
template <int N>
__device__ __forceinline__ void load_query(float (&qv)[kChunk], const float* __restrict__ q,
                                           int w0, int d, int lane) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int j = 32 * (w0 + i) + lane;
    qv[i] = j < d ? __ldg(q + j) : 0.f;
  }
}

// Word w0 + i of the lane's row for lane 8 r + i (word w0 + N - 1 for i >= N,
// never added): one request of the chunk's words for every row.
template <int N>
__device__ __forceinline__ uint32_t load_words(const int32_t* __restrict__ row, int w0,
                                               int lane) {
  return (uint32_t)__ldg(row + w0 + min(lane % kChunk, N - 1));
}

// acc[r] += q[32 w + lane] for each of the N words w of the chunk whose bit
// `lane` is set in row r, w ascending.
template <int N>
__device__ __forceinline__ void add_chunk(float (&acc)[kRows], const float (&qv)[kChunk],
                                          uint32_t words, int lane) {
  uint32_t w[N][kRows];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int r = 0; r < kRows; ++r) w[i][r] = __shfl_sync(0xffffffffu, words, kChunk * r + i);
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if ((w[i][r] >> lane) & 1u) acc[r] += qv[i];
}

// S+ of the warp's rows, W = kChunk * full + N words each, against the query
// line q (d floats); every lane returns the S+ of row lane / (32 / kRows).
// row_of() returns the first word of the lane's row (lane_row); it is
// called after the last chunk's query loads are issued.
template <int N, class RowOf>
__device__ __forceinline__ float s_plus(const float* __restrict__ q, int full, int d,
                                        int lane, RowOf row_of) {
  float qv[kChunk];
  load_query<N>(qv, q, kChunk * full, d, lane);
  const int32_t* __restrict__ row = row_of();
  float acc[kRows] = {};
  for (int c = 0; c < full; ++c) {
    float qc[kChunk];
    load_query<kChunk>(qc, q, kChunk * c, d, lane);
    add_chunk<kChunk>(acc, qc, load_words<kChunk>(row, kChunk * c, lane), lane);
  }
  add_chunk<N>(acc, qv, load_words<N>(row, kChunk * full, lane), lane);
  return l2rows::rows_sum<kRows>(acc, lane);
}

// The launch grid of a [B, K] batch of rows: ceil(K / kWarpRows) by B.
inline dim3 grid(int B, int K) { return dim3((K + kWarpRows - 1) / kWarpRows, B); }

// Calls f(std::integral_constant<int, N>()) for the N words of W's last
// chunk: W = kChunk * ((W - 1) / kChunk) + N, 1 <= N <= kChunk.
template <class F>
void with_last_chunk(int W, F f) {
  switch (W - kChunk * ((W - 1) / kChunk)) {
    case 1: f(std::integral_constant<int, 1>()); break;
    case 2: f(std::integral_constant<int, 2>()); break;
    case 3: f(std::integral_constant<int, 3>()); break;
    case 4: f(std::integral_constant<int, 4>()); break;
    case 5: f(std::integral_constant<int, 5>()); break;
    case 6: f(std::integral_constant<int, 6>()); break;
    case 7: f(std::integral_constant<int, 7>()); break;
    default: f(std::integral_constant<int, 8>()); break;
  }
}

}  // namespace rabitq
