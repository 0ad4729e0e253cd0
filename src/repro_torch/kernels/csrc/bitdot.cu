// RaBitQ S+ contraction over packed sign codes, batched over queries.
//
//   out[b, k] = sum over set bits j of word w of codes[b, k, w] of q[b, 32 w + j]
//
// codes is int32 [B, K, W] (the uint32 words of the JAX package, bit for
// bit), q is f32 [B, d] with d <= 32 W; the kernel reads q as 0 past d.
//
// Replaces the TPU kernel bitdot_pallas in src/repro/kernels/bitdot/bitdot.py,
// which unpacked a (TM, W) tile to {0,1} floats in vector registers and
// contracted it with the query on the matrix unit.  On Hopper there is no
// product worth the tensor cores here (one query line per code row), so the
// unpack and the adds happen in the lanes, on the row body of
// rabitq_rows.cuh.
//
// Bound on the card: bytes (4 W bytes and 16 W adds a row), far under the
// launch: at the probe's [128, 24, 4] the input is 0.13 MB.  What sets the
// time is the launch floor plus one memory trip: the rows are contiguous,
// so a warp's rows and its query line are loaded together, straight into
// registers, and nothing waits at a barrier.

#include "rabitq_rows.cuh"

namespace {

// N: the words of the rows' last chunk (rabitq::with_last_chunk)
template <int N>
__global__ void __launch_bounds__(rabitq::kThreads)
bitdot_kernel(const int32_t* __restrict__ codes, const float* __restrict__ q,
              float* __restrict__ out, int K, int full, int d) {
  int64_t b;
  int k0, nr;
  if (!rabitq::warp_rows(K, b, k0, nr)) return;
  const int lane = threadIdx.x & 31;
  const int W = rabitq::kChunk * full + N;
  const float s = rabitq::s_plus<N>(q + b * d, full, d, lane, [&] {
    return codes + (b * K + rabitq::lane_row(k0, nr, lane)) * W;
  });
  const int r = lane / (32 / rabitq::kRows);
  if (lane % (32 / rabitq::kRows) == 0 && r < nr) out[b * K + k0 + r] = s;
}

}  // namespace

extern "C" int bitdot_rows(const int32_t* codes, const float* q, float* out,
                           int B, int K, int W, int d, void* stream) {
  if (B == 0 || K == 0) return 0;
  rabitq::with_last_chunk(W, [&](auto n) {
    bitdot_kernel<decltype(n)::value>
        <<<rabitq::grid(B, K), rabitq::kThreads, 0, (cudaStream_t)stream>>>(
            codes, q, out, K, (W - 1) / rabitq::kChunk, d);
  });
  return (int)cudaGetLastError();
}
