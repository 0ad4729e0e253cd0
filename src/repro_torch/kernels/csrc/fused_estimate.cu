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
// bit for bit), q is f32 [B, d] with d <= 32 W (the rotated unit query; the
// kernel reads it as 0 past d), and sqrt_d points at one float on the card.
//
// Replaces the TPU kernel fused_estimate_pallas in
// src/repro/kernels/bitdot/bitdot.py, which took code rows that XLA had
// already gathered, unpacked a (TM, W) tile to {0,1} floats and contracted
// it on the matrix unit before the estimator algebra.  Here the kernel
// gathers by id, as gather_l2.cu does, so one launch replaces the gather,
// the unpack, the product and the twenty-odd elementwise ops of the plain
// version.  A warp sums s for its ids on the row body of rabitq_rows.cuh
// (each lane reads the id of the row whose words it loads), and the lane
// that holds a row's s applies the estimate.
//
// Bound on the card: bytes (4 W + 8 bytes from random rows of the code
// table and the two scalar arrays, 24 B at d = 128), far under the launch:
// at the drain's [128, 24] a launch moves 0.16 MB.  What sets the time is
// the launch floor plus two dependent memory trips: the id, the query line
// and the query's scalars load together; then the id's row, norms[id] and
// ip_xo[id] load together, before any add.  Invalid ids read row 0 and
// take +inf or NaN at the end.

#include <math_constants.h>

#include "rabitq_rows.cuh"

namespace {

// N: the words of the rows' last chunk (rabitq::with_last_chunk)
template <int N>
__global__ void __launch_bounds__(rabitq::kThreads)
fused_estimate_kernel(const int32_t* __restrict__ codes,
                      const float* __restrict__ norms,
                      const float* __restrict__ ip_xo,
                      const int32_t* __restrict__ ids,
                      const float* __restrict__ q,
                      const float* __restrict__ sum_q,
                      const float* __restrict__ norm_q,
                      const float* __restrict__ sqrt_d,
                      float* __restrict__ out,
                      int64_t n, int K, int full, int d) {
  int64_t b;
  int k0, nr;
  if (!rabitq::warp_rows(K, b, k0, nr)) return;
  const int lane = threadIdx.x & 31;
  const int W = rabitq::kChunk * full + N;
  const int32_t id = __ldg(ids + b * K + rabitq::lane_row(k0, nr, lane));
  const float sq = __ldg(sum_q + b);
  const float nq = __ldg(norm_q + b);
  const float sd = __ldg(sqrt_d);
  float nv, ipx;
  const float s = rabitq::s_plus<N>(q + b * d, full, d, lane, [&] {
    const int64_t row = id >= 0 && id < n ? id : 0;
    nv = __ldg(norms + row);
    ipx = __ldg(ip_xo + row);
    return codes + row * W;
  });
  const int r = lane / (32 / rabitq::kRows);
  if (lane % (32 / rabitq::kRows) != 0 || r >= nr) return;
  float v;
  if (id < 0) {
    v = CUDART_INF_F;
  } else if (id >= n) {
    v = CUDART_NAN_F;
  } else {
    const float ip_xq = (2.f * s - sq) / sd;
    const float est_cos = ip_xq / fmaxf(ipx, 1e-6f);
    // nv^2 + nq^2 - 2 nv nq est_cos as the two fused multiply-adds that
    // nvcc 12.8 makes of that expression (the shared-memory kernel's SASS),
    // written out so that the plain version (ref.py's
    // fused_estimate_kernel_order) rounds where this does
    const float d2 = __fmaf_rn(-2.f * nv * nq, est_cos,
                               __fmaf_rn(nq, nq, __fmul_rn(nv, nv)));
    v = fmaxf(d2, 0.f);
  }
  out[b * K + k0 + r] = v;
}

}  // namespace

extern "C" int fused_estimate(const int32_t* codes, const float* norms,
                              const float* ip_xo, const int32_t* ids,
                              const float* q, const float* sum_q,
                              const float* norm_q, const float* sqrt_d,
                              float* out, int64_t n, int B, int K, int W,
                              int d, void* stream) {
  if (B == 0 || K == 0) return 0;
  rabitq::with_last_chunk(W, [&](auto m) {
    fused_estimate_kernel<decltype(m)::value>
        <<<rabitq::grid(B, K), rabitq::kThreads, 0, (cudaStream_t)stream>>>(
            codes, norms, ip_xo, ids, q, sum_q, norm_q, sqrt_d, out, n, K,
            (W - 1) / rabitq::kChunk, d);
  });
  return (int)cudaGetLastError();
}
