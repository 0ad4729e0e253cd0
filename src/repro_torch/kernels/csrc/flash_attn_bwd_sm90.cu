// Flash-attention backward on Hopper's tensor cores, bf16: dQ, dK and dV of
// causal / sliding-window / bidirectional softmax attention with grouped KV
// heads, from the forward's per-row log-sum-exp.
//
//   s[b, h, i, t] = q[b, i, h, :] . k[b, t, h / G, :] / sqrt(hd)   (masked)
//   P = softmax_t(s) = 2^(s log2(e) - lse),  o = P v,  dO = dL/do
//   dV[t] = sum_{h in group, i} P[i, t] dO[i]
//   dS    = P * (dO v^T - D),  D[i] = rowsum(dO[i] * o[i])
//   dQ[i] = sum_t dS[i, t] k[t] / sqrt(hd)
//   dK[t] = sum_{h in group, i} dS[i, t] q[i] / sqrt(hd)
//
// over the keys t that pass the forward's mask: t < S, and t <= i when
// causal, and i - t < window when a window is given.  q, o and dO are
// [B, S, H, hd] and k, v [B, S, KV, hd] with G = H / KV, bf16; q, k, v and
// dO are read in place by TMA through their strides (the last one 1), o by
// its element strides.  lse is the forward's float32 [B, H, S] in log2
// units (flash_attn_sm90.cu writes it).  dQ, dK and dV are new contiguous
// bf16 tensors, each element rounded once from its f32 sum.  The float32
// backward stays on the CUDA cores (flash_attn_bwd.cuh).
//
// Replaces no TPU kernel: flash_attention_pallas (src/repro/kernels/
// flashattn/flashattn.py) has no backward, and the JAX package trains
// through jax.grad of the jnp blockwise attention (src/repro/models/
// common.py: flash_attention).  This is the port's counterpart of that
// autodiff for bf16, behind a torch.autograd.Function whose forward is
// flash_attn_sm90.cu.
//
// Bound on the card: operations.  At the train step's shape (B = 4,
// S = 4,096, 9 heads over 3 KV heads, hd = 64, causal) the five products
// of the backward (S again, dP, dV, dQ, dK) are 2.5x the forward's
// 4 hd S(S+1)/2 H B = 7.7e10, 1.9e11 operations: 0.2 ms at the bf16
// tensor-core rate, against 0.05 GB of inputs and outputs.  This design
// issues 10 tensor-core passes where that count has 5: S and dP once in
// each of the two product kernels, and dV, dK and dQ twice each (P and
// dS go in as two bf16 terms).
//
// Design, three kernels on one stream, no atomics (every run gives the
// same bits; so dQ is not summed across key blocks as FlashAttention-3
// does, and the dQ kernel recomputes S and dP instead):
//  1. dsum: D = rowsum(dO * o), one warpgroup a 64-row tile, as the
//     diagonal of dO o^T on the tensor cores: the same m64n64k16 wgmma
//     steps in the same order as the dq kernel's dP = dO V^T, so on a row
//     whose only key is its own (the first of a causal sequence: P = 1, o
//     = v to the bit) D equals dP to the bit and dS = P (dP - D) is 0, as
//     in exact arithmetic (an f32 sum in another order left f32 noise in
//     that row's dq, the size of the gradient bound's floor at the train
//     step's shape).  Into f32 scratch [B, H, S_pad] (S_pad = S rounded up
//     to 128), beside a copy of lse in the same layout; padded rows get
//     lse = 1e30 and D = 0, so their p is 0 and no product needs a row
//     mask past S.  The layout lets one bulk copy (cp.async.bulk) bring a
//     tile's slice.
//  2. dkdv: one block (CTA) a (batch, KV head, 128-key block): warps 0-7
//     are two consumer warpgroups of 64 keys each, warps 8-11 the producer
//     warpgroup (setmaxnreg gives its registers to the consumers), which
//     loads through one lane.  K and V of the block are loaded once by
//     TMA; the producer then walks the G query heads of the group and the
//     query tiles of BQ rows in the causal / window band, keeping Q, dO
//     and the tile's slices of lse and D in flight through a ring of
//     kStages stages (full / empty mbarriers).  Per tile a warpgroup runs
//       S^T = K Q^T and dP^T = V dO^T   wgmma, A and B from shared memory,
//                                      both K-major (the forward's Q K^T
//                                      with K or V as A), one commit group;
//       P^T = 2^(S^T scale log2(e) - lse[col]), dS^T = P^T (dP^T - D[col])
//                                      in registers (lse and D broadcast
//                                      along the columns: a lane reads the
//                                      pairs at columns 8 j + 2 t);
//       dV += P^T dO and dK += dS^T Q  wgmma with A from registers: the f32
//                                      accumulator fragment of S^T is the
//                                      bf16 A fragment of P^T in the same
//                                      lanes; dO and Q are MN-major B from
//                                      the same tiles (no transpose).
//     P^T and dS^T each go in as two bf16 terms, hi = bf16(x) and lo =
//     bf16(x - hi), as the forward's P: one term moves dv (P) or dq and dk
//     (dS) 17-29x past the gradient bound (ref.grad_err_ratio) in an
//     emulation on the CPU, two keep them within it.  The group's heads
//     are summed in the block's registers, so nothing crosses blocks.
//     BQ = 64 at hd <= 64 and 32 past it, where the two f32 accumulators
//     of a 64-key tile take hd registers a thread.
//  3. dq: one block a (batch, head, 128-row query tile), two consumer
//     warpgroups of 64 rows and a producer as in dkdv; Q and dO of the
//     tile loaded once, K and V tiles of 64 keys through the ring.  Per
//     tile S = Q K^T and dP = dO V^T (wgmma from shared memory), P and dS
//     in registers from the rows' lse and D, dQ += dS K (dS from registers
//     as two bf16 terms, K an MN-major B).
// Masks apply only on tiles that cut the causal / window band (and, in
// dq, the keys past S); tiles wholly outside the band are not loaded, and
// a warpgroup whose 64 rows a tile misses skips its products.  Blocks are
// issued heaviest first (dkdv: the first key block sees the most queries
// under a causal mask; dq: the last query tile sees the most keys).

#include "flash_sm90.cuh"

namespace {

constexpr int kKeys = 128;                 // keys of a dK / dV block
constexpr int kRows = 128;                 // query rows of a dQ block
constexpr int kConsumers = 256;            // two warpgroups of 64 rows
constexpr int kThreads = kConsumers + 128; // and a producer warpgroup
// Registers a thread: an SM sub-partition holds one warp of each of the
// three warpgroups in its 512 a lane; the producer keeps 40
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;
constexpr int kStages = 4;                 // ring depth
constexpr int kPad = 128;                  // lse / D rows padded to a multiple of this
constexpr float kPadLse = 1e30f;           // a padded row's lse: its p is 0

template <int HD>
struct Cfg {
  static constexpr int kHalves = (HD + 63) / 64;           // 64-column halves of a row
  // dkdv: query rows of a ring tile (the N of S^T and dP^T, the K of the
  // dV and dK products)
  static constexpr int kBQ = HD <= 64 ? 64 : 32;
  static constexpr int kKVBytes = kHalves * kKeys * 128;   // the K or the V block
  static constexpr int kQTile = kHalves * kBQ * 128;       // one Q or dO stage
  static constexpr int kRowBytes = kBQ * 4;                // one lse or D stage
  static constexpr int kDkdvBar = 2 * kKVBytes + kStages * (2 * kQTile + 2 * kRowBytes);
  // + 1024 to align the tiles to a swizzle atom, + the mbarriers
  static constexpr int kDkdvSmem = kDkdvBar + 1024 + 8 * (1 + 2 * kStages);
  // dq: keys of a ring tile
  static constexpr int kBK = 64;
  static constexpr int kRowTile = kHalves * kRows * 128;   // the Q or the dO tile
  static constexpr int kKTile = kHalves * kBK * 128;       // one K or V stage
  static constexpr int kDqBar = 2 * kRowTile + 2 * kStages * kKTile;
  static constexpr int kDqSmem = kDqBar + 1024 + 8 * (1 + 2 * kStages);
};

__device__ __forceinline__ uint8_t* align_1024(uint8_t* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// ------------------------------------------------------------------- dsum

constexpr int kDsumRows = 64;              // rows of a dsum block: one warpgroup

// D = rowsum(dO * o) of a 64-row tile as the diagonal of dO o^T on the
// tensor cores (the same m64n64k16 steps as the dq kernel's dP = dO V^T),
// and the tile's lse, into the padded layout; rows past S get kPadLse, 0.
template <int HD>
__global__ void __launch_bounds__(128)
bwd_dsum_sm90(const __grid_constant__ CUtensorMap domap,
              const __grid_constant__ CUtensorMap omap, const float* __restrict__ lse,
              float* __restrict__ lse_pad, float* __restrict__ dsum_pad, int S, int S_pad,
              int H, int B) {
  constexpr int kHalves = (HD + 63) / 64;
  constexpr int kTile = kHalves * kDsumRows * 128;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* do_s = align_1024(smem_raw);
  uint8_t* o_s = do_s + kTile;
  uint64_t* bar = reinterpret_cast<uint64_t*>(o_s + kTile);
  const int q0 = blockIdx.x / (H * B) * kDsumRows;
  const int hb = blockIdx.x % (H * B);
  const int h = hb % H, b = hb / H;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    fence_mbar_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, 2 * kTile);
    for (int hf = 0; hf < kHalves; ++hf) {
      tma_load_4d(do_s + hf * kDsumRows * 128, &domap, bar, 64 * hf, h, q0, b);
      tma_load_4d(o_s + hf * kDsumRows * 128, &omap, bar, 64 * hf, h, q0, b);
    }
  }
  mbar_wait(bar, 0);
  __syncwarp();
  float acc[32];
  wgmma_fence();
  ss_steps<HD, 64, kDsumRows>(acc, smem_u32(do_s), smem_u32(o_s));
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 32; ++i) fence_reg(acc[i]);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    // row 16 warp + g + 8 half's diagonal element: group j = 2 warp + half,
    // element 2 half + g % 2, in lane 4 g + g / 2
    float mine = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w)
      if (w == warp)
        mine = (g & 1) ? acc[4 * (2 * w + half) + 2 * half + 1]
                       : acc[4 * (2 * w + half) + 2 * half];
    const float d = __shfl_sync(0xffffffffu, mine, 4 * g + g / 2);
    const int row = q0 + 16 * warp + g + 8 * half;
    if (t == 0) {
      const int64_t bh = static_cast<int64_t>(b) * H + h;
      dsum_pad[bh * S_pad + row] = row < S ? d : 0.f;
      lse_pad[bh * S_pad + row] = row < S ? lse[bh * S + row] : kPadLse;
    }
  }
}

// ------------------------------------------------------------------- dkdv

// dV += P^T dO and dK += dS^T Q for one warpgroup's 64 keys and a tile of
// BQ queries, from its S^T and dP^T fragments (accumulator j, e: key
// key0 + 8 (e / 2), query q0 + 8 j + 2 t + e % 2) and the tile's lse and D
// pairs.  Each k-step's 16 queries are turned into P^T and dS^T, split into
// bf16 hi and lo A fragments and issued at once, so the tensor cores take
// a k-step while the next one is computed.  On an edge tile (kEdge) pairs
// outside the band get p = 0.
template <int HD, int BQ, bool kEdge>
__device__ __forceinline__ void dkdv_tile(const float (&s)[BQ / 2], const float (&dp)[BQ / 2],
                                          float (&dk_acc)[HD / 2], float (&dv_acc)[HD / 2],
                                          const float2* lse2, const float2* d2,
                                          uint32_t q_addr, uint32_t do_addr, int q0, int key0,
                                          int t, float scale_log2, int causal, int window) {
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) {
    fence_reg(dv_acc[i]);
    fence_reg(dk_acc[i]);
  }
#pragma unroll
  for (int kk = 0; kk < BQ / 16; ++kk) {
    uint32_t ph[4], pl[4], dsh[4], dsl[4];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int j = 2 * kk + jj;
      const float2 L = lse2[4 * j + t], D = d2[4 * j + t];
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2_ftz(fmaf(s[4 * j + e], scale_log2, (e & 1) ? -L.y : -L.x));
        if (kEdge) {
          const int qpos = q0 + 8 * j + 2 * t + (e & 1), kpos = key0 + 8 * (e >> 1);
          if ((causal && kpos > qpos) || (window > 0 && qpos - kpos >= window)) p[e] = 0.f;
        }
        ds[e] = p[e] * (dp[4 * j + e] - ((e & 1) ? D.y : D.x));
      }
      split2(p[0], p[1], ph[2 * jj], pl[2 * jj]);
      split2(p[2], p[3], ph[2 * jj + 1], pl[2 * jj + 1]);
      split2(ds[0], ds[1], dsh[2 * jj], dsl[2 * jj]);
      split2(ds[2], ds[3], dsh[2 * jj + 1], dsl[2 * jj + 1]);
    }
    wgmma_fence();
    const uint64_t d_do = desc_sw128(do_addr + kk * 16 * 128, BQ * 128, 1024);
    const uint64_t d_q = desc_sw128(q_addr + kk * 16 * 128, BQ * 128, 1024);
    wgmma_rs<HD>(dv_acc, ph, d_do, 1);
    wgmma_rs<HD>(dv_acc, pl, d_do, 1);
    wgmma_rs<HD>(dk_acc, dsh, d_q, 1);
    wgmma_rs<HD>(dk_acc, dsl, d_q, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) {
    fence_reg(dv_acc[i]);
    fence_reg(dk_acc[i]);
  }
}

// dQ += dS K for one warpgroup's 64 rows and a tile of BK keys at k_addr,
// from its S and dP fragments (accumulator j, e: row row0 + 8 (e / 2),
// key k0 + 8 j + 2 t + e % 2) and the rows' lse and D, a k-step at a time
// as in dkdv_tile.  On an edge tile (kEdge) keys outside the band or past S
// get p = 0.
template <int HD, int BK, bool kEdge>
__device__ __forceinline__ void dq_tile(const float (&s)[BK / 2], const float (&dp)[BK / 2],
                                        float (&acc)[HD / 2], const float (&lse)[2],
                                        const float (&dsum)[2], uint32_t k_addr, int k0,
                                        int row0, int t, int S, float scale_log2, int causal,
                                        int window) {
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) fence_reg(acc[i]);
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    uint32_t dsh[4], dsl[4];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int j = 2 * kk + jj;
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2_ftz(fmaf(s[4 * j + e], scale_log2, -lse[e >> 1]));
        if (kEdge) {
          const int kpos = k0 + 8 * j + 2 * t + (e & 1), qpos = row0 + 8 * (e >> 1);
          if (kpos >= S || (causal && kpos > qpos) || (window > 0 && qpos - kpos >= window))
            p = 0.f;
        }
        ds[e] = p * (dp[4 * j + e] - dsum[e >> 1]);
      }
      split2(ds[0], ds[1], dsh[2 * jj], dsl[2 * jj]);
      split2(ds[2], ds[3], dsh[2 * jj + 1], dsl[2 * jj + 1]);
    }
    wgmma_fence();
    const uint64_t d_k = desc_sw128(k_addr + kk * 16 * 128, BK * 128, 1024);
    wgmma_rs<HD>(acc, dsh, d_k, 1);
    wgmma_rs<HD>(acc, dsl, d_k, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) fence_reg(acc[i]);
}

// The consumer warpgroups' side of bwd_dkdv_sm90: warpgroup wg owns keys
// k0 + 64 wg .. + 63 and sums their dK and dV over the block's tiles.
template <int HD>
__device__ __forceinline__ void dkdv_consume(
    uint8_t* k_s, uint8_t* v_s, uint8_t* q_s, uint8_t* do_s, const float* lse_s,
    const float* d_s, uint64_t* kv_full, uint64_t* full, uint64_t* empty,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int S, int KV, int b,
    int kvh, int k0, int qt_begin, int n_qt, int n_tiles, float scale, float scale_log2,
    int causal, int window) {
  using C = Cfg<HD>;
  constexpr int BQ = C::kBQ;
  setmaxnreg_inc<kConsumerRegs>();
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int kw0 = k0 + 64 * wg;                 // this warpgroup's first key
  const int key0 = kw0 + 16 * warp + g;         // this lane's keys: key0, key0 + 8
  const uint32_t k_addr = smem_u32(k_s) + wg * 64 * 128;
  const uint32_t v_addr = smem_u32(v_s) + wg * 64 * 128;

  float dk_acc[HD / 2], dv_acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  mbar_wait(kv_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages;
    const uint32_t phase = (i / kStages) & 1;
    const int q0 = (qt_begin + i % n_qt) * BQ;
    // tiles that hold no query any of this warpgroup's keys reach
    const bool dead = kw0 >= S || (causal && q0 + BQ - 1 < kw0) ||
                      (window > 0 && q0 - (kw0 + 63) >= window);
    // tiles that cut the band for some (key, query) pair
    const bool edge = (causal && q0 < kw0 + 63) ||
                      (window > 0 && q0 + BQ - 1 - kw0 >= window);
    mbar_wait(&full[st], phase);
    __syncwarp();
    if (!dead) {
      const uint32_t q_addr = smem_u32(q_s + st * C::kQTile);
      const uint32_t do_addr = smem_u32(do_s + st * C::kQTile);
      float s[BQ / 2], dp[BQ / 2];
      wgmma_fence();
      ss_steps<HD, BQ, kKeys>(s, k_addr, q_addr);      // S^T = K Q^T
      ss_steps<HD, BQ, kKeys>(dp, v_addr, do_addr);    // dP^T = V dO^T
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < BQ / 2; ++j) {
        fence_reg(s[j]);
        fence_reg(dp[j]);
      }
      const float2* lse2 = reinterpret_cast<const float2*>(lse_s + st * BQ);
      const float2* d2 = reinterpret_cast<const float2*>(d_s + st * BQ);
      if (edge)
        dkdv_tile<HD, BQ, true>(s, dp, dk_acc, dv_acc, lse2, d2, q_addr, do_addr, q0,
                                key0, t, scale_log2, causal, window);
      else
        dkdv_tile<HD, BQ, false>(s, dp, dk_acc, dv_acc, lse2, d2, q_addr, do_addr, q0,
                                 key0, t, scale_log2, causal, window);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);       // this warp is done with the stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= S) continue;
    const int64_t at = ((static_cast<int64_t>(b) * S + key) * KV + kvh) * HD + 2 * t;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + at + 8 * j) = __floats2bfloat162_rn(
          dk_acc[4 * j + 2 * r] * scale, dk_acc[4 * j + 2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at + 8 * j) =
          __floats2bfloat162_rn(dv_acc[4 * j + 2 * r], dv_acc[4 * j + 2 * r + 1]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dkdv_sm90(const __grid_constant__ CUtensorMap qmap,
              const __grid_constant__ CUtensorMap kmap,
              const __grid_constant__ CUtensorMap vmap,
              const __grid_constant__ CUtensorMap domap, const float* __restrict__ lse_pad,
              const float* __restrict__ dsum_pad, __nv_bfloat16* __restrict__ dk,
              __nv_bfloat16* __restrict__ dv, int S, int S_pad, int H, int KV, int B,
              float scale, float scale_log2, int causal, int window) {
  using C = Cfg<HD>;
  constexpr int BQ = C::kBQ;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* k_s = smem;
  uint8_t* v_s = k_s + C::kKVBytes;
  uint8_t* q_s = v_s + C::kKVBytes;                // stage st at + st * kQTile
  uint8_t* do_s = q_s + kStages * C::kQTile;
  float* lse_s = reinterpret_cast<float*>(do_s + kStages * C::kQTile);  // + st * BQ
  float* d_s = lse_s + kStages * BQ;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + C::kDkdvBar);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const int kt = blockIdx.x / (KV * B);           // 0 = the heaviest key block
  const int hb = blockIdx.x - kt * (KV * B);
  const int kvh = hb % KV, b = hb / KV;
  const int k0 = kt * kKeys;
  const int groups = H / KV;
  // the query tiles that see this key block: from its own (causal) to the
  // last row within the window of its last key
  const int qt_begin = causal ? k0 / BQ : 0;
  int q_last = S - 1;
  if (window > 0) q_last = min(q_last, k0 + kKeys - 1 + window - 1);
  const int n_qt = q_last / BQ + 1 - qt_begin;
  const int n_tiles = groups * n_qt;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kConsumers / 32);    // one arrival per consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer: one lane keeps the ring full
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(kv_full, 2 * C::kKVBytes);
      for (int hf = 0; hf < C::kHalves; ++hf) {
        tma_load_4d(k_s + hf * kKeys * 128, &kmap, kv_full, 64 * hf, kvh, k0, b);
        tma_load_4d(v_s + hf * kKeys * 128, &vmap, kv_full, 64 * hf, kvh, k0, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        mbar_wait(&empty[st], ((i / kStages) & 1) ^ 1);
        const int h = kvh * groups + i / n_qt;
        const int q0 = (qt_begin + i % n_qt) * BQ;
        uint8_t* qs = q_s + st * C::kQTile;
        uint8_t* dos = do_s + st * C::kQTile;
        mbar_expect_tx(&full[st], 2 * C::kQTile + 2 * C::kRowBytes);
        for (int hf = 0; hf < C::kHalves; ++hf) {
          tma_load_4d(qs + hf * BQ * 128, &qmap, &full[st], 64 * hf, h, q0, b);
          tma_load_4d(dos + hf * BQ * 128, &domap, &full[st], 64 * hf, h, q0, b);
        }
        const int64_t row = (static_cast<int64_t>(b) * H + h) * S_pad + q0;
        bulk_load(lse_s + st * BQ, lse_pad + row, C::kRowBytes, &full[st]);
        bulk_load(d_s + st * BQ, dsum_pad + row, C::kRowBytes, &full[st]);
      }
    }
  } else {
    dkdv_consume<HD>(k_s, v_s, q_s, do_s, lse_s, d_s, kv_full, full, empty, dk, dv, S,
                     KV, b, kvh, k0, qt_begin, n_qt, n_tiles, scale, scale_log2, causal,
                     window);
  }
}

// --------------------------------------------------------------------- dq

// The consumer warpgroups' side of bwd_dq_sm90: warpgroup wg owns query
// rows q0 + 64 wg .. + 63.
template <int HD>
__device__ __forceinline__ void dq_consume(
    uint8_t* q_s, uint8_t* do_s, uint8_t* k_s, uint8_t* v_s, uint64_t* q_full,
    uint64_t* full, uint64_t* empty, const float* __restrict__ lse_pad,
    const float* __restrict__ dsum_pad, __nv_bfloat16* __restrict__ dq, int S, int S_pad,
    int H, int b, int h, int q0, int kt_begin, int n_tiles, float scale, float scale_log2,
    int causal, int window) {
  using C = Cfg<HD>;
  constexpr int BK = C::kBK;
  setmaxnreg_inc<kConsumerRegs>();
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = q0 + 64 * wg + 16 * warp + g;  // this lane's rows: row0, row0 + 8
  const int wq_lo = q0 + 64 * wg, wq_hi = wq_lo + 63;
  const uint32_t q_addr = smem_u32(q_s) + wg * 64 * 128;
  const uint32_t do_addr = smem_u32(do_s) + wg * 64 * 128;
  float lse[2], dsum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {                  // rows past S read the padding
    const int64_t at = (static_cast<int64_t>(b) * H + h) * S_pad + row0 + 8 * r;
    lse[r] = lse_pad[at];
    dsum[r] = dsum_pad[at];
  }

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

  mbar_wait(q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages;
    const uint32_t phase = (i / kStages) & 1;
    const int k0 = (kt_begin + i) * BK;
    // tiles that hold no key of any of this warpgroup's rows
    const bool dead = wq_lo >= S || (causal && k0 > wq_hi) ||
                      (window > 0 && k0 + BK - 1 < wq_lo - window + 1);
    // tiles that cut the band or S for some row
    const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > wq_lo) ||
                      (window > 0 && wq_hi - k0 >= window);
    mbar_wait(&full[st], phase);
    __syncwarp();
    if (!dead) {
      const uint32_t k_addr = smem_u32(k_s + st * C::kKTile);
      const uint32_t v_addr = smem_u32(v_s + st * C::kKTile);
      float s[BK / 2], dp[BK / 2];
      wgmma_fence();
      ss_steps<HD, BK, kRows>(s, q_addr, k_addr);      // S = Q K^T
      ss_steps<HD, BK, kRows>(dp, do_addr, v_addr);    // dP = dO V^T
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        fence_reg(s[j]);
        fence_reg(dp[j]);
      }
      if (edge)
        dq_tile<HD, BK, true>(s, dp, acc, lse, dsum, k_addr, k0, row0, t, S, scale_log2,
                              causal, window);
      else
        dq_tile<HD, BK, false>(s, dp, acc, lse, dsum, k_addr, k0, row0, t, S, scale_log2,
                               causal, window);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);       // this warp is done with the stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    __nv_bfloat16* out = dq + ((static_cast<int64_t>(b) * S + row) * H + h) * HD + 2 * t;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * r] * scale, acc[4 * j + 2 * r + 1] * scale);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dq_sm90(const __grid_constant__ CUtensorMap qmap,
            const __grid_constant__ CUtensorMap kmap,
            const __grid_constant__ CUtensorMap vmap,
            const __grid_constant__ CUtensorMap domap, const float* __restrict__ lse_pad,
            const float* __restrict__ dsum_pad, __nv_bfloat16* __restrict__ dq, int S,
            int S_pad, int H, int B, int groups, float scale, float scale_log2, int causal,
            int window) {
  using C = Cfg<HD>;
  constexpr int BK = C::kBK;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* q_s = smem;
  uint8_t* do_s = q_s + C::kRowTile;
  uint8_t* k_s = do_s + C::kRowTile;              // stage st at + st * kKTile
  uint8_t* v_s = k_s + kStages * C::kKTile;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::kDqBar);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int n_rt = (S + kRows - 1) / kRows;
  const int rank = blockIdx.x / (H * B);          // 0 = the heaviest query tile
  const int hb = blockIdx.x - rank * (H * B);
  const int h = hb % H, b = hb / H;
  const int q0 = (n_rt - 1 - rank) * kRows;
  const int kvh = h / groups;
  const int q_last = min(q0 + kRows, S) - 1;
  const int kt_end = causal ? q_last / BK + 1 : (S + BK - 1) / BK;
  const int kt_begin = (window > 0 && q0 - window + 1 > 0) ? (q0 - window + 1) / BK : 0;
  const int n_tiles = kt_end - kt_begin;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kConsumers / 32);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(q_full, 2 * C::kRowTile);
      for (int hf = 0; hf < C::kHalves; ++hf) {
        tma_load_4d(q_s + hf * kRows * 128, &qmap, q_full, 64 * hf, h, q0, b);
        tma_load_4d(do_s + hf * kRows * 128, &domap, q_full, 64 * hf, h, q0, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        mbar_wait(&empty[st], ((i / kStages) & 1) ^ 1);
        const int k0 = (kt_begin + i) * BK;
        uint8_t* ks = k_s + st * C::kKTile;
        uint8_t* vs = v_s + st * C::kKTile;
        mbar_expect_tx(&full[st], 2 * C::kKTile);
        for (int hf = 0; hf < C::kHalves; ++hf) {
          tma_load_4d(ks + hf * BK * 128, &kmap, &full[st], 64 * hf, kvh, k0, b);
          tma_load_4d(vs + hf * BK * 128, &vmap, &full[st], 64 * hf, kvh, k0, b);
        }
      }
    }
  } else {
    dq_consume<HD>(q_s, do_s, k_s, v_s, q_full, full, empty, lse_pad, dsum_pad, dq, S,
                   S_pad, H, b, h, q0, kt_begin, n_tiles, scale, scale_log2, causal,
                   window);
  }
}

// ------------------------------------------------------------------ probe

// The dkdv kernel's products on one tile each, its layouts and descriptors
// as they are: a 128-key K block, a BQ-row Q and dO tile; warpgroup wg
// computes keys 64 wg .. + 63 of s^T = k q^T and dv = (p_hi + p_lo) do,
// so a card test can check them against torch.matmul.
template <int HD>
__global__ void __launch_bounds__(kConsumers)
bwd_probe_sm90(const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap qmap,
               const __grid_constant__ CUtensorMap domap, const float* __restrict__ p,
               float* __restrict__ st_out, float* __restrict__ dv_out) {
  using C = Cfg<HD>;
  constexpr int BQ = C::kBQ;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* k_s = smem;
  uint8_t* q_s = k_s + C::kKVBytes;
  uint8_t* do_s = q_s + C::kQTile;
  uint64_t* bar = reinterpret_cast<uint64_t*>(do_s + C::kQTile);
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    fence_mbar_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, C::kKVBytes + 2 * C::kQTile);
    for (int hf = 0; hf < C::kHalves; ++hf) {
      tma_load_4d(k_s + hf * kKeys * 128, &kmap, bar, 64 * hf, 0, 0, 0);
      tma_load_4d(q_s + hf * BQ * 128, &qmap, bar, 64 * hf, 0, 0, 0);
      tma_load_4d(do_s + hf * BQ * 128, &domap, bar, 64 * hf, 0, 0, 0);
    }
  }
  mbar_wait(bar, 0);
  __syncwarp();
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int row0 = 64 * wg + 16 * warp + lane / 4, col0 = 2 * (lane % 4);
  float s[BQ / 2];
  wgmma_fence();
  ss_steps<HD, BQ, kKeys>(s, smem_u32(k_s) + wg * 64 * 128, smem_u32(q_s));
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < BQ / 2; ++i) fence_reg(s[i]);
  float pf[BQ / 2];
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int idx = (row0 + 8 * (e >> 1)) * BQ + 8 * j + col0 + (e & 1);
      st_out[idx] = s[4 * j + e];
      pf[4 * j + e] = p[idx];
    }
  uint32_t ph[BQ / 16][4], pl[BQ / 16][4];
  split_p<BQ>(pf, ph, pl);
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  pv_tile<HD, BQ>(acc, ph, pl, smem_u32(do_s));
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dv_out[(row0 + 8 * (e >> 1)) * HD + 8 * j + col0 + (e & 1)] = acc[4 * j + e];
}

// ------------------------------------------------------------------- host

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  void *dq, *dk, *dv;
  float *lse_pad, *dsum_pad;
  Strides qs, ks, vs, os, dos;
  int B, S, H, KV, causal, window;
};

template <int HD>
int launch(const Args& a, cudaStream_t stream) {
  using C = Cfg<HD>;
  const int B = a.B, S = a.S, H = a.H, KV = a.KV;
  // dkdv reads Q and dO in BQ-row tiles and K, V in 128-key blocks; dq
  // reads Q and dO in 128-row tiles and K, V in 64-key tiles
  CUtensorMap qm1, km1, vm1, dom1, qm2, km2, vm2, dom2, dom3, om3;
  int rc = make_map(&qm1, a.q, HD, H, S, B, a.qs.h, a.qs.s, a.qs.b, C::kBQ);
  if (rc == 0) rc = make_map(&dom1, a.dout, HD, H, S, B, a.dos.h, a.dos.s, a.dos.b, C::kBQ);
  if (rc == 0) rc = make_map(&km1, a.k, HD, KV, S, B, a.ks.h, a.ks.s, a.ks.b, kKeys);
  if (rc == 0) rc = make_map(&vm1, a.v, HD, KV, S, B, a.vs.h, a.vs.s, a.vs.b, kKeys);
  if (rc == 0) rc = make_map(&qm2, a.q, HD, H, S, B, a.qs.h, a.qs.s, a.qs.b, kRows);
  if (rc == 0) rc = make_map(&dom2, a.dout, HD, H, S, B, a.dos.h, a.dos.s, a.dos.b, kRows);
  if (rc == 0) rc = make_map(&km2, a.k, HD, KV, S, B, a.ks.h, a.ks.s, a.ks.b, C::kBK);
  if (rc == 0) rc = make_map(&vm2, a.v, HD, KV, S, B, a.vs.h, a.vs.s, a.vs.b, C::kBK);
  // dsum reads dO and o in 64-row tiles
  if (rc == 0)
    rc = make_map(&dom3, a.dout, HD, H, S, B, a.dos.h, a.dos.s, a.dos.b, kDsumRows);
  if (rc == 0) rc = make_map(&om3, a.o, HD, H, S, B, a.os.h, a.os.s, a.os.b, kDsumRows);
  if (rc != 0) return rc;
  const long long dkdv_blocks = static_cast<long long>((S + kKeys - 1) / kKeys) * KV * B;
  const long long dq_blocks = static_cast<long long>((S + kRows - 1) / kRows) * H * B;
  // dsum's grid, 64-row tiles over S_pad, is twice dq's
  if (2 * dq_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // The attributes belong to the current device, so they are set at every
  // launch (host-side calls, cheap beside the kernels).
  const int dsum_smem = 2 * C::kHalves * kDsumRows * 128 + 1024 + 8;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dsum_sm90<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, dsum_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bwd_dkdv_sm90<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, C::kDkdvSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bwd_dq_sm90<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, C::kDqSmem);
  if (err != cudaSuccess) return (int)err;
  const int S_pad = (S + kPad - 1) / kPad * kPad;
  const float scale = 1.f / sqrtf((float)HD);
  const float scale_log2 = 1.4426950408889634f * scale;
  const long long dsum_blocks = static_cast<long long>(S_pad / kDsumRows) * H * B;
  bwd_dsum_sm90<HD><<<(unsigned)dsum_blocks, 128, dsum_smem, stream>>>(
      dom3, om3, a.lse, a.lse_pad, a.dsum_pad, S, S_pad, H, B);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  bwd_dkdv_sm90<HD><<<(unsigned)dkdv_blocks, kThreads, C::kDkdvSmem, stream>>>(
      qm1, km1, vm1, dom1, a.lse_pad, a.dsum_pad, static_cast<__nv_bfloat16*>(a.dk),
      static_cast<__nv_bfloat16*>(a.dv), S, S_pad, H, KV, B, scale, scale_log2, a.causal,
      a.window);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  bwd_dq_sm90<HD><<<(unsigned)dq_blocks, kThreads, C::kDqSmem, stream>>>(
      qm2, km2, vm2, dom2, a.lse_pad, a.dsum_pad, static_cast<__nv_bfloat16*>(a.dq), S,
      S_pad, H, B, H / KV, scale, scale_log2, a.causal, a.window);
  return (int)cudaGetLastError();
}

template <int HD>
int probe(const void* k, const void* q, const void* dout, const float* p, float* st_out,
          float* dv_out, cudaStream_t stream) {
  using C = Cfg<HD>;
  constexpr int BQ = C::kBQ;
  CUtensorMap km, qm, dom;
  int rc = make_map(&km, k, HD, 1, kKeys, 1, HD, HD, kKeys * HD, kKeys);
  if (rc == 0) rc = make_map(&qm, q, HD, 1, BQ, 1, HD, HD, BQ * HD, BQ);
  if (rc == 0) rc = make_map(&dom, dout, HD, 1, BQ, 1, HD, HD, BQ * HD, BQ);
  if (rc != 0) return rc;
  const int smem = C::kKVBytes + 2 * C::kQTile + 1024 + 8;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_probe_sm90<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  bwd_probe_sm90<HD><<<1, kConsumers, smem, stream>>>(km, qm, dom, p, st_out, dv_out);
  return (int)cudaGetLastError();
}

template <int HD>
int resources(int* out) {
  using C = Cfg<HD>;
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, bwd_dkdv_sm90<HD>);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = C::kDkdvSmem;
  err = cudaFuncGetAttributes(&a, bwd_dq_sm90<HD>);
  if (err != cudaSuccess) return (int)err;
  out[4] = a.numRegs;
  out[5] = (int)a.localSizeBytes;
  out[6] = (int)a.sharedSizeBytes;
  out[7] = C::kDqSmem;
  out[8] = C::kBQ;
  out[9] = C::kBK;
  return 0;
}

}  // namespace

// q, k, v, o, dout: bf16 with (batch, sequence, head) element strides in
// strides[0..14], three a tensor in that order (head_dim's 1, 16-byte
// aligned, as TMA reads them).  lse:
// the forward's contiguous float32 [B, H, S] (log2 units).  dq [B, S, H, hd]
// and dk, dv [B, S, KV, hd] contiguous, bf16; lse_pad and dsum_pad float32
// scratch of B * H * S_pad each, S_pad = S rounded up to a multiple of 128.
// window <= 0 means no window.  Returns cudaGetLastError() of the
// launches, or kTensorMapError + the CUresult of a tensor map the driver
// refused.
extern "C" int flash_attn_bwd_sm90(const void* q, const void* k, const void* v,
                                   const void* o, const void* dout, const float* lse,
                                   void* dq, void* dk, void* dv, float* lse_pad,
                                   float* dsum_pad, int B, int S, int H, int KV, int hd,
                                   const int64_t* st, int causal, int window,
                                   void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o; a.dout = dout; a.lse = lse;
  a.dq = dq; a.dk = dk; a.dv = dv; a.lse_pad = lse_pad; a.dsum_pad = dsum_pad;
  a.qs = Strides{st[0], st[1], st[2]};
  a.ks = Strides{st[3], st[4], st[5]};
  a.vs = Strides{st[6], st[7], st[8]};
  a.os = Strides{st[9], st[10], st[11]};
  a.dos = Strides{st[12], st[13], st[14]};
  a.B = B; a.S = S; a.H = H; a.KV = KV; a.causal = causal; a.window = window;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (hd) {
    case 16: return launch<16>(a, s);
    case 32: return launch<32>(a, s);
    case 64: return launch<64>(a, s);
    case 96: return launch<96>(a, s);
    case 128: return launch<128>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// k [128, hd], q and dout [BQ, hd] contiguous bf16 (BQ = out[8] of the
// resources), p [128, BQ] f32 → st_out [128, BQ] = k q^T and dv_out
// [128, hd] = (bf16(p) + bf16(p - bf16(p))) dout, f32, through the dkdv
// kernel's products.
extern "C" int flash_attn_bwd_sm90_probe(const void* k, const void* q, const void* dout,
                                         const float* p, float* st_out, float* dv_out,
                                         int hd, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (hd) {
    case 16: return probe<16>(k, q, dout, p, st_out, dv_out, s);
    case 32: return probe<32>(k, q, dout, p, st_out, dv_out, s);
    case 64: return probe<64>(k, q, dout, p, st_out, dv_out, s);
    case 96: return probe<96>(k, q, dout, p, st_out, dv_out, s);
    case 128: return probe<128>(k, q, dout, p, st_out, dv_out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The compiled resources of the instances for hd: out[0..3] the dkdv
// kernel's registers a thread, local (spill) bytes a thread, static shared
// bytes and the dynamic shared bytes its launch sets, out[4..7] the same
// of the dq kernel, out[8] query rows of a dkdv ring tile, out[9] keys of
// a dq ring tile.  Returns a cudaError.
extern "C" int flash_attn_bwd_sm90_resources(int hd, int* out) {
  switch (hd) {
    case 16: return resources<16>(out);
    case 32: return resources<32>(out);
    case 64: return resources<64>(out);
    case 96: return resources<96>(out);
    case 128: return resources<128>(out);
    default: return (int)cudaErrorInvalidValue;
  }
}
