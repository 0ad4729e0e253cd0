// Flash-attention forward on Hopper's tensor cores, bf16: causal /
// sliding-window / bidirectional softmax attention with grouped KV heads.
//
//   o[b, s, h, :] = sum_t softmax_t(q[b, s, h, :] . k[b, t, h / G, :] / sqrt(hd))
//                   * v[b, t, h / G, :]
//
// over the keys t that pass the mask: t < S, and t <= s when causal, and
// s - t < window when a window is given.  q is [B, S, H, hd] and k, v are
// [B, S, KV, hd], bf16, read in place by TMA through their strides (the
// last one 1); o is a new contiguous [B, S, H, hd] bf16.  The float32
// instance of the same function stays on the CUDA cores (flash_attn.cu).
//
// Replaces the TPU kernel flash_attention_pallas in
// src/repro/kernels/flashattn/flashattn.py for bf16 inputs.  Bound on the
// card: operations.  At the LM prefill's shape (S = 32,768, 9 heads over 3
// KV heads, hd = 64, causal) the work is 4 hd S(S+1)/2 H = 1.24e12
// operations against 0.1 GB of q, k, v and o: 1.25 ms at the bf16
// tensor-core rate, 0.03 ms for the bytes.
//
// Design.  One block (CTA) owns one (batch, head, 128-row query tile):
// warps 0-7 are two consumer warpgroups of 64 query rows each, warps 8-11
// the producer warpgroup, which gives most of its registers to the
// consumers (setmaxnreg) and loads through one lane.  Query tiles are
// issued heaviest first (the grid is 1-d, query tile rank outermost), so
// the causal grid's tail is short tiles.  A warpgroup runs Q K^T, the
// softmax and P V of a tile in turn; the two warpgroups of a block, on the
// same SM sub-partitions, overlap each other's products and softmax.  (Two
// schedules measured slower on an H100: issuing tile i + 1's Q K^T beside
// tile i's P V within each warpgroup, which needs S of one tile and P of
// the other at once, so it spilled or, with 64-key tiles, paid per tile;
// and making the two warpgroups take turns at issuing their wgmma.)
//  * Loads.  One producer lane issues TMA loads (cp.async.bulk.tensor) from
//    tensor maps the host encodes per call from the tensors' own strides:
//    the Q tile once, then BK-key K and V tiles into a ring of kStages
//    stages in shared memory, with full / empty mbarriers per stage (K and
//    V have full barriers of their own, so QK^T starts before V lands).
//    TMA's out-of-bounds fill zeroes rows past S and columns past hd.
//    Tiles are 128-byte swizzled rows of 64 bf16; hd = 96 and 128 are two
//    64-column halves, and hd = 16 and 32 one half, zero past hd.
//  * S = Q K^T.  wgmma m64 n BK k16, f32 accumulators in registers, Q and K
//    from shared memory (K stored [keys, hd] is K-major for B).
//  * Online softmax in registers.  A row's max is taken across the 4 lanes
//    that hold it (two shuffles); its sum stays a per-lane partial until
//    the epilogue.  p = ex2.approx.ftz(s / sqrt(hd) log2(e) - m), one FFMA
//    and one MUFU op (p under 2^-126 is flushed to 0: exp2f's handling of
//    subnormal results is a visible share of the kernel's time on an H100,
//    where the softmax, not the tensor cores, sets the pace).  Masks apply
//    only on tiles that cut the causal / window band or S (finite -1e30
//    scores, p set to 0); tiles wholly outside the band are not loaded.
//  * O += P V with p kept to ~16 bits.  The f32 accumulator fragment of S
//    is already the bf16 A fragment of P in the same lanes, so P never
//    leaves registers: p_hi = bf16(p), p_lo = bf16(p - p_hi), two wgmma
//    (A from registers, V from shared memory as an MN-major B) into the
//    same f32 accumulator.  Rounding p to bf16 alone would move outputs by
//    ~1.5% of their row's RMS; the two terms keep the output within half a
//    bf16 ulp of the f32 plain version.  The row sum l is taken from the
//    f32 p.  This costs 1.5x the tensor-core work of a one-term P.
//  * Epilogue: o / l, rounded to bf16 once, stored straight from registers,
//    and, where the caller asks for it (training), each row's log-sum-exp
//    m + log2(l) in f32, which the backward (flash_attn_bwd_sm90.cu) reads
//    instead of recomputing S.

#include "flash_sm90.cuh"

namespace {

constexpr int kBQ = 128;                   // query rows of a block
constexpr int kConsumers = 256;            // two warpgroups of 64 rows
constexpr int kThreads = kConsumers + 128; // and a producer warpgroup
// Registers a thread: an SM sub-partition holds one warp of each of the
// three warpgroups in its 512 a lane, so 168 each unless the producer,
// which needs few, gives its share to the consumers (224 + 224 + 56)
constexpr int kConsumerRegs = 224;
constexpr int kProducerRegs = 56;
constexpr int kStages = 3;                 // K / V ring depth

template <int HD>
struct Cfg {
  static constexpr int kHalves = (HD + 63) / 64;   // 64-column halves of a row
  static constexpr int kBK = HD <= 64 ? 128 : 64;  // keys of a tile
  static constexpr int kQBytes = kHalves * kBQ * 128;
  static constexpr int kTileBytes = kHalves * kBK * 128;  // one K or V stage
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kTileBytes;
  // + 1024 to align the tiles to a swizzle atom, + the mbarriers
  static constexpr int kSmem = kBarOffset + 1024 + 8 * (1 + 3 * kStages);
};

// p = 2^(s scale_log2 - m) of a tile, in place, added to this lane's row
// sums; on an edge tile (kEdge) masked scores give p = 0.  A template on
// kEdge, so the other tiles pay no compare.
template <int BK, bool kEdge>
__device__ __forceinline__ void exp_tile(float (&s)[BK / 2], const float (&m)[2],
                                         float (&l)[2], float scale_log2) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = exp2_ftz(fmaf(s[4 * j + e], scale_log2, -m[e >> 1]));
      if (kEdge && s[4 * j + e] == kNeg) p = 0.f;
      s[4 * j + e] = p;
      l[e >> 1] += p;
    }
}

// The consumer warpgroups' side of flash_fwd_sm90: warpgroup wg owns query
// rows q0 + 64 wg .. + 63.
template <int HD>
__device__ __forceinline__ void consume(uint8_t* q_s, uint8_t* k_s, uint8_t* v_s,
                                        uint64_t* q_full, uint64_t* k_full,
                                        uint64_t* v_full, uint64_t* empty,
                                        __nv_bfloat16* __restrict__ o,
                                        float* __restrict__ lse, int S, int H,
                                        int b, int h, int q0, int kt_begin, int n_tiles,
                                        float scale_log2, int causal, int window) {
  using C = Cfg<HD>;
  constexpr int BK = C::kBK;
  setmaxnreg_inc<kConsumerRegs>();
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = q0 + 64 * wg + 16 * warp + g;  // this lane's rows: row0, row0 + 8
  const int wq_lo = q0 + 64 * wg, wq_hi = wq_lo + 63;
  const uint32_t q_addr = smem_u32(q_s) + wg * 64 * 128;

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};  // l: this lane's partial sums

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
    uint32_t ph[BK / 16][4], pl[BK / 16][4];

    mbar_wait(&k_full[st], phase);
    __syncwarp();
    if (!dead) {
      float s[BK / 2];
      qk_tile<HD, BK, kBQ>(s, q_addr, smem_u32(k_s + st * C::kTileBytes));
      if (edge) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = k0 + 8 * j + 2 * t + (e & 1);
            const int qpos = row0 + 8 * (e >> 1);
            const bool ok = kpos < S && (!causal || kpos <= qpos) &&
                            (window <= 0 || qpos - kpos < window);
            if (!ok) s[4 * j + e] = kNeg;
          }
      }
      float mx[2] = {kNeg, kNeg};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * scale_log2);
        corr[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
        l[r] *= corr[r];
      }
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[4 * j + e] *= corr[e >> 1];
      if (edge)
        exp_tile<BK, true>(s, m, l, scale_log2);
      else
        exp_tile<BK, false>(s, m, l, scale_log2);
      split_p<BK>(s, ph, pl);
    }
    mbar_wait(&v_full[st], phase);
    __syncwarp();
    if (!dead)
      pv_tile<HD, BK>(acc, ph, pl, smem_u32(v_s + st * C::kTileBytes));
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);       // this warp is done with the stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int s = row0 + 8 * r;
    if (s >= S) continue;
    if (lse != nullptr && t == 0)
      lse[(static_cast<int64_t>(b) * H + h) * S + s] = m[r] + log2f(l[r]);
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    __nv_bfloat16* out = o + ((static_cast<int64_t>(b) * S + s) * H + h) * HD + 2 * t;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap qmap,
               const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap,
               __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int S, int H,
               int B, int groups, float scale_log2, int causal, int window) {
  using C = Cfg<HD>;
  constexpr int BK = C::kBK;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* q_s = smem;
  uint8_t* k_s = q_s + C::kQBytes;                // stage st at + st * kTileBytes
  uint8_t* v_s = k_s + kStages * C::kTileBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::kBarOffset);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;

  const int n_qt = (S + kBQ - 1) / kBQ;
  const int rank = blockIdx.x / (H * B);          // 0 = the heaviest query tile
  const int hb = blockIdx.x - rank * (H * B);
  const int h = hb % H, b = hb / H;
  const int q0 = (n_qt - 1 - rank) * kBQ;
  const int kvh = h / groups;
  const int q_last = min(q0 + kBQ, S) - 1;
  const int kt_end = causal ? q_last / BK + 1 : (S + BK - 1) / BK;
  const int kt_begin = (window > 0 && q0 - window + 1 > 0) ? (q0 - window + 1) / BK : 0;
  const int n_tiles = kt_end - kt_begin;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&k_full[st], 1);
      mbar_init(&v_full[st], 1);
      mbar_init(&empty[st], kConsumers / 32);    // one arrival per consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer: one lane keeps the ring full
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(q_full, C::kQBytes);
      for (int hf = 0; hf < C::kHalves; ++hf)
        tma_load_4d(q_s + hf * kBQ * 128, &qmap, q_full, 64 * hf, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        mbar_wait(&empty[st], ((i / kStages) & 1) ^ 1);
        const int k0 = (kt_begin + i) * BK;
        uint8_t* ks = k_s + st * C::kTileBytes;
        uint8_t* vs = v_s + st * C::kTileBytes;
        mbar_expect_tx(&k_full[st], C::kTileBytes);
        for (int hf = 0; hf < C::kHalves; ++hf)
          tma_load_4d(ks + hf * BK * 128, &kmap, &k_full[st], 64 * hf, kvh, k0, b);
        mbar_expect_tx(&v_full[st], C::kTileBytes);
        for (int hf = 0; hf < C::kHalves; ++hf)
          tma_load_4d(vs + hf * BK * 128, &vmap, &v_full[st], 64 * hf, kvh, k0, b);
      }
    }
  } else {
    consume<HD>(q_s, k_s, v_s, q_full, k_full, v_full, empty, o, lse, S, H, b, h, q0,
                kt_begin, n_tiles, scale_log2, causal, window);
  }
}

// One warpgroup, one tile of each operand, the kernel's own layouts,
// descriptors and products: s = q k^T and o = (p_hi + p_lo) v, so a card
// test can check them against torch.matmul.
template <int HD>
__global__ void __launch_bounds__(128)
flash_probe_sm90(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, const float* __restrict__ p,
                 float* __restrict__ s_out, float* __restrict__ o_out) {
  using C = Cfg<HD>;
  constexpr int BK = C::kBK;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* q_s = smem;
  uint8_t* k_s = q_s + C::kHalves * 64 * 128;
  uint8_t* v_s = k_s + C::kTileBytes;
  uint64_t* bar = reinterpret_cast<uint64_t*>(v_s + C::kTileBytes);
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    fence_mbar_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, C::kHalves * 64 * 128 + 2 * C::kTileBytes);
    for (int hf = 0; hf < C::kHalves; ++hf) {
      tma_load_4d(q_s + hf * 64 * 128, &qmap, bar, 64 * hf, 0, 0, 0);
      tma_load_4d(k_s + hf * BK * 128, &kmap, bar, 64 * hf, 0, 0, 0);
      tma_load_4d(v_s + hf * BK * 128, &vmap, bar, 64 * hf, 0, 0, 0);
    }
  }
  mbar_wait(bar, 0);
  __syncwarp();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = 16 * warp + lane / 4, col0 = 2 * (lane % 4);
  float s[BK / 2];
  qk_tile<HD, BK, 64>(s, smem_u32(q_s), smem_u32(k_s));
  float pf[BK / 2];
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int idx = (row0 + 8 * (e >> 1)) * BK + 8 * j + col0 + (e & 1);
      s_out[idx] = s[4 * j + e];
      pf[4 * j + e] = p[idx];
    }
  uint32_t ph[BK / 16][4], pl[BK / 16][4];
  split_p<BK>(pf, ph, pl);
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  pv_tile<HD, BK>(acc, ph, pl, smem_u32(v_s));
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o_out[(row0 + 8 * (e >> 1)) * HD + 8 * j + col0 + (e & 1)] = acc[4 * j + e];
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, Strides qs,
           Strides ks, Strides vs, int B, int S, int H, int KV, int causal, int window,
           cudaStream_t stream) {
  using C = Cfg<HD>;
  CUtensorMap qm, km, vm;
  int rc = make_map(&qm, q, HD, H, S, B, qs.h, qs.s, qs.b, kBQ);
  if (rc == 0) rc = make_map(&km, k, HD, KV, S, B, ks.h, ks.s, ks.b, C::kBK);
  if (rc == 0) rc = make_map(&vm, v, HD, KV, S, B, vs.h, vs.s, vs.b, C::kBK);
  if (rc != 0) return rc;
  const long long blocks = static_cast<long long>((S + kBQ - 1) / kBQ) * H * B;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // The attribute belongs to the current device, so it is set at every
  // launch (a host-side call, cheap beside the kernel), not once a process.
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_sm90<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return (int)err;
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)HD);
  flash_fwd_sm90<HD><<<(unsigned)blocks, kThreads, C::kSmem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), lse, S, H, B, H / KV, scale_log2,
      causal, window);
  return (int)cudaGetLastError();
}

template <int HD>
int probe(const void* q, const void* k, const void* v, const float* p, float* s_out,
          float* o_out, cudaStream_t stream) {
  using C = Cfg<HD>;
  CUtensorMap qm, km, vm;
  int rc = make_map(&qm, q, HD, 1, 64, 1, HD, HD, 64 * HD, 64);
  if (rc == 0) rc = make_map(&km, k, HD, 1, C::kBK, 1, HD, HD, C::kBK * HD, C::kBK);
  if (rc == 0) rc = make_map(&vm, v, HD, 1, C::kBK, 1, HD, HD, C::kBK * HD, C::kBK);
  if (rc != 0) return rc;
  const int smem = C::kHalves * 64 * 128 + 2 * C::kTileBytes + 1024 + 8;
  cudaError_t err = cudaFuncSetAttribute(
      flash_probe_sm90<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  flash_probe_sm90<HD><<<1, 128, smem, stream>>>(qm, km, vm, p, s_out, o_out);
  return (int)cudaGetLastError();
}

template <int HD>
int resources(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, flash_fwd_sm90<HD>);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = Cfg<HD>::kSmem;
  out[4] = a.maxThreadsPerBlock;
  out[5] = Cfg<HD>::kBK;
  return 0;
}

}  // namespace

// Strides are in elements, in the order (batch, sequence, head); head_dim's
// is 1.  window <= 0 means no window.  o must be contiguous [B, S, H, hd].
// lse, when not null, is a contiguous float32 [B, H, S] that gets each
// row's log-sum-exp of its scaled scores in log2 units, m + log2(l) from
// the f32 running max and row sum (what the backward reads); null writes
// nothing and costs nothing.
// Returns cudaGetLastError() of the launch, or kTensorMapError + the
// CUresult of a tensor map the driver refused.
extern "C" int flash_attn_sm90_fwd(const void* q, const void* k, const void* v, void* o,
                                   float* lse, int B, int S, int H, int KV, int hd, int64_t qsb,
                                   int64_t qss, int64_t qsh, int64_t ksb, int64_t kss,
                                   int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh,
                                   int causal, int window, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  const cudaStream_t st = (cudaStream_t)stream;
#define FLASH_SM90_LAUNCH(HD) \
  launch<HD>(q, k, v, o, lse, qs, ks, vs, B, S, H, KV, causal, window, st)
  switch (hd) {
    case 16: return FLASH_SM90_LAUNCH(16);
    case 32: return FLASH_SM90_LAUNCH(32);
    case 64: return FLASH_SM90_LAUNCH(64);
    case 96: return FLASH_SM90_LAUNCH(96);
    case 128: return FLASH_SM90_LAUNCH(128);
    default: return (int)cudaErrorInvalidValue;
  }
}

// q [64, hd], k and v [BK, hd] contiguous bf16, p [64, BK] f32 → s_out
// [64, BK] = q k^T and o_out [64, hd] = (bf16(p) + bf16(p - bf16(p))) v, f32,
// through one warpgroup's wgmma, as the kernel computes them.
extern "C" int flash_attn_sm90_probe(const void* q, const void* k, const void* v,
                                     const float* p, float* s_out, float* o_out, int hd,
                                     void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
#define FLASH_SM90_PROBE(HD) probe<HD>(q, k, v, p, s_out, o_out, st)
  switch (hd) {
    case 16: return FLASH_SM90_PROBE(16);
    case 32: return FLASH_SM90_PROBE(32);
    case 64: return FLASH_SM90_PROBE(64);
    case 96: return FLASH_SM90_PROBE(96);
    case 128: return FLASH_SM90_PROBE(128);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The compiled resources of the instance for hd: out[0] registers a thread,
// out[1] local (spill) bytes a thread, out[2] static shared bytes, out[3]
// the dynamic shared bytes its launch sets, out[4] the most threads a block,
// out[5] keys a K / V tile.  Returns a cudaError.
extern "C" int flash_attn_sm90_resources(int hd, int* out) {
  switch (hd) {
    case 16: return resources<16>(out);
    case 32: return resources<32>(out);
    case 64: return resources<64>(out);
    case 96: return resources<96>(out);
    case 128: return resources<128>(out);
    default: return (int)cudaErrorInvalidValue;
  }
}
