// Flash-attention forward, float32, on the CUDA cores: causal / sliding-
// window / bidirectional softmax attention with grouped KV heads, online
// softmax, f32 running state.  bf16 inputs go to the tensor-core kernel in
// flash_attn_sm90.cu.
//
//   o[b, s, h, :] = sum_t softmax_t(q[b, s, h, :] . k[b, t, h / G, :] / sqrt(hd))
//                   * v[b, t, h / G, :]
//
// over the keys t that pass the mask: t < S, and t <= s when causal, and
// s - t < window when a window is given.  q is [B, S, H, hd] and k, v are
// [B, S, KV, hd] with G = H / KV, read in place through their element
// strides (no [B*H, S, hd] transpose, no GQA repeat, no padding to the
// tile); o is a new contiguous [B, S, H, hd] float32.  Scores, the running
// max and denominator, p and the output sum are float32, as in the TPU
// kernel.
//
// Replaces the TPU kernel flash_attention_pallas in
// src/repro/kernels/flashattn/flashattn.py for float32 inputs.  There the
// grid's kv axis ran in order on one core and carried acc / m / l in VMEM
// scratch from step to step.  Here one block owns one (b, h, 64-row query
// tile) and loops over the 64-key tiles itself, so nothing is carried
// between blocks; key tiles
// wholly outside the causal / window band are never visited (the TPU
// kernel's pl.when(run)).  Query tiles are issued heaviest first (the last
// tile of a causal row sees the most keys), so the tail of the grid is
// short tiles.
//
// Layout of a block: 256 threads as a 16 x 16 grid.  Thread (rg, cg) owns
// score rows 4rg..4rg+3 and columns cg, cg+16, cg+32, cg+48 of each 64 x 64
// tile, and output rows 4rg..4rg+3, columns cg + 16c (c < hd/16).  The Q
// tile and each K / V tile are staged in shared memory as float32; K and Q
// rows are padded by 4 floats so the 16 lanes of a row group read 16
// different K rows as float4 without bank conflicts.  Row max and row sum
// are shuffles across the 16 lanes of a row group.  The probabilities go
// through shared memory once, for the PV product.
//
// Bound on the card: operations.  At the LM prefill's shape (S = 32,768,
// 9 heads, hd = 64, causal) the work is 4 hd S(S+1)/2 H = 1.24e12 operations
// against 0.2 GB of q, k, v and o in float32: 18.5 ms at the float32 rate
// of the CUDA cores (67 TFLOP/s), which is where this kernel does its
// products.  No main path runs it: the LM runs in bf16.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;            // query rows of a block
constexpr int kBK = 64;            // keys of a tile
constexpr int kThreads = 256;
constexpr float kNeg = -1e30f;     // masked score (finite, as the TPU kernel's)

struct Strides {
  int64_t b, s, h, d;
};

template <int HD>
constexpr int smem_floats() {
  return kBQ * (HD + 4) + kBK * (HD + 4) + kBK * HD + kBQ * (kBK + 4);
}

// Rows [row0, row0 + rows) of one head of x into a float32 tile with row
// stride ld; rows at or past S are zero (so masked keys multiply zeros).
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* x, Strides st,
                                          int b, int head, int row0, int rows, int S) {
  const float* base = x + b * st.b + head * st.h;
  for (int i = threadIdx.x; i < rows * HD; i += kThreads) {
    const int r = i / HD, c = i % HD;
    const int s = row0 + r;
    dst[r * ld + c] = s < S ? base[s * st.s + c * st.d] : 0.f;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 Strides qs, Strides ks, Strides vs, int S, int H, int groups,
                 float scale_log2, int causal, int window) {
  constexpr int LD = HD + 4;       // padded row of Q and K tiles
  constexpr int PLD = kBK + 4;     // padded row of the P tile
  constexpr int NC = HD / 16;      // output columns a thread owns
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * LD;
  float* Vs = Ks + kBK * LD;
  float* Ps = Vs + kBK * HD;

  const int n_qt = (S + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / groups;
  const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15;

  load_tile<HD>(Qs, LD, q, qs, b, h, q0, kBQ, S);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int q_last = min(q0 + kBQ, S) - 1;
  const int kt_end = causal ? q_last / kBK + 1 : (S + kBK - 1) / kBK;
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / kBK;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();               // the previous tile's readers are done
    load_tile<HD>(Ks, LD, k, ks, b, kvh, k0, kBK, S);
    load_tile<HD>(Vs, HD, v, vs, b, kvh, k0, kBK, S);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (4 * rg + i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (cg + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[i][j] += qv[i].x * kv[j].x + qv[i].y * kv[j].y + qv[i].z * kv[j].z +
                     qv[i].w * kv[j].w;
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * rg + i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + cg + 16 * j;
        const bool ok = kpos < S && (!causal || qpos >= kpos) &&
                        (window <= 0 || qpos - kpos < window);
        s[i][j] = ok ? s[i][j] * scale_log2 : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = exp2f(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] == kNeg ? 0.f : exp2f(s[i][j] - m_new);
        sum += p;
        Ps[(4 * rg + i) * PLD + cg + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 2
    for (int t0 = 0; t0 < kBK; t0 += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (4 * rg + i) * PLD + t0);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float v0 = Vs[(t0 + 0) * HD + cg + 16 * c];
        const float v1 = Vs[(t0 + 1) * HD + cg + 16 * c];
        const float v2 = Vs[(t0 + 2) * HD + cg + 16 * c];
        const float v3 = Vs[(t0 + 3) * HD + cg + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[i][c] += pv[i].x * v0 + pv[i].y * v1 + pv[i].z * v2 + pv[i].w * v3;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + 4 * rg + i;
    if (s >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    float* row = o + (((int64_t)b * S + s) * H + h) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c) row[cg + 16 * c] = acc[i][c] * inv;
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, Strides qs,
           Strides ks, Strides vs, int B, int S, int H, int KV, int causal,
           int window, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * smem_floats<HD>();
  // The attribute belongs to the current device, so it is set at every
  // launch (a host-side call, cheap beside the kernel), not once a process.
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)HD);
  dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), qs, ks, vs, S, H, H / KV,
      scale_log2, causal, window);
  return (int)cudaGetLastError();
}

int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o,
                Strides qs, Strides ks, Strides vs, int B, int S, int H, int KV,
                int causal, int window, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<16>(q, k, v, o, qs, ks, vs, B, S, H, KV, causal, window, stream);
    case 32: return launch<32>(q, k, v, o, qs, ks, vs, B, S, H, KV, causal, window, stream);
    case 64: return launch<64>(q, k, v, o, qs, ks, vs, B, S, H, KV, causal, window, stream);
    case 96: return launch<96>(q, k, v, o, qs, ks, vs, B, S, H, KV, causal, window, stream);
    case 128: return launch<128>(q, k, v, o, qs, ks, vs, B, S, H, KV, causal, window, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// float32 q, k, v, o.  Strides are in elements, in the order (batch,
// sequence, head, head_dim).  window <= 0 means no window.  o must be
// contiguous [B, S, H, hd].  Returns cudaGetLastError() of the launch.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                              int B, int S, int H, int KV, int hd,
                              int64_t qsb, int64_t qss, int64_t qsh, int64_t qsd,
                              int64_t ksb, int64_t kss, int64_t ksh, int64_t ksd,
                              int64_t vsb, int64_t vss, int64_t vsh, int64_t vsd,
                              int causal, int window, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  const Strides qs{qsb, qss, qsh, qsd}, ks{ksb, kss, ksh, ksd}, vs{vsb, vss, vsh, vsd};
  return dispatch_hd(hd, q, k, v, o, qs, ks, vs, B, S, H, KV, causal, window,
                     (cudaStream_t)stream);
}
