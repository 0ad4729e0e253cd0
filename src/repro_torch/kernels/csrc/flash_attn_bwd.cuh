// Flash-attention backward: dQ, dK and dV of causal / sliding-window /
// bidirectional softmax attention with grouped KV heads, for float32
// inputs, all arithmetic in float32 on the CUDA cores.  The bf16 backward
// runs on the tensor cores from the forward's log-sum-exp
// (flash_attn_bwd_sm90.cu).
//
//   s[b, h, i, t] = q[b, i, h, :] . k[b, t, h / G, :] / sqrt(hd)   (masked)
//   P = softmax_t(s),  o = P v,  dO = dL/do
//   dV[t] = sum_{h in group, i} P[i, t] dO[i]
//   dS    = P * (dO v^T - D),  D[i] = rowsum(dO[i] * o[i])
//   dQ[i] = sum_t dS[i, t] k[t] / sqrt(hd)
//   dK[t] = sum_{h in group, i} dS[i, t] q[i] / sqrt(hd)
//
// over the keys t that pass the forward's mask: t < S, and t <= i when
// causal, and i - t < window when a window is given.  q, o and dO are
// [B, S, H, hd] and k, v [B, S, KV, hd] with G = H / KV, read in place
// through their element strides; dQ, dK and dV are new contiguous tensors of
// the inputs' dtype.
//
// Replaces no TPU kernel: flash_attention_pallas (src/repro/kernels/
// flashattn/flashattn.py) has no backward, and the JAX package trains
// through jax.grad of the jnp blockwise attention (src/repro/models/
// common.py: flash_attention).  This is the port's counterpart of that
// autodiff for float32, behind a torch.autograd.Function whose forward is
// the flash kernel flash_attn.cu.
//
// Bound on the card: operations.  The five products of the backward (S
// again, dP, dV, dQ, dK) are 2.5x the forward's 4 hd S(S+1)/2 H B
// operations (at causal masking).  This design runs them on the CUDA cores
// in float32 and recomputes S three times and dP twice (8 products).
//
// The kernels live in this header (templates on the element type);
// flash_attn_bwd_f32.cu instantiates them for float32.
//
// Design, three kernels on one stream, no atomics (a step is the same bits
// on every run):
//  1. prep: one block per (b, h, 64-row query tile) recomputes the row's
//     log-sum-exp (log2 units) from q and k with the forward's online
//     max / sum, and D = rowsum(dO * o), into float32 scratch [B, H, S].
//  2. dq: one block per (b, h, query tile) keeps its Q and dO tiles in
//     shared memory and loops over the key tiles in the band: S and dP of
//     the tile, P = exp2(S log2(e) / sqrt(hd) - lse), dS through shared
//     memory, dQ += dS K in registers.
//  3. dkdv: one block per (b, KV head, 64-key tile) keeps its K and V tiles
//     and loops over every query head of its group and the query tiles in
//     the band: S^T and dP^T, P^T and dS^T through shared memory, dV +=
//     P^T dO and dK += dS^T Q in registers.  The group's heads are summed
//     in the block, so nothing crosses blocks.
// Tiles are 64 x 64 and 256 threads a block as a 16 x 16 grid, as in
// flash_attn.cu: thread (rg, cg) owns rows 4rg..4rg+3 and columns cg + 16j
// of a score tile and columns cg + 16c of an output row.  Rows of the
// staged tiles are padded by 4 floats so that the 16 lanes of a row group
// read 16 different rows as float4 without bank conflicts.  Query tiles are
// issued heaviest first (prep, dq: the last tile of a causal row sees the
// most keys; dkdv: the first key tile sees the most queries).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;            // query rows of a tile
constexpr int kBK = 64;            // keys of a tile
constexpr int kThreads = 256;
constexpr int PLD = kBK + 4;       // padded row of a P / dS tile
constexpr float kNeg = -1e30f;     // masked score (finite, as the forward's)

struct Strides {
  int64_t b, s, h, d;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

__device__ __forceinline__ bool visible(int i, int t, int S, int causal, int window) {
  return i < S && t < S && (!causal || i >= t) && (window <= 0 || i - t < window);
}

// Rows [row0, row0 + 64) of one head of x into a float32 tile with row
// stride LD; rows at or past S are zero.
template <int HD, int LD, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* x, Strides st, int b,
                                          int head, int row0, int S) {
  const T* base = x + b * st.b + head * st.h;
  for (int i = threadIdx.x; i < 64 * HD; i += kThreads) {
    const int r = i / HD, c = i % HD;
    const int s = row0 + r;
    dst[r * LD + c] = s < S ? to_f32(base[s * st.s + c * st.d]) : 0.f;
  }
}

// acc[i][j] = sum_d A[4rg + i][d] * B[cg + 16j][d] over two staged tiles.
template <int HD, int LD>
__device__ __forceinline__ void tile_dots(float (&acc)[4][4], const float* A,
                                          const float* B, int rg, int cg) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 a[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (4 * rg + i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = *reinterpret_cast<const float4*>(B + (cg + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] += a[i].x * bv[j].x + a[i].y * bv[j].y + a[i].z * bv[j].z +
                     a[i].w * bv[j].w;
  }
}

// out[i][c] += sum_t P[4rg + i][t] * X[t][cg + 16c]: a 64 x 64 tile P (row
// stride PLD) times a staged 64 x HD tile X (row stride LD).
template <int HD, int LD>
__device__ __forceinline__ void tile_mm(float (&out)[4][HD / 16], const float* P,
                                        const float* X, int rg, int cg) {
  constexpr int NC = HD / 16;
#pragma unroll 2
  for (int t0 = 0; t0 < kBK; t0 += 4) {
    float4 pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pv[i] = *reinterpret_cast<const float4*>(P + (4 * rg + i) * PLD + t0);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float x0 = X[(t0 + 0) * LD + cg + 16 * c];
      const float x1 = X[(t0 + 1) * LD + cg + 16 * c];
      const float x2 = X[(t0 + 2) * LD + cg + 16 * c];
      const float x3 = X[(t0 + 3) * LD + cg + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        out[i][c] += pv[i].x * x0 + pv[i].y * x1 + pv[i].z * x2 + pv[i].w * x3;
    }
  }
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// The key tiles [begin, end) that the query tile at q0 sees.
__device__ __forceinline__ void key_band(int q0, int S, int causal, int window, int& begin,
                                         int& end) {
  const int q_last = min(q0 + kBQ, S) - 1;
  end = causal ? q_last / kBK + 1 : (S + kBK - 1) / kBK;
  begin = 0;
  if (window > 0 && q0 - window + 1 > 0) begin = (q0 - window + 1) / kBK;
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv;
  float *lse, *dsum;          // [B, H, S] scratch
  Strides qs, ks, vs, os, dos;
  int B, S, H, KV, groups, causal, window;
  float scale, scale_log2;
};

template <int HD>
__host__ __device__ constexpr int ld() { return HD + 4; }

template <int HD>
constexpr size_t prep_smem() { return sizeof(float) * 2 * kBQ * ld<HD>(); }
template <int HD>
constexpr size_t dq_smem() { return sizeof(float) * (4 * kBQ * ld<HD>() + kBQ * PLD); }
template <int HD>
constexpr size_t dkdv_smem() {
  return sizeof(float) * (4 * kBQ * ld<HD>() + 2 * kBK * PLD + 2 * kBQ);
}

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads) bwd_prep_kernel(Args a) {
  constexpr int LD = ld<HD>();
  constexpr int NC = HD / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * LD;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* o = static_cast<const T*>(a.o);
  const T* dout = static_cast<const T*>(a.dout);
  const int S = a.S;
  const int n_qt = (S + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / a.groups;
  const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15;

  load_tile<HD, LD>(Qs, q, a.qs, b, h, q0, S);
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
  }
  int kt_begin, kt_end;
  key_band(q0, S, a.causal, a.window, kt_begin, kt_end);
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();
    load_tile<HD, LD>(Ks, k, a.ks, b, kvh, k0, S);
    __syncthreads();
    float s[4][4];
    tile_dots<HD, LD>(s, Qs, Ks, rg, cg);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * rg + i;
      bool ok[4];
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ok[j] = visible(qpos, k0 + cg + 16 * j, S, a.causal, a.window);
        s[i][j] = ok[j] ? s[i][j] * a.scale_log2 : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += ok[j] ? exp2f(s[i][j] - m_new) : 0.f;
      l[i] = l[i] * exp2f(m[i] - m_new) + row_sum16(sum);
      m[i] = m_new;
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * rg + i;
    float d = 0.f;
    if (row < S) {
      const T* orow = o + b * a.os.b + row * a.os.s + h * a.os.h;
      const T* drow = dout + b * a.dos.b + row * a.dos.s + h * a.dos.h;
#pragma unroll
      for (int c = 0; c < NC; ++c)
        d += to_f32(orow[(cg + 16 * c) * a.os.d]) * to_f32(drow[(cg + 16 * c) * a.dos.d]);
    }
    d = row_sum16(d);
    if (cg == 0 && row < S) {
      const int64_t at = ((int64_t)b * a.H + h) * S + row;
      a.lse[at] = m[i] + log2f(l[i]);
      a.dsum[at] = d;
    }
  }
}

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads) bwd_dq_kernel(Args a) {
  constexpr int LD = ld<HD>();
  constexpr int NC = HD / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + kBQ * LD;
  float* Ks = dOs + kBQ * LD;
  float* Vs = Ks + kBK * LD;
  float* Ds = Vs + kBK * LD;
  const int S = a.S;
  const int n_qt = (S + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / a.groups;
  const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15;

  load_tile<HD, LD>(Qs, static_cast<const T*>(a.q), a.qs, b, h, q0, S);
  load_tile<HD, LD>(dOs, static_cast<const T*>(a.dout), a.dos, b, h, q0, S);
  float lse[4], dsum[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * rg + i;
    const int64_t at = ((int64_t)b * a.H + h) * S + row;
    lse[i] = row < S ? a.lse[at] : 0.f;
    dsum[i] = row < S ? a.dsum[at] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  int kt_begin, kt_end;
  key_band(q0, S, a.causal, a.window, kt_begin, kt_end);
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();               // the previous tile's readers are done
    load_tile<HD, LD>(Ks, static_cast<const T*>(a.k), a.ks, b, kvh, k0, S);
    load_tile<HD, LD>(Vs, static_cast<const T*>(a.v), a.vs, b, kvh, k0, S);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dots<HD, LD>(s, Qs, Ks, rg, cg);
    tile_dots<HD, LD>(dp, dOs, Vs, rg, cg);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * rg + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = visible(qpos, k0 + cg + 16 * j, S, a.causal, a.window);
        const float p = ok ? exp2f(s[i][j] * a.scale_log2 - lse[i]) : 0.f;
        Ds[(4 * rg + i) * PLD + cg + 16 * j] = p * (dp[i][j] - dsum[i]);
      }
    }
    __syncthreads();
    tile_mm<HD, LD>(acc, Ds, Ks, rg, cg);
  }

  T* dq = static_cast<T*>(a.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * rg + i;
    if (row >= S) continue;
    T* out = dq + (((int64_t)b * S + row) * a.H + h) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c) store(out + cg + 16 * c, acc[i][c] * a.scale);
  }
}

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads) bwd_dkdv_kernel(Args a) {
  constexpr int LD = ld<HD>();
  constexpr int NC = HD / 16;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + kBK * LD;
  float* Qs = Vs + kBK * LD;
  float* dOs = Qs + kBQ * LD;
  float* Ps = dOs + kBQ * LD;
  float* Ds = Ps + kBK * PLD;
  float* Ls = Ds + kBK * PLD;
  float* Dl = Ls + kBQ;
  const int S = a.S;
  const int k0 = blockIdx.x * kBK;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15;

  load_tile<HD, LD>(Ks, static_cast<const T*>(a.k), a.ks, b, kvh, k0, S);
  load_tile<HD, LD>(Vs, static_cast<const T*>(a.v), a.vs, b, kvh, k0, S);
  float dk[4][NC], dv[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[i][c] = dv[i][c] = 0.f;

  // the query tiles that see this key tile: from its own (causal) to the
  // last row within the window of its last key
  const int qt_begin = a.causal ? k0 / kBQ : 0;
  int q_last = S - 1;
  if (a.window > 0) q_last = min(q_last, k0 + kBK - 1 + a.window - 1);
  const int qt_end = q_last / kBQ + 1;
  for (int h = kvh * a.groups; h < (kvh + 1) * a.groups; ++h) {
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();             // the previous tile's readers are done
      load_tile<HD, LD>(Qs, static_cast<const T*>(a.q), a.qs, b, h, q0, S);
      load_tile<HD, LD>(dOs, static_cast<const T*>(a.dout), a.dos, b, h, q0, S);
      if (threadIdx.x < kBQ) {
        const int row = q0 + threadIdx.x;
        const int64_t at = ((int64_t)b * a.H + h) * S + row;
        Ls[threadIdx.x] = row < S ? a.lse[at] : 0.f;
        Dl[threadIdx.x] = row < S ? a.dsum[at] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];     // transposed: key 4rg + i, query cg + 16j
      tile_dots<HD, LD>(s, Ks, Qs, rg, cg);
      tile_dots<HD, LD>(dp, Vs, dOs, rg, cg);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kpos = k0 + 4 * rg + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qi = cg + 16 * j;
          const bool ok = visible(q0 + qi, kpos, S, a.causal, a.window);
          const float p = ok ? exp2f(s[i][j] * a.scale_log2 - Ls[qi]) : 0.f;
          Ps[(4 * rg + i) * PLD + qi] = p;
          Ds[(4 * rg + i) * PLD + qi] = p * (dp[i][j] - Dl[qi]);
        }
      }
      __syncthreads();
      tile_mm<HD, LD>(dv, Ps, dOs, rg, cg);
      tile_mm<HD, LD>(dk, Ds, Qs, rg, cg);
    }
  }

  T* dkp = static_cast<T*>(a.dk);
  T* dvp = static_cast<T*>(a.dv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + 4 * rg + i;
    if (row >= S) continue;
    const int64_t at = (((int64_t)b * S + row) * a.KV + kvh) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      store(dkp + at + cg + 16 * c, dk[i][c] * a.scale);
      store(dvp + at + cg + 16 * c, dv[i][c]);
    }
  }
}

template <int HD, typename T>
int launch(const Args& a, cudaStream_t stream) {
  // The attributes belong to the current device, so they are set at every
  // launch (host-side calls, cheap beside the kernels).
  cudaError_t err = cudaFuncSetAttribute(bwd_prep_kernel<HD, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)prep_smem<HD>());
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bwd_dq_kernel<HD, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_smem<HD>());
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bwd_dkdv_kernel<HD, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)dkdv_smem<HD>());
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (a.S + kBQ - 1) / kBQ, n_kt = (a.S + kBK - 1) / kBK;
  bwd_prep_kernel<HD, T><<<dim3(n_qt, a.H, a.B), kThreads, prep_smem<HD>(), stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  bwd_dq_kernel<HD, T><<<dim3(n_qt, a.H, a.B), kThreads, dq_smem<HD>(), stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  bwd_dkdv_kernel<HD, T><<<dim3(n_kt, a.KV, a.B), kThreads, dkdv_smem<HD>(), stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const Args& a, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<16, T>(a, stream);
    case 32: return launch<32, T>(a, stream);
    case 64: return launch<64, T>(a, stream);
    case 96: return launch<96, T>(a, stream);
    case 128: return launch<128, T>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The three kernels for inputs of type T: q, k, v, o, dout with element
// strides in the order (batch, sequence, head, head_dim); dq [B, S, H, hd]
// and dk, dv [B, S, KV, hd] contiguous, of type T; lse and dsum float32
// scratch of B * H * S each.  window <= 0 means no window.  Returns
// cudaGetLastError() of the launches.
template <typename T>
int run(const void* q, const void* k, const void* v, const void* o, const void* dout,
        void* dq, void* dk, void* dv, float* lse, float* dsum, int B, int S, int H, int KV,
        int hd, const int64_t* st, int causal, int window, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o; a.dout = dout;
  a.dq = dq; a.dk = dk; a.dv = dv; a.lse = lse; a.dsum = dsum;
  a.qs = Strides{st[0], st[1], st[2], st[3]};
  a.ks = Strides{st[4], st[5], st[6], st[7]};
  a.vs = Strides{st[8], st[9], st[10], st[11]};
  a.os = Strides{st[12], st[13], st[14], st[15]};
  a.dos = Strides{st[16], st[17], st[18], st[19]};
  a.B = B; a.S = S; a.H = H; a.KV = KV; a.groups = H / KV;
  a.causal = causal; a.window = window;
  a.scale = 1.f / sqrtf((float)hd);
  a.scale_log2 = 1.4426950408889634f * a.scale;
  return dispatch_hd<T>(hd, a, (cudaStream_t)stream);
}

}  // namespace

