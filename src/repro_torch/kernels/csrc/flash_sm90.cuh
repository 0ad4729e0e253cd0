// Tile products and TMA tensor maps shared by the bf16 flash-attention
// kernels on Hopper's tensor cores: the forward (flash_attn_sm90.cu) and
// its backward (flash_attn_bwd_sm90.cu).  _build hashes it with every
// source that includes it, so an edit here rebuilds both.
//
// Tiles in shared memory are 128-byte-swizzled rows of 64 bf16 as TMA
// writes them (sm90_ptx.cuh); a tile of R rows and a head dim past 64 is
// two 64-column halves of R rows each, one after the other.  A product
// runs on one warpgroup: its 64 rows of A are a 64-row slice of a tile.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_ptx.cuh"

namespace {

using namespace sm90;

constexpr float kNeg = -1e30f;             // masked score (finite, as the TPU kernel's)
constexpr int kTensorMapError = 10000;     // + CUresult of a failed tensor-map encode

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// Issues acc[64 x N] (+)= A B^T over the head dim: A's 64 rows at a_addr
// in a tile of AROWS rows a half, B's N rows at b_addr in a tile of N rows
// a half, both K-major (a row's hd values contiguous).  No fence, commit
// or wait: the caller brackets one or more of these.
template <int HD, int N, int AROWS>
__device__ __forceinline__ void ss_steps(float (&acc)[N / 2], uint32_t a_addr,
                                         uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    // k-step kk: half kk / 4, bytes 32 (kk % 4) into each 128-byte row
    const uint32_t col = (kk % 4) * 32;
    const uint64_t da = desc_sw128(a_addr + (kk / 4) * AROWS * 128 + col, 16, 1024);
    const uint64_t db = desc_sw128(b_addr + (kk / 4) * N * 128 + col, 16, 1024);
    wgmma_ss<N>(acc, da, db, kk > 0);
  }
}

// s[64 x BK] = Q K^T for one warpgroup: Q rows at q_addr (a tile of QROWS
// rows a half), K rows at k_addr (BK rows a half), both 128-byte swizzled.
template <int HD, int BK, int QROWS>
__device__ __forceinline__ void qk_tile(float (&s)[BK / 2], uint32_t q_addr,
                                        uint32_t k_addr) {
  wgmma_fence();
  ss_steps<HD, BK, QROWS>(s, q_addr, k_addr);
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) fence_reg(s[i]);
}

// Two f32 values as two bf16x2 registers, x ~= hi + lo: hi = bf16(x),
// lo = bf16(x - hi), the lower value in the low half.
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 back = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(x0 - back.x, x1 - back.y));
}

// The f32 p of an accumulator fragment as two bf16 A fragments, p ~= p_hi +
// p_lo: k-step kk's register r holds p[8 kk + 2 r] (low half) and
// p[8 kk + 2 r + 1] (accumulator group j = 2 kk + r / 2, elements 2 (r % 2)
// and 2 (r % 2) + 1: rows g and g + 8, columns 2 t and 2 t + 1, then the
// same 8 columns on).
template <int BK>
__device__ __forceinline__ void split_p(const float (&p)[BK / 2],
                                        uint32_t (&ph)[BK / 16][4],
                                        uint32_t (&pl)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split2(p[8 * kk + 2 * r], p[8 * kk + 2 * r + 1], ph[kk][r], pl[kk][r]);
}

// o[64 x HD] += (p_hi + p_lo) V for one warpgroup, V rows at v_addr (BK
// rows a half).  V is an MN-major operand: its leading byte offset steps
// from one 64-column half to the next, its stride byte offset from one
// 8-key group (1024 bytes) to the next.
template <int HD, int BK>
__device__ __forceinline__ void pv_tile(float (&o)[HD / 2],
                                        const uint32_t (&ph)[BK / 16][4],
                                        const uint32_t (&pl)[BK / 16][4],
                                        uint32_t v_addr) {
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) fence_reg(o[i]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t db = desc_sw128(v_addr + kk * 16 * 128, BK * 128, 1024);
    wgmma_rs<HD>(o, ph[kk], db, 1);
    wgmma_rs<HD>(o, pl[kk], db, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) fence_reg(o[i]);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API call; the library links only the
// runtime, so it is looked up once through the runtime's entry-point table.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-d map (hd, heads, rows, batch) of a bf16 [B, S, heads, hd] tensor
// with the given element strides (hd's is 1), read in boxes of 64 columns
// x box_rows rows of one head, 128-byte swizzled, zero past every edge.
int make_map(CUtensorMap* map, const void* base, int hd, int heads, int rows, int batch,
             int64_t s_head, int64_t s_row, int64_t s_batch, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kTensorMapError + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)rows,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)s_head * 2, (cuuint64_t)s_row * 2,
                                 (cuuint64_t)s_batch * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                            const_cast<void*>(base), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapError + static_cast<int>(r);
}

struct Strides {
  int64_t b, s, h;
};

}  // namespace
