// Attention's backward for bf16 inputs, dQ, dK and dV rounded to bf16 once from f32 sums: the kernels of
// flash_attn_bwd.cuh (their design, bound and what they replace are noted
// there) instantiated for bf16 at every head_dim the forward takes.

#include "flash_attn_bwd.cuh"

// q, k, v, o, dout: bf16, strides[20] their element strides, four a
// tensor in the order (batch, sequence, head, head_dim).  dq [B, S, H, hd]
// and dk, dv [B, S, KV, hd] contiguous, bf16; lse and dsum float32
// scratch of B * H * S each.  window <= 0 means no window.  Returns
// cudaGetLastError() of the launches.
extern "C" int flash_attn_bwd_bf16(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, void* dq, void* dk, void* dv, float* lse,
                                   float* dsum, int B, int S, int H, int KV, int hd,
                                   const int64_t* strides, int causal, int window, void* stream) {
  return run<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, lse, dsum, B, S, H, KV, hd,
                            strides, causal, window, stream);
}
