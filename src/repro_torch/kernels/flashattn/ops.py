"""Wrapper of the CUDA flash-attention kernels (``csrc/flash_attn_sm90.cu``
for bf16, ``csrc/flash_attn.cu`` for float32) and of their backward
(``csrc/flash_attn_bwd_sm90.cu`` for bf16, on the tensor cores from the
forward's log-sum-exp; ``csrc/flash_attn_bwd.cuh`` through
``flash_attn_bwd_f32.cu`` for float32).

``flash_attention`` replaces ``flash_attention_pallas``
(``src/repro/kernels/flashattn/flashattn.py``) and its wrapper
``repro.kernels.flashattn.ops.flash_attention``: q ``[B, S, H, hd]``,
k / v ``[B, S, KV, hd]`` → ``[B, S, H, hd]`` in q's dtype, causal and / or
sliding-window masked, query head h reading KV head ``h // (H / KV)``.

On a CUDA tensor the wrapper launches a kernel on q's card, on that card's
current stream, and raises if the launch fails.  bf16 goes to the tensor-core
kernel, which reads q, k and v by TMA through tensor maps made from their
strides (no transpose, repeat or padding copy); a tensor those maps cannot
describe (last stride not 1, a base or stride not 16-byte aligned, or dims
that do not nest, as in a transposed view) is first made contiguous and
counted in ``COPIES``; the bf16 backward reads q, k, v, o and dO the same
way (its copies under ``"flash_attention_bwd"``).  float32 goes to the
CUDA-core kernels, which read any strides.  On a CPU tensor it runs the
plain full-matrix version in ``ref.py`` on KV repeated to H heads.  Nothing
else: no fallback hides the kernel.

``flash_attention(..., return_lse=True)`` also gives each row's
log-sum-exp in log2 units, f32 [B, H, S], where the kernel writes it (the
bf16 kernel, and the plain version on the CPU; the float32 kernel gives
None).  ``flash_attention_bwd`` gives dQ, dK and dV from q, k, v, the
forward's output and its gradient (the kernel on a CUDA tensor, which in
bf16 reads that lse; ``ref.attention_bwd_ref`` on a CPU tensor), and
``attention`` is ``flash_attention`` made differentiable:
``FlashAttentionFn`` when a tensor needs a gradient, else exactly
``flash_attention``.  The Pallas kernel has no backward; the JAX
package differentiates its jnp blockwise attention, whose gradient this is.

``LAUNCHES`` counts kernel launches (a backward's three kernels count once);
only a CUDA launch adds to it.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build
from . import ref

LAUNCHES = {"flash_attention": 0, "flash_attention_bwd": 0}
COPIES = {"flash_attention": 0,            # bf16 inputs copied for TMA
          "flash_attention_bwd": 0}
BWD_PAD = 128                              # the bf16 backward's lse / D row padding
HEAD_DIMS = (16, 32, 64, 96, 128)          # the kernels' template instances
_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_YZ = 65535                       # f32 kernel: H and B ride grid.y, .z


def _check(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("expected q [B, S, H, hd] and k, v [B, S, KV, hd]")
    B, S, H, hd = q.shape
    if k.shape != v.shape or (k.shape[0], k.shape[1], k.shape[3]) != (B, S, hd):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    KV = k.shape[2]
    if KV == 0 or H % KV != 0:
        raise ValueError(f"{H} query heads are not a multiple of {KV} KV heads")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype, float32 or bfloat16")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if window is not None and int(window) < 1:
        raise ValueError(f"window must be at least 1, got {window}")


def tma_strides(x: torch.Tensor) -> Optional[tuple]:
    """(batch, sequence, head) element strides of a bf16 [B, S, heads, hd]
    tensor as the kernel's 4-d tensor map takes them, or None where the map
    cannot describe ``x``: the last stride must be 1, the base and every
    other stride 16-byte aligned, and each dim must step over the whole of
    the one inside it.  A dim of size 1 takes the stride a contiguous
    tensor would give it (its own is never followed)."""
    B, S, heads, hd = x.shape
    sb, ss, sh, sd = x.stride()
    if (hd > 1 and sd != 1) or x.data_ptr() % 16:
        return None
    sh = hd if heads == 1 else sh
    ss = heads * sh if S == 1 else ss
    sb = S * ss if B == 1 else sb
    if any(s % 8 for s in (sh, ss, sb)):    # 8 bf16 = 16 bytes
        return None
    if sh < hd or ss < heads * sh or sb < S * ss:
        return None
    return sb, ss, sh


def _for_tma(x: torch.Tensor, name: str = "flash_attention") -> torch.Tensor:
    if tma_strides(x) is not None:
        return x
    COPIES[name] += 1
    return x.contiguous()


def _launch_sm90(q, k, v, out, lse, causal, window):
    B, S, H, hd = q.shape
    q, k, v = (_for_tma(x) for x in (q, k, v))
    fn = _build.load("flash_attn_sm90").flash_attn_sm90_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + \
        [ctypes.c_int64] * 9 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              None if lse is None else lse.data_ptr(), B, S,
              H, k.shape[2], hd, *tma_strides(q), *tma_strides(k),
              *tma_strides(v), int(causal),
              0 if window is None else int(window),
              torch.cuda.current_stream(q.device).cuda_stream)


def _launch_f32(q, k, v, out, causal, window):
    B, S, H, hd = q.shape
    if B > _MAX_GRID_YZ or H > _MAX_GRID_YZ:
        raise ValueError(f"B={B} or H={H} beyond what the kernel takes")
    fn = _build.load("flash_attn").flash_attn_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + \
        [ctypes.c_int64] * 12 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              B, S, H, k.shape[2], hd, *q.stride(),
              *k.stride(), *v.stride(), int(causal),
              0 if window is None else int(window),
              torch.cuda.current_stream(q.device).cuda_stream)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    return_lse: bool = False):
    """q [B,S,H,hd], k/v [B,S,KV,hd] → [B,S,H,hd] (GQA by head index); with
    ``return_lse`` → (that, lse f32 [B,H,S] in log2 units, or None from the
    float32 kernel, whose backward recomputes it)."""
    _check(q, k, v, window)
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if q.device.type == "cpu":
        groups = H // KV
        return ref.attention_ref(q, k.repeat_interleave(groups, dim=2),
                                 v.repeat_interleave(groups, dim=2),
                                 causal=causal, window=window,
                                 return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention kernel for device {q.device}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} is not one the kernel takes "
                         f"{HEAD_DIMS}")
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    lse = None
    with torch.cuda.device(q.device):       # launch in q's card's context
        if q.dtype == torch.bfloat16:
            if return_lse:
                lse = torch.empty((B, H, S), dtype=torch.float32,
                                  device=q.device)
            rc = _launch_sm90(q, k, v, out, lse, causal, window)
        else:
            rc = _launch_f32(q, k, v, out, causal, window)
    _build.check(rc, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return (out, lse) if return_lse else out


def sm90_resources(hd: int = 64) -> dict:
    """The compiled resources of the bf16 tensor-core kernel's instance for
    ``hd`` (``cudaFuncGetAttributes`` and the launch's shared memory)."""
    lib = _build.load("flash_attn_sm90")
    out = (ctypes.c_int * 6)()
    lib.flash_attn_sm90_resources.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.flash_attn_sm90_resources.restype = ctypes.c_int
    _build.check(lib.flash_attn_sm90_resources(hd, ctypes.addressof(out)),
                 "flash_attention (resources)")
    return dict(zip(("registers", "local_bytes", "static_smem_bytes",
                     "dynamic_smem_bytes", "max_threads", "block_keys"),
                    list(out)))


def sm90_probe(q, k, v, p) -> tuple:
    """One warpgroup of the bf16 kernel's products on one tile each, for a
    card test of its layouts and wgmma descriptors: q [64, hd], k / v [BK,
    hd] bf16 and p [64, BK] f32, contiguous on the card → (q kᵀ,
    (p_hi + p_lo) v) in f32, p_hi = bf16(p), p_lo = bf16(p − p_hi).  Not
    counted in ``LAUNCHES``."""
    hd = q.shape[1]
    s = torch.empty((64, k.shape[0]), dtype=torch.float32, device=q.device)
    o = torch.empty((64, hd), dtype=torch.float32, device=q.device)
    fn = _build.load("flash_attn_sm90").flash_attn_sm90_probe
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), p.data_ptr(),
                s.data_ptr(), o.data_ptr(), hd,
                torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_attention (probe)")
    return s, o


def sm90_bwd_resources(hd: int = 64) -> dict:
    """The compiled resources of the bf16 backward's two product kernels
    for ``hd`` (``cudaFuncGetAttributes`` and the launches' shared memory),
    and their ring tiles: query rows of a dkdv tile, keys of a dq tile."""
    lib = _build.load("flash_attn_bwd_sm90")
    out = (ctypes.c_int * 10)()
    lib.flash_attn_bwd_sm90_resources.argtypes = [ctypes.c_int,
                                                  ctypes.c_void_p]
    lib.flash_attn_bwd_sm90_resources.restype = ctypes.c_int
    _build.check(lib.flash_attn_bwd_sm90_resources(hd, ctypes.addressof(out)),
                 "flash_attention_bwd (resources)")
    keys = ("registers", "local_bytes", "static_smem_bytes",
            "dynamic_smem_bytes")
    return {"dkdv": dict(zip(keys, list(out)[:4])),
            "dq": dict(zip(keys, list(out)[4:8])),
            "block_queries": out[8], "block_keys": out[9]}


def sm90_bwd_probe(k, q, do, p) -> tuple:
    """The bf16 backward's dK / dV products on one tile each, its layouts
    and wgmma descriptors as the kernel has them, for a card test: k [128,
    hd], q and do [BQ, hd] bf16 (BQ = ``sm90_bwd_resources(hd)
    ["block_queries"]``) and p [128, BQ] f32, contiguous on the card → (k
    qᵀ, (p_hi + p_lo) do) in f32, p_hi = bf16(p), p_lo = bf16(p − p_hi).
    Not counted in ``LAUNCHES``."""
    hd = k.shape[1]
    st = torch.empty((k.shape[0], q.shape[0]), dtype=torch.float32,
                     device=k.device)
    dv = torch.empty((k.shape[0], hd), dtype=torch.float32, device=k.device)
    fn = _build.load("flash_attn_bwd_sm90").flash_attn_bwd_sm90_probe
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(k.device):
        rc = fn(k.data_ptr(), q.data_ptr(), do.data_ptr(), p.data_ptr(),
                st.data_ptr(), dv.data_ptr(), hd,
                torch.cuda.current_stream(k.device).cuda_stream)
    _build.check(rc, "flash_attention_bwd (probe)")
    return st, dv


def _launch_bwd_sm90(q, k, v, o, do, lse, dq, dk, dv, causal, window):
    B, S, H, hd = q.shape
    q, k, v, o, do = (_for_tma(x, "flash_attention_bwd")
                      for x in (q, k, v, o, do))
    s_pad = -(-S // BWD_PAD) * BWD_PAD
    lse_pad = torch.empty((B, H, s_pad), dtype=torch.float32, device=q.device)
    dsum_pad = torch.empty_like(lse_pad)
    fn = _build.load("flash_attn_bwd_sm90").flash_attn_bwd_sm90
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    strides = (ctypes.c_int64 * 15)(*(s for x in (q, k, v, o, do)
                                      for s in tma_strides(x)))
    return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
              do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
              dv.data_ptr(), lse_pad.data_ptr(), dsum_pad.data_ptr(), B, S, H,
              k.shape[2], hd, ctypes.addressof(strides), int(causal),
              0 if window is None else int(window),
              torch.cuda.current_stream(q.device).cuda_stream)


def _launch_bwd_f32(q, k, v, o, do, dq, dk, dv, causal, window):
    B, S, H, hd = q.shape
    if B > _MAX_GRID_YZ or H > _MAX_GRID_YZ:
        raise ValueError(f"B={B} or H={H} beyond what the kernel takes")
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    dsum = torch.empty_like(lse)
    fn = _build.load("flash_attn_bwd_f32").flash_attn_bwd_f32
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    strides = (ctypes.c_int64 * 20)(*(s for x in (q, k, v, o, do)
                                      for s in x.stride()))
    return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
              do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
              lse.data_ptr(), dsum.data_ptr(), B, S, H, k.shape[2], hd,
              ctypes.addressof(strides), int(causal),
              0 if window is None else int(window),
              torch.cuda.current_stream(q.device).cuda_stream)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, causal: bool = True,
                        window: Optional[int] = None,
                        lse: Optional[torch.Tensor] = None) -> tuple:
    """(dq [B,S,H,hd], dk, dv [B,S,KV,hd]) of ``flash_attention``'s output
    ``o = flash_attention(q, k, v)`` under the gradient ``do`` [B,S,H,hd],
    in the inputs' dtype; dk and dv summed over each KV head's group.
    ``lse`` is the forward's ``return_lse`` output: the bf16 kernel needs
    it; the float32 kernel and the CPU's plain version do not read it."""
    _check(q, k, v, window)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must "
                         f"be q's shape {tuple(q.shape)}")
    if o.dtype != q.dtype or do.dtype != q.dtype:
        raise TypeError("o and do must have q's dtype")
    if not (q.device == o.device == do.device):
        raise ValueError("q, k, v, o and do must be on one device")
    B, S, H, hd = q.shape
    if lse is not None and (lse.shape != (B, H, S)
                            or lse.dtype != torch.float32
                            or lse.device != q.device
                            or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous float32 [B, H, S] = "
                         f"{[B, H, S]} on q's device, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    if q.device.type == "cpu":
        return ref.attention_bwd_ref(q, k, v, o, do, causal=causal,
                                     window=window)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention_bwd kernel for device "
                         f"{q.device}")
    KV = k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} is not one the kernel takes "
                         f"{HEAD_DIMS}")
    bf16 = q.dtype == torch.bfloat16
    if bf16 and lse is None:
        raise ValueError("the bf16 backward reads the forward's lse: pass "
                         "what flash_attention(..., return_lse=True) gave")
    dq = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, S, KV, hd), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    with torch.cuda.device(q.device):
        if bf16:
            rc = _launch_bwd_sm90(q, k, v, o, do, lse, dq, dk, dv, causal,
                                  window)
        else:
            rc = _launch_bwd_f32(q, k, v, o, do, dq, dk, dv, causal, window)
    _build.check(rc, "flash_attention_bwd")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` with its backward: the forward kernel, which
    also gives each row's log-sum-exp (saved beside q, k, v and the
    output), and ``flash_attention_bwd`` on what it saved."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        o, lse = flash_attention(q, k, v, causal=causal, window=window,
                                 return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do.to(o.dtype),
                                         causal=ctx.causal, window=ctx.window,
                                         lse=lse)
        return dq, dk, dv, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True,
              window: Optional[int] = None) -> torch.Tensor:
    """``flash_attention``, differentiable in q, k and v: through
    ``FlashAttentionFn`` when autograd records and one of them needs a
    gradient, else exactly ``flash_attention`` (no tensor saved)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, window)
    return flash_attention(q, k, v, causal=causal, window=window)
