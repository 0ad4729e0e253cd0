"""Wrapper of the CUDA flash-attention kernel (``csrc/flash_attn.cu``).

``flash_attention`` replaces ``flash_attention_pallas``
(``src/repro/kernels/flashattn/flashattn.py``) and its wrapper
``repro.kernels.flashattn.ops.flash_attention``: q ``[B, S, H, hd]``,
k / v ``[B, S, KV, hd]`` → ``[B, S, H, hd]`` in q's dtype, causal and / or
sliding-window masked, query head h reading KV head ``h // (H / KV)``.

On a CUDA tensor the wrapper launches the kernel on q's card, on that
card's current stream, and raises if the launch fails; the kernel reads q,
k and v in place through their strides (no transpose, repeat or padding
copy).  On a CPU tensor it
runs the plain full-matrix version in ``ref.py`` on KV repeated to H heads.
Nothing else: no fallback hides the kernel.

``LAUNCHES`` counts kernel launches; only a CUDA launch adds to it.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build
from . import ref

LAUNCHES = {"flash_attention": 0}
HEAD_DIMS = (16, 32, 64, 96, 128)          # the kernel's template instances
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_YZ = 65535                       # H and B ride grid.y and grid.z


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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q [B,S,H,hd], k/v [B,S,KV,hd] → [B,S,H,hd] (GQA by head index)."""
    _check(q, k, v, window)
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if q.device.type == "cpu":
        groups = H // KV
        return ref.attention_ref(q, k.repeat_interleave(groups, dim=2),
                                 v.repeat_interleave(groups, dim=2),
                                 causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention kernel for device {q.device}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} is not one the kernel takes "
                         f"{HEAD_DIMS}")
    if B > _MAX_GRID_YZ or H > _MAX_GRID_YZ:
        raise ValueError(f"B={B} or H={H} beyond what the kernel takes")
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    fn = _build.load("flash_attn").flash_attn_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + \
        [ctypes.c_int64] * 12 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):       # launch in q's card's context
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                _DTYPES[q.dtype], B, S, H, KV, hd, *q.stride(), *k.stride(),
                *v.stride(), int(causal), 0 if window is None else int(window),
                torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out
