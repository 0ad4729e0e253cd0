"""Wrapper of the CUDA top-C merge (``csrc/merge_topc.cu``), the search
loops' ``core.search.batch_merge_topc``.

``merge_topc(ids_a, d2_a, vis_a, ids_b, d2_b, vis_b, cap)`` merges a
candidate buffer ``int32 / f32 / bool [B, C]``, ascending in d2, with a
pass's new entries ``[B, K]`` in any order, and keeps the C smallest of
each row: what ``ref.merge_topc_ref`` (the rows concatenated, sorted stably
and cut) gives on the card, to the bit, with ties to the buffer and then to
the new entries by column.  ``cap`` must be C.  The JAX package merges
with ``lax.top_k`` over the concatenation and has no kernel for it.

On a CUDA tensor the kernel updates the buffer **in place** and returns
it: the caller rebinds the result, and no other tensor may alias the
buffer.  The buffer must already be sorted in the card's sort order (it is
the previous merge's output); the kernel does not check it.  On a CPU
tensor the plain version runs and returns new tensors.  The kernel keeps
12·K bytes of shared memory a row, so K is at most ``MAX_K``.

``LAUNCHES`` counts kernel launches; only a CUDA launch adds to it.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import ref

LAUNCHES = {"merge_topc": 0}
MAX_K = 4096            # 48 KB of shared memory at one row a block


def merge_topc(ids_a: torch.Tensor, d2_a: torch.Tensor, vis_a: torch.Tensor,
               ids_b: torch.Tensor, d2_b: torch.Tensor, vis_b: torch.Tensor,
               cap: int):
    """Buffer ids int32 / d2 f32 / vis bool [B, C] (ascending d2) and new
    entries [B, K] → the C smallest of each row (ids, d2, vis); ``cap``
    must equal C.  On the card the buffer is updated in place and
    returned."""
    a, b = (ids_a, d2_a, vis_a), (ids_b, d2_b, vis_b)
    if any(t.dim() != 2 for t in (*a, *b)):
        raise ValueError("expected a buffer [B, C] and new entries [B, K]")
    if (ids_a.dtype != torch.int32 or ids_b.dtype != torch.int32
            or d2_a.dtype != torch.float32 or d2_b.dtype != torch.float32
            or vis_a.dtype != torch.bool or vis_b.dtype != torch.bool):
        raise TypeError("ids must be int32, d2 float32 and flags bool")
    B, C = ids_a.shape
    K = ids_b.shape[1]
    if (any(tuple(t.shape) != (B, C) for t in a)
            or any(tuple(t.shape) != (B, K) for t in b)):
        raise ValueError(f"shapes {[tuple(t.shape) for t in (*a, *b)]} are "
                         "not a buffer [B, C] and new entries [B, K]")
    if cap != C:
        raise ValueError(f"cap={cap} must be the buffer's width C={C}")
    if any(t.device != ids_a.device for t in (*a, *b)):
        raise ValueError("all inputs must be on one device")
    if ids_a.device.type == "cpu":
        return ref.merge_topc_ref(*a, *b, cap)
    if ids_a.device.type != "cuda":
        raise ValueError(f"no merge_topc kernel for device {ids_a.device}")
    if not all(t.is_contiguous() for t in (*a, *b)):
        raise ValueError("the buffer and the new entries must be contiguous "
                         "(the buffer is updated in place)")
    if K > MAX_K:
        raise ValueError(f"K={K} new entries a row, beyond the kernel's "
                         f"{MAX_K}")
    fn = _build.load("merge_topc").merge_topc
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(*(t.data_ptr() for t in (*a, *b)), B, C, K,
            torch.cuda.current_stream(ids_a.device).cuda_stream)
    _build.check(rc, "merge_topc")
    LAUNCHES["merge_topc"] += 1
    return a
