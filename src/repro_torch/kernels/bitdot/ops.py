"""Wrapper of the CUDA bitdot kernel (``csrc/bitdot.cu``), which replaces
``bitdot_pallas`` (``src/repro/kernels/bitdot/bitdot.py``).

``bitdot(codes, q)`` is batched over queries: codes ``int32[B, K, W]`` (the
JAX package's ``uint32`` words, bit for bit) and q ``f32[B, d]`` →
S₊ ``f32[B, K]``.  It has the signature ``core.rabitq.estimate_sqdist``
expects for its ``bitdot_fn`` plug, so ``probing_search(use_kernel=True)``
makes one launch per hop over the whole batch's ``[B, W·M]`` code rows.

On a CUDA tensor it pads q with zeros to ``32·W`` and launches the kernel;
on a CPU tensor it runs the plain version in ``ref.py``.  The kernel sums
in another order than the plain version; they agree to rtol 1e-5 /
atol 1e-4, the tolerance of the JAX package's kernel test.

``LAUNCHES`` counts kernel launches; only a CUDA launch adds to it.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import _build
from . import ref

LAUNCHES = {"bitdot": 0}
_MAX_W = 384            # the padded query line must fit 48 KB of shared memory
_MAX_B = 65535          # grid.y


def bitdot(codes: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """codes int32[B, K, W], q f32[B, d] (d ≤ 32·W) → S₊ f32[B, K]."""
    if codes.dim() != 3 or q.dim() != 2:
        raise ValueError("expected codes [B, K, W] and q [B, d]")
    if codes.dtype != torch.int32 or q.dtype != torch.float32:
        raise TypeError("codes must be int32 and q float32")
    B, K, W = codes.shape
    if q.shape[0] != B or q.shape[1] > 32 * W:
        raise ValueError(f"q {tuple(q.shape)} does not match codes "
                         f"{tuple(codes.shape)}")
    if codes.device != q.device:
        raise ValueError("codes and q must be on one device")
    if codes.device.type == "cpu":
        return ref.bitdot_ref(codes, q)
    if codes.device.type != "cuda":
        raise ValueError(f"no bitdot kernel for device {codes.device}")
    if W > _MAX_W or B > _MAX_B:
        raise ValueError(f"W={W} or B={B} beyond what the kernel takes")
    codes = codes.contiguous()
    q_pad = F.pad(q, (0, 32 * W - q.shape[1])).contiguous()
    out = torch.empty((B, K), dtype=torch.float32, device=codes.device)
    fn = _build.load("bitdot").bitdot
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(codes.data_ptr(), q_pad.data_ptr(), out.data_ptr(), B, K, W,
            torch.cuda.current_stream(codes.device).cuda_stream)
    _build.check(rc, "bitdot")
    LAUNCHES["bitdot"] += 1
    return out
