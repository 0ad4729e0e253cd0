"""Wrappers of the CUDA bitdot kernel (``csrc/bitdot.cu``), which replaces
``bitdot_pallas``, and of the CUDA fused-estimate kernel
(``csrc/fused_estimate.cu``), which replaces ``fused_estimate_pallas``
(both in ``src/repro/kernels/bitdot/bitdot.py``).

``bitdot(codes, q)`` is batched over queries: codes ``int32[B, K, W]`` (the
JAX package's ``uint32`` words, bit for bit) and q ``f32[B, d]`` →
S₊ ``f32[B, K]``.  It has the signature ``core.rabitq.estimate_sqdist``
expects for its ``bitdot_fn`` plug, so ``probing_search(use_kernel=True)``
makes one launch per hop over the whole batch's ``[B, W·M]`` code rows.

``fused_estimate(codes, norms, ip_xo, ids, q_unit, sum_q, norm_q,
sqrt_d)`` is the whole RaBitQ estimate gathered by id: the code table
``int32[n, W]``, ``norms`` / ``ip_xo`` ``f32[n]``, ids ``int32[B, K]`` and
the search's batched query context → ``f32[B, K]``, +inf at ids < 0.  It is
``core.rabitq.estimate_sqdist``'s default on a CUDA index: one launch per
hop in place of the gather, the unpack, the product and the algebra.

On a CUDA tensor each launches its kernel; on a CPU tensor each runs its
plain version in ``ref.py``.  Both kernels take q unpadded (they read it as
0 past d) and keep no shared memory: a warp owns four code rows and holds
the query line in registers (``csrc/rabitq_rows.cuh``).  They sum S₊ in
the order that ``ref.s_plus_kernel_order`` reproduces, and equal it (and
``ref.fused_estimate_kernel_order``) to the bit.  The plain versions sum
in other orders: bitdot's agrees to rtol 1e-5 / atol 1e-4, the tolerance of
the JAX package's kernel test; fused_estimate's sums ±1 signs where the
kernel sums set bits, and agrees to rtol 1e-4 / atol 1e-3, the JAX
package's fused-estimate test tolerance.

``LAUNCHES`` counts kernel launches; only a CUDA launch adds to it.
``CHUNK_LAUNCHES`` counts ``fused_estimate``'s by the instance that ran,
keyed by the code rows' chunks of 8 words (:func:`estimate_chunks`): 1 up
to W = 8 (d ≤ 256), 4 at W = 30 (d = 960: three full chunks in the
kernel's loop and a last chunk of 6 words, its template instance).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import ref

LAUNCHES = {"bitdot": 0, "fused_estimate": 0}
CHUNK_LAUNCHES: dict[int, int] = {}
_MAX_B = 65535          # grid.y
_CHUNK = 8              # code words a chunk (csrc/rabitq_rows.cuh's kChunk)


def estimate_chunks(W: int) -> int:
    """The chunks of 8 code words a row of W words takes in the kernels:
    the key of ``CHUNK_LAUNCHES``."""
    return -(-W // _CHUNK)


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
    if B > _MAX_B:
        raise ValueError(f"B={B} beyond what the kernel takes")
    codes, q = codes.contiguous(), q.contiguous()
    out = torch.empty((B, K), dtype=torch.float32, device=codes.device)
    fn = _build.load("bitdot").bitdot_rows
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(codes.data_ptr(), q.data_ptr(), out.data_ptr(), B, K, W,
            q.shape[1], torch.cuda.current_stream(codes.device).cuda_stream)
    _build.check(rc, "bitdot")
    LAUNCHES["bitdot"] += 1
    return out


def fused_estimate(codes: torch.Tensor, norms: torch.Tensor,
                   ip_xo: torch.Tensor, ids: torch.Tensor,
                   q_unit: torch.Tensor, sum_q: torch.Tensor,
                   norm_q: torch.Tensor, sqrt_d: torch.Tensor) -> torch.Tensor:
    """codes int32[n, W], norms / ip_xo f32[n], ids int32[B, K] (-1 → +inf),
    q_unit f32[B, d] (d ≤ 32·W), sum_q / norm_q f32[B], sqrt_d f32 scalar →
    estimated d² f32[B, K].  The code table and its scalars are never
    copied."""
    if codes.dim() != 2 or ids.dim() != 2 or q_unit.dim() != 2:
        raise ValueError("expected codes [n, W], ids [B, K], q_unit [B, d]")
    if codes.dtype != torch.int32 or ids.dtype != torch.int32:
        raise TypeError("codes and ids must be int32")
    floats = (norms, ip_xo, q_unit, sum_q, norm_q, sqrt_d)
    if any(t.dtype != torch.float32 for t in floats):
        raise TypeError("norms, ip_xo, q_unit, sum_q, norm_q and sqrt_d must "
                        "be float32")
    n, W = codes.shape
    B = ids.shape[0]
    if (q_unit.shape[0] != B or q_unit.shape[1] > 32 * W
            or tuple(norms.shape) != (n,) or tuple(ip_xo.shape) != (n,)
            or tuple(sum_q.shape) != (B,) or tuple(norm_q.shape) != (B,)
            or sqrt_d.numel() != 1):
        raise ValueError(f"shapes do not match codes {tuple(codes.shape)} and "
                         f"ids {tuple(ids.shape)}")
    if any(t.device != codes.device for t in (ids, *floats)):
        raise ValueError("all inputs must be on one device")
    if codes.device.type == "cpu":
        return ref.fused_estimate_ref(codes, norms, ip_xo, ids, q_unit, sum_q,
                                      norm_q, sqrt_d)
    if codes.device.type != "cuda":
        raise ValueError(f"no fused_estimate kernel for device {codes.device}")
    if B > _MAX_B:
        raise ValueError(f"B={B} beyond what the kernel takes")
    if not all(t.is_contiguous() for t in (codes, norms, ip_xo)):
        raise ValueError("codes, norms and ip_xo must be contiguous (they are "
                         "never copied)")
    ids, q_unit, sum_q, norm_q = (t.contiguous()
                                  for t in (ids, q_unit, sum_q, norm_q))
    K = ids.shape[1]
    out = torch.empty((B, K), dtype=torch.float32, device=codes.device)
    fn = _build.load("fused_estimate").fused_estimate
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int64] + \
        [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(codes.data_ptr(), norms.data_ptr(), ip_xo.data_ptr(),
            ids.data_ptr(), q_unit.data_ptr(), sum_q.data_ptr(),
            norm_q.data_ptr(), sqrt_d.data_ptr(), out.data_ptr(), n, B, K, W,
            q_unit.shape[1], torch.cuda.current_stream(codes.device).cuda_stream)
    _build.check(rc, "fused_estimate")
    LAUNCHES["fused_estimate"] += 1
    chunks = estimate_chunks(W)
    CHUNK_LAUNCHES[chunks] = CHUNK_LAUNCHES.get(chunks, 0) + 1
    return out
