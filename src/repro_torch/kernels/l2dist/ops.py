"""Wrappers of the CUDA gather-L2 kernels (``csrc/gather_l2.cu``).

``gather_l2_tiled`` replaces ``gather_l2_tiled_pallas`` and ``gather_l2``
replaces ``gather_l2_pallas`` (``src/repro/kernels/l2dist/l2dist.py``).
Both compute ``d2[b, m] = Σ_j (base[ids[b, m], j] − q[b, j])²`` with +inf
at ids < 0.  They differ in how many rows one block of the kernel owns
(8 or 1); the backend names ``kernel_tiled`` and ``kernel`` select them.

On a CUDA tensor the wrapper launches the kernel on the current stream and
raises if the launch fails; on a CPU tensor it runs the plain version in
``ref.py``.  Nothing else: no fallback hides the kernel.  ``base`` must be
float32 and contiguous already — the wrapper never copies it, since the
base is the whole dataset (512 MB at n = 1M, d = 128).

``LAUNCHES`` counts kernel launches per entry point; only a CUDA launch
adds to it.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import ref

LAUNCHES = {"gather_l2": 0, "gather_l2_tiled": 0}
_MAX_D = 12288          # the query line must fit 48 KB of shared memory
_MAX_B = 65535          # grid.y


def _check(base, ids, queries):
    if base.dim() != 2 or ids.dim() != 2 or queries.dim() != 2:
        raise ValueError("expected base [n, d], ids [B, M], queries [B, d]")
    if base.dtype != torch.float32 or queries.dtype != torch.float32:
        raise TypeError("base and queries must be float32")
    if ids.dtype != torch.int32:
        raise TypeError("ids must be int32")
    B, _ = ids.shape
    if tuple(queries.shape) != (B, base.shape[1]):
        raise ValueError(f"queries {tuple(queries.shape)} do not match "
                         f"ids {tuple(ids.shape)} and base {tuple(base.shape)}")
    if not (base.device == ids.device == queries.device):
        raise ValueError("base, ids and queries must be on one device")


def _launch(name: str, base, ids, queries):
    if not base.is_contiguous():
        raise ValueError("base must be contiguous (it is never copied)")
    B, M = ids.shape
    n, d = base.shape
    if d > _MAX_D or B > _MAX_B:
        raise ValueError(f"d={d} or B={B} beyond what the kernel takes")
    ids = ids.contiguous()
    queries = queries.contiguous()
    out = torch.empty((B, M), dtype=torch.float32, device=base.device)
    fn = getattr(_build.load("gather_l2"), name)
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] + \
        [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(base.data_ptr(), ids.data_ptr(), queries.data_ptr(),
            out.data_ptr(), n, B, M, d,
            torch.cuda.current_stream(base.device).cuda_stream)
    _build.check(rc, name)
    LAUNCHES[name] += 1
    return out


def _dispatch(name, base, ids, queries):
    _check(base, ids, queries)
    if base.device.type == "cpu":
        return ref.gather_l2_ref(base, ids, queries)
    if base.device.type != "cuda":
        raise ValueError(f"no {name} kernel for device {base.device}")
    return _launch(name, base, ids, queries)


def gather_l2(base: torch.Tensor, ids: torch.Tensor,
              queries: torch.Tensor) -> torch.Tensor:
    """base f32[n, d], ids int32[B, M] (-1 → +inf), queries f32[B, d] →
    f32[B, M]; one (b, m) row per kernel block."""
    return _dispatch("gather_l2", base, ids, queries)


def gather_l2_tiled(base: torch.Tensor, ids: torch.Tensor,
                    queries: torch.Tensor) -> torch.Tensor:
    """Same contract as :func:`gather_l2`; eight rows of one query line per
    kernel block, the query line shared through shared memory."""
    return _dispatch("gather_l2_tiled", base, ids, queries)
