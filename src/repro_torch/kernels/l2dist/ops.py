"""Wrappers of the CUDA gather-L2 kernels (``csrc/gather_l2.cu``) and of
the CUDA batched-L2 kernel (``csrc/batched_l2.cu``).

``gather_l2_tiled`` replaces ``gather_l2_tiled_pallas`` and ``gather_l2``
replaces ``gather_l2_pallas`` (``src/repro/kernels/l2dist/l2dist.py``).
Both compute ``d2[b, m] = Σ_j (base[ids[b, m], j] − q[b, j])²`` with +inf
at ids < 0; the backend names ``kernel_tiled`` and ``kernel`` select them.
Each launches one of three kernels by the same rule, each a superset of
the one before in the shapes it takes; ``gather_l2_tiled`` gives a warp
several rows (:func:`tiled_kernel`), ``gather_l2`` one (b, m) row, the
Pallas kernel's unit (:func:`one_row_kernel`):

* ``gather_l2_rows`` (2 rows a warp) / ``gather_l2_row1`` (one) at d % 4
  == 0, d ≤ 128 and a 16-byte-aligned base and query line — the drain's
  [128, 1], the build's [1024, 24], ``backend="kernel"``'s [128, 24]: a
  warp loads its ids, then its rows and query line into registers, one
  float4 a lane, every load issued before any reduction; no shared
  memory, no barrier;
* ``gather_l2_ragged`` (4 rows a warp) / ``gather_l2_ragged1`` (one) at
  any other d ≤ 256 — MIPS's ragged d + 1 = 129, a misaligned view,
  d = 130–256: the same design with scalar columns, which need only
  4-byte alignment;
* ``gather_l2_blocks`` past d = 256, for both: eight rows of one line per
  block, one a warp — at d = 960 (GIST1M's width) the build's searches'
  [block, 64] and the probing loop's exact tier's [B, 1], where one warp
  of each block's eight has a row.

On a CUDA tensor the wrapper launches the kernel on the current stream and
raises if the launch fails; on a CPU tensor it runs the plain version in
``ref.py``.  Nothing else: no fallback hides the kernel.  ``base`` must be
float32 and contiguous already — the wrapper never copies it, since the
base is the whole dataset (512 MB at n = 1M, d = 128).

``batched_l2`` replaces ``batched_l2_pallas`` (same file): rows
``[B, M, d]`` against one query line each, ``[B, d]`` → ``f32[B, M]``, by
the difference form.  It is the kept-to-candidate distance of
``core.geometry.select_neighbors``, the occlusion test of every builder.
bf16 inputs are cast to f32 first, as the JAX package's kernel call does.
It launches the same three kernels by the same rule
(:func:`batched_kernel`): ``batched_l2_rows`` where every load can be
16-byte aligned — d % 4 == 0, d ≤ 128, aligned rows and query lines and a
query stride that is a multiple of 4 — ``batched_l2_ragged`` at any other
d ≤ 256 (MIPS's query line is a strided column of its candidate tile),
and ``batched_l2_blocks`` (one row a warp) past that (d = 960's
selection and degree alignment, [block, 64–65, 960]).

``LAUNCHES`` counts kernel launches per entry point and ``KERNEL_LAUNCHES``
per kernel behind it; only a CUDA launch adds to them.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import ref

LAUNCHES = {"gather_l2": 0, "gather_l2_tiled": 0, "batched_l2": 0}
# the kernels behind gather_l2_tiled, gather_l2 and batched_l2
KERNEL_LAUNCHES = {f"{entry}_{kind}": 0 for entry in ("gather_l2", "batched_l2")
                   for kind in ("rows", "ragged", "blocks")}
KERNEL_LAUNCHES.update(gather_l2_row1=0, gather_l2_ragged1=0)
_MAX_D = 12288          # the query line must fit 48 KB of shared memory
_MAX_B = 65535          # grid.y
_VEC_MAX_D = 128        # the float4 register kernel's widest row
_RAGGED_MAX_D = 256     # the scalar register kernel's (csrc/l2_rows.cuh)


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


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


def _kind(d: int, aligned: bool) -> str:
    if d % 4 == 0 and d <= _VEC_MAX_D and aligned:
        return "rows"
    return "ragged" if d <= _RAGGED_MAX_D else "blocks"


def tiled_kernel(base: torch.Tensor, queries: torch.Tensor) -> str:
    """The kernel ``gather_l2_tiled`` launches over ``base`` with the
    (contiguous) ``queries``."""
    aligned = _aligned(base) and _aligned(queries)
    return "gather_l2_" + _kind(base.shape[1], aligned)


def one_row_kernel(base: torch.Tensor, queries: torch.Tensor) -> str:
    """The kernel ``gather_l2`` launches over ``base`` with the
    (contiguous) ``queries``: :func:`tiled_kernel`'s rule, one row a warp."""
    kind = _kind(base.shape[1], _aligned(base) and _aligned(queries))
    return "gather_l2_" + {"rows": "row1", "ragged": "ragged1",
                           "blocks": "blocks"}[kind]


def batched_kernel(rows: torch.Tensor, queries: torch.Tensor) -> str:
    """The kernel ``batched_l2`` launches for the f32 contiguous ``rows``
    [B, M, d] and ``queries`` [B, d] (unit stride along d)."""
    aligned = (queries.stride(0) % 4 == 0 and _aligned(rows)
               and _aligned(queries))
    return "batched_l2_" + _kind(rows.shape[2], aligned)


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
    kernel = (one_row_kernel if name == "gather_l2" else tiled_kernel)(
        base, queries)
    fn = getattr(_build.load("gather_l2"), kernel)
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] + \
        [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(base.data_ptr(), ids.data_ptr(), queries.data_ptr(),
            out.data_ptr(), n, B, M, d,
            torch.cuda.current_stream(base.device).cuda_stream)
    _build.check(rc, kernel)
    LAUNCHES[name] += 1
    KERNEL_LAUNCHES[kernel] += 1
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
    f32[B, M]; one (b, m) row a warp, the kernel chosen by d and alignment
    (:func:`one_row_kernel`)."""
    return _dispatch("gather_l2", base, ids, queries)


def gather_l2_tiled(base: torch.Tensor, ids: torch.Tensor,
                    queries: torch.Tensor) -> torch.Tensor:
    """Same contract as :func:`gather_l2`; the kernel is chosen by d and
    alignment (:func:`tiled_kernel`)."""
    return _dispatch("gather_l2_tiled", base, ids, queries)


def batched_l2(rows: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """rows f32/bf16[B, M, d], queries f32/bf16[B, d] → squared L2
    f32[B, M].  On the card ``rows`` is used as it is if it is float32 and
    contiguous, and a query line may have any stride between lines."""
    if rows.dim() != 3 or queries.dim() != 2:
        raise ValueError("expected rows [B, M, d] and queries [B, d]")
    B, M, d = rows.shape
    if tuple(queries.shape) != (B, d):
        raise ValueError(f"queries {tuple(queries.shape)} do not match rows "
                         f"{tuple(rows.shape)}")
    ok = (torch.float32, torch.bfloat16)
    if rows.dtype not in ok or queries.dtype not in ok:
        raise TypeError("rows and queries must be float32 or bfloat16")
    if rows.device != queries.device:
        raise ValueError("rows and queries must be on one device")
    if rows.device.type == "cpu":
        return ref.batched_l2_ref(rows, queries)
    if rows.device.type != "cuda":
        raise ValueError(f"no batched_l2 kernel for device {rows.device}")
    if d > _MAX_D or B > _MAX_B:
        raise ValueError(f"d={d} or B={B} beyond what the kernel takes")
    rows = rows.float().contiguous()
    queries = queries.float()
    if queries.stride(1) != 1:
        queries = queries.contiguous()
    out = torch.empty((B, M), dtype=torch.float32, device=rows.device)
    kernel = batched_kernel(rows, queries)
    fn = getattr(_build.load("batched_l2"), kernel)
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + \
        [ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(rows.data_ptr(), queries.data_ptr(), out.data_ptr(), B, M, d,
            queries.stride(0),
            torch.cuda.current_stream(rows.device).cuda_stream)
    _build.check(rc, kernel)
    LAUNCHES["batched_l2"] += 1
    KERNEL_LAUNCHES[kernel] += 1
    return out
