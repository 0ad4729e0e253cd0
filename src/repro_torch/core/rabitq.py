"""RaBitQ 1-bit-per-dimension quantization — the distance-estimation
substrate of δ-EMQG.  Counterpart of ``repro.core.rabitq``; see its module
docstring for the estimator.

Differences from the JAX package:

* ``fit(vectors, rotation)`` takes the rotation explicitly: the JAX package
  draws it from ``jax.random``, which PyTorch cannot reproduce.
  ``random_rotation(dim, generator)`` draws one from a ``torch.Generator``
  with the same QR and sign fix.
* Codes are ``int32`` views of the ``uint32`` words.
* The query-side functions are batched: ``prepare_query`` takes ``[B, d]``
  and ``estimate_sqdist`` takes ids ``[B, K]`` (the JAX package vmaps the
  per-query versions).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..kernels.bitdot.ref import unpack_bits_ref
from .types import RaBitQCodes, take_rows


def random_rotation(dim: int, generator: Optional[torch.Generator] = None,
                    device=None) -> torch.Tensor:
    """Haar-ish random orthogonal matrix via QR of a Gaussian (drawn on the
    CPU from ``generator``, then moved to ``device``)."""
    g = torch.randn((dim, dim), generator=generator, dtype=torch.float32)
    qmat, r = torch.linalg.qr(g)
    # fix signs so the distribution is rotation-invariant
    return (qmat * torch.sign(torch.diagonal(r))[None, :]).to(device)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """bool[n, d] → int32[n, ceil(d/32)] (bit j of word w = dim 32w+j), the
    ``uint32`` words of the JAX package read as ``int32``."""
    n, d = bits.shape
    words = (d + 31) // 32
    b = torch.nn.functional.pad(bits.long(), (0, words * 32 - d))
    weights = torch.ones(32, dtype=torch.int64, device=bits.device) << \
        torch.arange(32, device=bits.device)
    w = (b.reshape(n, words, 32) * weights).sum(-1)       # [0, 2**32)
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)


def unpack_bits(codes: torch.Tensor, dim: int) -> torch.Tensor:
    """int32[..., W] → f32[..., dim] of ±1 signs."""
    return 2.0 * unpack_bits_ref(codes, dim) - 1.0


def fit(vectors: torch.Tensor, rotation: torch.Tensor) -> RaBitQCodes:
    """RaBitQ codes of ``vectors`` under ``rotation``, on vectors' device."""
    vectors = vectors.float()
    rotation = rotation.to(vectors.device, torch.float32)
    dim = vectors.shape[1]
    center = vectors.mean(0)
    r = (vectors - center[None, :]) @ rotation.T
    norms = torch.linalg.norm(r, dim=-1)
    codes = pack_bits(r > 0)
    sqrt_d = torch.tensor(float(dim), device=vectors.device).sqrt()
    ip_xo = r.abs().sum(-1) / (sqrt_d * torch.clamp_min(norms, 1e-30))
    return RaBitQCodes(codes=codes, norms=norms, ip_xo=ip_xo,
                       rotation=rotation, center=center, dim=dim)


class QueryCtx(NamedTuple):
    """Per-query precomputation shared by every estimate of one search
    (batched: one row per query)."""
    q: torch.Tensor        # f32[B, d]  the raw queries
    q_unit: torch.Tensor   # f32[B, d]  rotated unit residual directions
    sum_q: torch.Tensor    # f32[B]     Σ q_unit
    norm_q: torch.Tensor   # f32[B]     ‖q − c‖
    sqrt_d: torch.Tensor   # f32[]      √d, made once per search, not per hop


def prepare_query(codes: RaBitQCodes, q: torch.Tensor) -> QueryCtx:
    """Batched query preparation: q f32[B, d]."""
    r = (q - codes.center) @ codes.rotation.T
    norm_q = torch.linalg.norm(r, dim=-1)
    q_unit = r / torch.clamp_min(norm_q, 1e-30)[:, None]
    sqrt_d = torch.tensor(float(codes.dim), device=q.device).sqrt()
    return QueryCtx(q=q, q_unit=q_unit, sum_q=q_unit.sum(-1), norm_q=norm_q,
                    sqrt_d=sqrt_d)


def estimate_sqdist(codes: RaBitQCodes, ctx: QueryCtx, ids: torch.Tensor,
                    bitdot_fn: Optional[Callable] = None) -> torch.Tensor:
    """Estimated squared distances f32[B, K] for node ids int32[B, K]
    (-1 → +inf).

    ``bitdot_fn(code_rows int32[B, K, W], q_unit f32[B, d]) → S₊ f32[B, K]``
    defaults to the plain signs-times-query product; the serving layer plugs
    in the CUDA kernel (``kernels.bitdot.ops.bitdot``).
    """
    rows = take_rows(codes.codes, ids)                          # [B, K, W]
    sum_q = ctx.sum_q[:, None]
    if bitdot_fn is None:
        signs = unpack_bits(rows, codes.dim)                    # ±1
        s_plus = 0.5 * (torch.bmm(signs, ctx.q_unit[:, :, None])[..., 0]
                        + sum_q)
    else:
        s_plus = bitdot_fn(rows, ctx.q_unit)
    ip_xq = (2.0 * s_plus - sum_q) / ctx.sqrt_d
    ip_xo = torch.clamp_min(take_rows(codes.ip_xo, ids), 1e-6)
    est_cos = ip_xq / ip_xo
    nv = take_rows(codes.norms, ids)
    norm_q = ctx.norm_q[:, None]
    d2 = nv * nv + norm_q * norm_q - 2.0 * nv * norm_q * est_cos
    d2 = torch.clamp_min(d2, 0.0)
    return torch.where(ids >= 0, d2, torch.full_like(d2, float("inf")))


def estimator_error_bound(codes: RaBitQCodes, ids: torch.Tensor,
                          eps0: float = 1.9) -> torch.Tensor:
    """Per-vector high-probability bound on |⟨o,q⟩ − est| (RaBitQ Thm 3.2):
    ε ≈ ε₀·√((1 − ip_xo²) / ip_xo²) / √(d − 1)."""
    ip = torch.clamp_min(take_rows(codes.ip_xo, ids), 1e-6)
    d = torch.tensor(float(codes.dim), device=ids.device)
    return eps0 * torch.sqrt(torch.clamp_min(1.0 - ip * ip, 0.0) / (ip * ip)) \
        / torch.sqrt(d - 1.0)


def exact_sqdist(vectors: torch.Tensor, q: torch.Tensor,
                 ids: torch.Tensor) -> torch.Tensor:
    """Exact squared distances f32[B, K] from q f32[B, d] to ids int32[B, K]
    (-1 → +inf)."""
    diff = take_rows(vectors, ids) - q[:, None, :]
    d2 = (diff * diff).sum(-1)
    return torch.where(ids >= 0, d2, torch.full_like(d2, float("inf")))
