"""Plain PyTorch versions of the bitdot and fused-estimate kernels."""

from __future__ import annotations

import torch


def unpack_bits_ref(codes: torch.Tensor, dim: int) -> torch.Tensor:
    """int32[..., W] (uint32 bit patterns) → f32[..., dim] of {0, 1}."""
    shifts = torch.arange(32, dtype=torch.int32, device=codes.device)
    bits = (codes[..., None] >> shifts) & 1
    return bits.reshape(*codes.shape[:-1], -1)[..., :dim].float()


def bitdot_ref(codes: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """S₊[b, k] = Σ_{j: bit j of codes[b, k] set} q[b, j].

    codes int32[B, K, W], q f32[B, d] with d ≤ 32·W → f32[B, K].
    """
    bits = unpack_bits_ref(codes, q.shape[-1])
    return torch.bmm(bits, q[:, :, None].float())[..., 0]


def s_plus_kernel_order(codes: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """S₊ as the CUDA kernels sum it (``csrc/rabitq_rows.cuh``), to the bit.

    codes int32[B, K, W], q f32[B, d] with d ≤ 32·W → f32[B, K].  Lane j of
    a row's warp adds q[32w + j] for the words w whose bit j is set, w
    ascending, in float32; then an xor butterfly over offsets 16, 8, 4, 2,
    1 adds lane j + h to lane j (h = 16, 8, …), which leaves the row's sum in
    lane 0.
    """
    B, K, W = codes.shape
    lanes = torch.zeros((B, 32 * W), dtype=torch.float32, device=q.device)
    lanes[:, :q.shape[1]] = q
    lanes = lanes.view(B, 1, W, 32)
    shifts = torch.arange(32, dtype=torch.int32, device=codes.device)
    bits = ((codes[..., None] >> shifts) & 1).bool()          # [B, K, W, 32]
    acc = torch.zeros((B, K, 32), dtype=torch.float32, device=q.device)
    for w in range(W):
        acc = acc + torch.where(bits[:, :, w], lanes[:, :, w], 0.0)
    for h in (16, 8, 4, 2, 1):
        acc = acc[..., :h] + acc[..., h:2 * h]
    return acc[..., 0]


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a·b + c on float32 tensors, rounded once to float32 (CUDA's
    ``__fmaf_rn``).  The product is exact in float64 and the sum exact as
    float64 s plus its rounding error e (Knuth's two-sum); rounding s to
    float32 is then the single rounding unless s lies halfway between two
    floats, where e says which of the two the exact value is nearer."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    v = s - p
    e = (p - (s - v)) + (c - v)
    r = s.float()
    r64 = r.double()
    up = s > r64
    inf = torch.full_like(r, float("inf"))
    other = torch.nextafter(r, torch.where(up, inf, -inf))   # past s from r
    tie = (s != r64) & ((r64 + other.double()) * 0.5 == s)
    beyond = torch.where(up, e > 0, e < 0)
    return torch.where(tie & beyond, other, r)


def fused_estimate_kernel_order(codes, norms, ip_xo, ids, q_unit, sum_q,
                                norm_q, sqrt_d):
    """``csrc/fused_estimate.cu`` on the host, to the bit: S₊ from
    :func:`s_plus_kernel_order` on the gathered rows, then the estimate in
    the kernel's order of operations and roundings,
    ``max(fma(−2·nv·nq, est_cos, fma(nq, nq, nv·nv)), 0)``; +inf at ids < 0
    and NaN at ids ≥ n."""
    n = codes.shape[0]
    safe = torch.where((ids >= 0) & (ids < n), ids, 0).long()
    s_plus = s_plus_kernel_order(codes[safe], q_unit)
    ip_xq = (2.0 * s_plus - sum_q[:, None]) / sqrt_d
    est_cos = ip_xq / torch.clamp_min(ip_xo[safe], 1e-6)
    nv = norms[safe]
    nq = norm_q[:, None].expand_as(nv)
    d2 = fma32(-2.0 * nv * nq, est_cos, fma32(nq, nq, nv * nv))
    d2 = torch.clamp_min(d2, 0.0)
    d2 = torch.where(ids < 0, float("inf"), d2)
    return torch.where(ids >= n, float("nan"), d2)


def estimate_from_s_plus(s_plus, ids, norms, ip_xo, sum_q, norm_q, sqrt_d):
    """The RaBitQ estimator algebra on S₊ f32[B, K] for ids int32[B, K]:
    ``max(nv² + nq² − 2·nv·nq·((2S₊ − Σq)/√d)/max(ip_xo, 1e-6), 0)``, +inf
    at ids < 0.  norms / ip_xo f32[n] are the code table's; sum_q / norm_q
    f32[B]; sqrt_d a scalar tensor."""
    safe = ids.clamp_min(0).long()
    sum_q = sum_q[:, None]
    ip_xq = (2.0 * s_plus - sum_q) / sqrt_d
    est_cos = ip_xq / torch.clamp_min(ip_xo[safe], 1e-6)
    nv = norms[safe]
    norm_q = norm_q[:, None]
    d2 = nv * nv + norm_q * norm_q - 2.0 * nv * norm_q * est_cos
    d2 = torch.clamp_min(d2, 0.0)
    return torch.where(ids >= 0, d2, torch.full_like(d2, float("inf")))


def fused_estimate_ref(codes, norms, ip_xo, ids, q_unit, sum_q, norm_q,
                       sqrt_d):
    """Estimated squared distances f32[B, K] for ids int32[B, K] (-1 → +inf)
    from the code table int32[n, W], norms / ip_xo f32[n], and the batched
    query context (q_unit f32[B, d], sum_q / norm_q f32[B], √d).

    S₊ comes from the ±1 signs, ``S₊ = (signs·q + Σq) / 2``, as the JAX
    package's ``rabitq.estimate_sqdist`` computes it.
    """
    rows = codes[ids.clamp_min(0).long()]                     # [B, K, W]
    signs = 2.0 * unpack_bits_ref(rows, q_unit.shape[-1]) - 1.0
    s_plus = 0.5 * (torch.bmm(signs, q_unit[:, :, None])[..., 0]
                    + sum_q[:, None])
    return estimate_from_s_plus(s_plus, ids, norms, ip_xo, sum_q, norm_q,
                                sqrt_d)
