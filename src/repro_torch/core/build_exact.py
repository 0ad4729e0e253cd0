"""Algorithm 2 — exact δ-EMG construction (O(n² log n)).

Counterpart of ``repro.core.build_exact``, on the vectors' device.  For
every node u, all other nodes are sorted by distance and greedily admitted
unless occluded (Def. 9) by an already-admitted neighbor.  This is the
construction whose closure property Theorem 3 proves; it is intractable past
~10⁵ points and serves as the ground truth for the monotonicity tests and
the exact baselines.

Nodes go through ``select_neighbors`` in blocks.  Its candidate loop runs
over all n candidates for each block, so the block sets how often that host
loop runs: the JAX package vmaps blocks of 16; here the default block is as
large as ``_CAND_BYTES`` of candidate vectors (``block × n × d × 4``
bytes) allows, which changes no result — each node's selection is its own.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from .distances import medoid as find_medoid
from .distances import pairwise_sqdist
from .geometry import select_neighbors
from .types import GraphIndex, resolve_device

_CAND_BYTES = 1 << 30     # candidate vectors of one block: at most 1 GiB


def _build_block(vectors: torch.Tensor, u_ids: torch.Tensor, delta: float,
                 rule: str, max_keep: int):
    d2 = pairwise_sqdist(vectors[u_ids], vectors)                  # [B, n]
    # u is not its own candidate: the norm identity can leave d²(u, u) a few
    # ulps above 0, and the selector admits only d² > 0
    d2[torch.arange(u_ids.numel(), device=d2.device), u_ids] = 0.0
    # jnp.argsort is stable; so is this sort
    order = torch.argsort(d2, dim=1, stable=True)
    cand_d2 = d2.gather(1, order)
    deltas = torch.full_like(cand_d2, delta)
    return select_neighbors(vectors[order], cand_d2, order.to(torch.int32),
                            deltas, rule=rule, max_keep=max_keep)


def _default_block(n: int, d: int) -> int:
    """Nodes per block such that a block's candidate vectors fit
    ``_CAND_BYTES``."""
    return max(1, min(n, _CAND_BYTES // (4 * n * d)))


def _default_max_degree(n: int) -> int:
    """``min(n - 1, 8·⌈log2 n⌉ + 32)``: Lemma 2's O(log n) with room."""
    return int(min(n - 1, 8 * np.ceil(np.log2(max(n, 2))) + 32))


def build_exact(vectors, delta: float = 0.05, rule: str = "delta_emg",
                max_degree: Optional[int] = None, block: Optional[int] = None,
                kind: Optional[str] = None, device="cuda") -> GraphIndex:
    """Exact Algorithm-2 build on ``device``.  ``rule`` selects the occlusion
    family, so the same driver also produces exact MRNG (δ→0), τ-MG and
    Vamana graphs.

    ``max_degree`` caps storage; Lemma 2 gives expected degree O(log n), so
    the default ``min(n-1, 8·⌈log2 n⌉ + 32)`` overflows only on adversarial
    inputs — overflow is reported with a warning (the guarantee needs every
    non-occluded edge kept).  ``block=None`` sizes the node blocks by memory
    (:func:`_default_block`).
    """
    dev = resolve_device(device)
    vectors = torch.as_tensor(vectors, dtype=torch.float32).to(dev).contiguous()
    n, d = vectors.shape
    if max_degree is None:
        max_degree = _default_max_degree(n)
    if block is None:
        block = _default_block(n, d)

    neighbors = torch.full((n, max_degree), -1, dtype=torch.int32, device=dev)
    counts = torch.zeros(n, dtype=torch.int32, device=dev)
    for s in range(0, n, block):
        ids_blk = torch.arange(s, min(s + block, n), device=dev)
        kept, cnt = _build_block(vectors, ids_blk, float(delta), rule,
                                 max_degree)
        neighbors[s:s + ids_blk.numel()] = kept
        counts[s:s + ids_blk.numel()] = cnt

    n_overflow = int((counts >= max_degree).sum())
    if n_overflow:
        warnings.warn(
            f"build_exact: {n_overflow}/{n} nodes hit the degree cap "
            f"{max_degree}; the δ-EMG closure may be violated for them.")

    return GraphIndex(vectors=vectors, neighbors=neighbors,
                      medoid=find_medoid(vectors), kind=kind or rule,
                      delta=float(delta))
