"""MIPS → L2 reduction for inner-product retrieval over a δ-EMG.

Counterpart of ``repro.core.mips``.  Items are augmented with one extra
coordinate so that the index's min-L2 answer is the max-inner-product one
(Bachrach et al. 2014):

    φ(v) = [v, √(R² − ‖v‖²)]      R = max‖v‖   (items)
    ψ(u) = [u, 0]                                (queries)

    ‖ψ(u) − φ(v)‖² = ‖u‖² + R² − 2⟨u, v⟩  →  argmin L2 ≡ argmax IP

At d = 128 the augmented width is 129: four full RaBitQ code words and a
fifth that holds one bit, and a ragged row for the exact tier's gather-L2.
The augmentation is numpy, as in the JAX package; the index lives on the
device ``build_mips`` is given.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .build_approx import BuildParams, build_approx
from .emqg import build_emqg
from .probing import error_bounded_probing_search
from .search import error_bounded_search
from .types import EMQGIndex, GraphIndex, SearchResult


@dataclasses.dataclass
class MIPSIndex:
    index: GraphIndex | EMQGIndex
    radius: float                 # R = max ‖v‖
    dim: int                      # original dimensionality

    @property
    def quantized(self) -> bool:
        return isinstance(self.index, EMQGIndex)


def augment_items(items: np.ndarray) -> tuple[np.ndarray, float]:
    items = np.asarray(items, np.float32)
    norms2 = (items ** 2).sum(-1)
    R2 = float(norms2.max())
    extra = np.sqrt(np.maximum(R2 - norms2, 0.0))[:, None]
    return np.concatenate([items, extra], axis=1), float(np.sqrt(R2))


def augment_queries(queries: np.ndarray) -> np.ndarray:
    queries = np.asarray(queries, np.float32)
    return np.concatenate(
        [queries, np.zeros((queries.shape[0], 1), np.float32)], axis=1)


def build_mips(items: np.ndarray, params: Optional[BuildParams] = None,
               quantized: bool = False, device="cuda") -> MIPSIndex:
    """A δ-EMG (or, ``quantized``, a δ-EMQG with codes under a rotation
    drawn from ``params.seed``) over the augmented items, on ``device``."""
    aug, R = augment_items(items)
    params = params or BuildParams()
    idx = build_emqg(aug, params, device=device) if quantized \
        else build_approx(aug, params, device=device)
    return MIPSIndex(index=idx, radius=R, dim=items.shape[1])


def mips_search(mips: MIPSIndex, queries: np.ndarray, k: int,
                alpha: float = 1.2, l_max: int = 256,
                backend: str = "auto") -> SearchResult:
    """Top-k by inner product (ids are item rows; dists are the reduced-L2
    distances — convert with ``ip_from_l2`` if scores are needed).
    ``backend`` selects the distance implementations, as in ``search`` and
    ``probing_search``."""
    aug_q = augment_queries(queries)
    if mips.quantized:
        return error_bounded_probing_search(mips.index, aug_q, k=k,
                                            alpha=alpha, l_max=l_max,
                                            backend=backend)
    return error_bounded_search(mips.index, aug_q, k=k, alpha=alpha,
                                l_max=l_max, backend=backend)


def ip_from_l2(queries: np.ndarray, l2_dists, radius: float) -> np.ndarray:
    """⟨u, v⟩ = (‖u‖² + R² − d²)/2 — recover scores from reduced distances
    (a tensor or an array)."""
    if isinstance(l2_dists, torch.Tensor):
        l2_dists = l2_dists.cpu().numpy()
    q2 = (np.asarray(queries, np.float32) ** 2).sum(-1, keepdims=True)
    d2 = np.asarray(l2_dists) ** 2
    return (q2 + radius ** 2 - d2) / 2.0
