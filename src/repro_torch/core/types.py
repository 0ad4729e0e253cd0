"""Index and result types for the PyTorch port of δ-EMG / δ-EMQG.

Counterpart of ``repro.core.types``.  Index structures are frozen
dataclasses of tensors that live on one device; hyper-parameters that the
JAX package kept static (``kind``, ``delta``, ``dim``) are plain fields.

Conventions (the same as the JAX package):

* Neighbor lists are fixed-width ``int32[n, M]`` padded with ``INVALID_ID``.
* Distances are squared Euclidean internally; public results report true
  distances.
* ``INVALID_ID = -1``; invalid slots always carry ``+inf`` distance.
* RaBitQ codes are ``uint32`` words in the JAX package.  This port carries
  the same bit patterns as an ``int32`` view (PyTorch has few ``uint32``
  ops): bit ``j`` of word ``w`` is dimension ``32*w + j``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

INVALID_ID = -1


def resolve_device(device) -> torch.device:
    """``torch.device`` for an entry point's ``device=`` argument.

    A CUDA device without a visible card raises: the port never drops to the
    CPU on its own.  Pass ``device="cpu"`` to run on the host.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the host")
    return dev


@dataclasses.dataclass(frozen=True)
class GraphIndex:
    """A proximity graph over a vector dataset.

    vectors:   ``f32[n, d]`` contiguous base dataset.
    neighbors: ``int32[n, M]`` fixed-width adjacency, padded with -1.
    medoid:    default entry point (a Python int).
    kind:      reporting tag ("delta_emg_approx", "delta_emqg", ...).
    delta:     the construction δ (0 for the adaptive rule).
    """

    vectors: torch.Tensor
    neighbors: torch.Tensor
    medoid: int
    kind: str = "delta_emg"
    delta: float = 0.0

    @property
    def n(self) -> int:
        return self.vectors.shape[0]

    @property
    def dim(self) -> int:
        return self.vectors.shape[1]

    @property
    def max_degree(self) -> int:
        return self.neighbors.shape[1]

    @property
    def device(self) -> torch.device:
        return self.vectors.device

    def degrees(self) -> torch.Tensor:
        return (self.neighbors >= 0).sum(dim=1)


@dataclasses.dataclass(frozen=True)
class RaBitQCodes:
    """RaBitQ 1-bit-per-dimension quantization state.

    codes:    ``int32[n, ceil(d/32)]`` sign bits of the rotated, centred
              vectors (the JAX package's ``uint32`` words, bit for bit).
    norms:    ``f32[n]``  ‖v − c‖.
    ip_xo:    ``f32[n]``  ⟨x̄, o⟩.
    rotation: ``f32[d, d]`` the shared orthogonal matrix P.
    center:   ``f32[d]``  the shared centroid c.
    """

    codes: torch.Tensor
    norms: torch.Tensor
    ip_xo: torch.Tensor
    rotation: torch.Tensor
    center: torch.Tensor
    dim: int = 0

    @property
    def n(self) -> int:
        return self.codes.shape[0]

    @property
    def words(self) -> int:
        return self.codes.shape[1]


@dataclasses.dataclass(frozen=True)
class EMQGIndex:
    """δ-EMQG = δ-EMG graph + RaBitQ codes (Sec. 6 of the paper)."""

    graph: GraphIndex
    codes: RaBitQCodes

    @property
    def n(self) -> int:
        return self.graph.n

    @property
    def dim(self) -> int:
        return self.graph.dim

    @property
    def device(self) -> torch.device:
        return self.graph.device


@dataclasses.dataclass(frozen=True)
class SearchResult:
    """Batched search output; the same fields and meaning as the JAX
    package's ``SearchResult`` (ids/dists ``[B, k]`` ascending true
    distances, per-query ``int32[B]`` counters, ``bool[B]`` saturated)."""

    ids: torch.Tensor
    dists: torch.Tensor
    n_dist_comps: torch.Tensor
    n_approx_comps: torch.Tensor
    n_hops: torch.Tensor
    final_l: torch.Tensor
    saturated: torch.Tensor
    n_encounters: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class SearchParams:
    """Search hyper-parameters (frozen and hashable)."""

    k: int = 10
    l0: int = 16          # initial candidate width (≥ k)
    l_max: int = 128      # buffer capacity / adaptive cap
    l_step: int = 1       # adaptive growth per outer round
    alpha: float = 1.0    # α stop rule (Alg. 3); 1.0 = greedy
    adaptive: bool = False  # False → Alg. 1, True → Alg. 3
    max_hops: int = 512   # hard iteration cap
    beam_width: int = 1   # frontier nodes expanded per hop (W)


def take_rows(mat: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Gather rows with INVALID_ID-safe indexing (invalid → row 0, caller
    masks)."""
    return mat[ids.clamp_min(0).long()]


def stable_topk_smallest(x: torch.Tensor, k: int):
    """(values, indices) of the ``k`` smallest entries along the last axis,
    ascending, with the lower index winning a tie.

    This is the order ``jax.lax.top_k(-x, k)`` gives, which the lock-step
    engines rely on to keep masked queries frozen; ``torch.topk`` does not
    promise it, so sort stably and slice.
    """
    vals, idx = torch.sort(x, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def topk_smallest(dists: torch.Tensor, ids: torch.Tensor, k: int):
    """Return the k smallest (dist, id) pairs, ascending, along the last
    axis (stable: the lower position wins a tie)."""
    vals, idx = stable_topk_smallest(dists, k)
    return vals, torch.gather(ids, -1, idx)
