"""Implementation-independent correctness oracles for graph ANN search.

Counterpart of ``repro.testing.oracle``, the same three functions in the
same plain numpy, so that ``chip_smoke.py`` can hold the port to the
paper's bound on the card, where the JAX package is absent.

The paper's central claim is *provable*: any greedy search on a δ-EMG
returns a ``(1/δ)``-approximate nearest neighbor, and the adaptive α-stop
rule (Alg. 3) tightens that to ``1/(δ·α)``.  That makes the right test
oracle brute-force exact k-NN **plus the bound itself** — not another
approximate engine.  Engine-vs-engine parity is circular (both engines can
share a bug); the bound is what the theorems guarantee and is checkable
per query against ground truth no search implementation touches.

Everything here is plain numpy on purpose: no torch, no shared kernels,
no shared distance code with the engines under test.  ``exact_knn`` is the
O(n·B·d) ground truth; ``check_delta_bound`` asserts the per-query,
per-rank approximation bound; ``recall_at_k`` is the softer diagnostic
used by non-guaranteed searches (AGS runs on approximate distances, so
only its *rerank* is exact and the δ-bound does not apply verbatim).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def exact_knn(corpus: np.ndarray, queries: np.ndarray, k: int
              ) -> tuple[np.ndarray, np.ndarray]:
    """Brute-force exact k-NN: (dists f64[B, k], ids int64[B, k]).

    Euclidean distances, ascending per row; ties broken by lower id
    (``np.argsort`` kind="stable" over the full row).  float64 throughout
    so the oracle is strictly more precise than the f32 engines it judges.
    """
    corpus = np.asarray(corpus, np.float64)
    queries = np.asarray(queries, np.float64)
    if k < 1 or k > corpus.shape[0]:
        raise ValueError(f"k={k} out of range for corpus of {corpus.shape[0]}")
    d2 = np.sum((queries[:, None, :] - corpus[None, :, :]) ** 2, axis=-1)
    ids = np.argsort(d2, axis=1, kind="stable")[:, :k]
    dists = np.sqrt(np.take_along_axis(d2, ids, axis=1))
    return dists, ids


def check_delta_bound(returned_dists: np.ndarray, oracle_dists: np.ndarray,
                      delta: float, alpha: float = 1.0,
                      atol: float = 1e-4) -> Optional[str]:
    """Per-query, per-rank approximation bound check.

    Asserts ``returned_dists[b, i] ≤ (1 / (δ·α)) · oracle_dists[b, i] + atol``
    for every query b and every rank i < k — the Theorem-1 guarantee (α = 1
    for plain greedy search; pass the search α to use the tighter Alg.-3
    bound, valid only for queries whose adaptive loop actually fired the
    α-rule, i.e. ``saturated=False``).

    Returns ``None`` when the bound holds everywhere, else a human-readable
    description of the worst violation (query, rank, distances, factor) —
    tests ``assert check_delta_bound(...) is None`` so failures print it.

    ``atol`` absorbs f32-vs-f64 noise and the exact-hit case
    (``oracle_dist == 0`` ⇒ the returned dist must also be ~0).
    """
    if not 0.0 < delta:
        raise ValueError(f"delta must be positive, got {delta}")
    ret = np.asarray(returned_dists, np.float64)
    orc = np.asarray(oracle_dists, np.float64)
    if ret.shape != orc.shape:
        raise ValueError(f"shape mismatch: returned {ret.shape} vs "
                         f"oracle {orc.shape}")
    factor = 1.0 / (delta * max(alpha, 1.0))
    limit = factor * orc + atol
    bad = ret > limit
    if not bad.any():
        return None
    excess = np.where(bad, ret - limit, -np.inf)
    b, i = np.unravel_index(np.argmax(excess), excess.shape)
    return (f"δ-bound violated for {int(bad.sum())}/{bad.size} entries; "
            f"worst at query {b} rank {i}: returned {ret[b, i]:.6g} > "
            f"{factor:.4g}·{orc[b, i]:.6g} + {atol:g} "
            f"(ratio {ret[b, i] / max(orc[b, i], 1e-30):.4g}, "
            f"bound factor {factor:.4g})")


def recall_at_k(returned_ids: np.ndarray, oracle_ids: np.ndarray) -> float:
    """Mean fraction of true k-NN ids recovered per query (set overlap)."""
    ret = np.asarray(returned_ids)
    orc = np.asarray(oracle_ids)
    hits = sum(len(set(r.tolist()) & set(o.tolist()))
               for r, o in zip(ret, orc))
    return hits / float(orc.size)
