"""Deterministic synthetic data (numpy only).

Copies of ``clustered_vectors`` (an ANN corpus) and of ``MarkovLM``,
``make_markov_lm`` and ``lm_batch`` (a sparse Markov-chain language for
LM prompts) from the JAX package's ``repro.data.synthetic``, so both
packages make the same data from the same seed without the port importing
that package.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def clustered_vectors(n: int, dim: int, n_clusters: int = 64,
                      scale: float = 0.35, noise_frac: float = 0.05,
                      seed: int = 0) -> np.ndarray:
    """Overlapping GMM + uniform noise floor; unit-ish norm spread."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, dim)).astype(np.float32)
    n_noise = int(n * noise_frac)
    asg = rng.integers(0, n_clusters, n - n_noise)
    pts = centers[asg] + scale * rng.normal(size=(n - n_noise, dim))
    noise = rng.normal(size=(n_noise, dim)) * 1.2
    out = np.concatenate([pts, noise]).astype(np.float32)
    rng.shuffle(out)
    return out


@dataclasses.dataclass(frozen=True)
class MarkovLM:
    succ: np.ndarray      # int32[V, branch] successor table
    vocab: int
    branch: int

    def entropy(self) -> float:
        return float(np.log(self.branch))


def make_markov_lm(vocab: int, branch: int = 4, seed: int = 0) -> MarkovLM:
    rng = np.random.default_rng(seed)
    succ = rng.integers(0, vocab, size=(vocab, branch)).astype(np.int32)
    return MarkovLM(succ=succ, vocab=vocab, branch=branch)


def lm_batch(lm: MarkovLM, batch: int, seq: int, step: int,
             seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """→ (tokens int32[batch, seq], targets int32[batch, seq])."""
    rng = np.random.default_rng((seed, step))
    toks = np.empty((batch, seq + 1), np.int32)
    toks[:, 0] = rng.integers(0, lm.vocab, batch)
    choices = rng.integers(0, lm.branch, size=(batch, seq))
    for t in range(seq):
        toks[:, t + 1] = lm.succ[toks[:, t], choices[:, t]]
    return toks[:, :-1], toks[:, 1:]
