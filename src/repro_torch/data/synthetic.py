"""Deterministic synthetic vector corpora (numpy only).

A copy of ``clustered_vectors`` from the JAX package's
``repro.data.synthetic``, so both packages make the same corpus from the
same seed without the port importing that package.
"""

from __future__ import annotations

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
