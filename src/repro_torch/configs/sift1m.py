"""sift1m — the paper's own flagship configuration: a δ-EMQG index over a
SIFT-like corpus (n=1M, d=128) served with the error-bounded probing
search.  Build params follow Sec. 7 (L=1000, M=64, I=3); search uses
k ∈ {1, 10, 100} with α sweeps.

Its shapes are serving batches: each is one call of the quantized local
probing search and the exact all-gather top-k merge over the index's
shards (``launch.steps.ann_serve``), 4,096 queries (``serve_batch``) or
256 (``serve_online``).  On one card the index is one shard.
"""

from repro_torch.configs.base import ArchSpec, ShapeSpec, register
from repro_torch.core import BuildParams, SearchParams

ARCH = register(ArchSpec(
    id="sift1m",
    family="ann",
    model_cfg={
        "n": 1_000_000,
        "dim": 128,
        "build": BuildParams(max_degree=64, beam_width=1000, t=64, iters=3,
                             align_degree=True),
        "search": SearchParams(k=10, l0=10, l_max=512, alpha=1.2,
                               adaptive=True, max_hops=4096),
    },
    shapes={
        "serve_batch": ShapeSpec("serve_batch", "ann_serve",
                                 {"batch": 4096, "k": 10}),
        "serve_online": ShapeSpec("serve_online", "ann_serve",
                                  {"batch": 256, "k": 10}),
    },
    source="ANN-Benchmarks SIFT1M (paper Sec. 7)",
    smoke_cfg={
        "n": 2000,
        "dim": 32,
        "build": BuildParams(max_degree=16, beam_width=32, t=8, iters=2),
        "search": SearchParams(k=10, l0=10, l_max=64, alpha=1.3,
                               adaptive=True, max_hops=512),
    },
))
