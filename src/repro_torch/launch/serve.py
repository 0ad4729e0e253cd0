"""ANN serving entry point of the port — builds a δ-EMQG index on the card
and serves a query stream through the batched request loop.

    PYTHONPATH=src python -m repro_torch.launch.serve --n 4000 --dim 48 \\
        --queries 512 --alpha 1.2 --k 10 [--device cuda|cpu] [--metrics]

The single-node path of ``repro.launch.serve``.  ``--resilient``,
``--shards`` and ``--audit`` belong to parts of the system not yet ported
and are refused with a message.  ``--metrics`` attaches the observability
layer and prints Prometheus-text and JSON snapshots after serving.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..core import BuildParams, SearchParams, build_emqg
from ..core.distances import brute_force_knn
from ..data import clustered_vectors
from ..obs import (
    MetricsRegistry,
    Tracer,
    declare_serve_metrics,
    to_json,
    to_prometheus,
)
from ..serve import AnnServer

_NOT_PORTED = ("resilient", "shards", "audit")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--n", type=int, default=4000)
    ap.add_argument("--dim", type=int, default=48)
    ap.add_argument("--queries", type=int, default=512)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--alpha", type=float, default=1.2)
    ap.add_argument("--max-degree", type=int, default=24)
    ap.add_argument("--beam", type=int, default=64)
    ap.add_argument("--delta", type=float, default=None,
                    help="fixed construction δ (default: adaptive δ_t rule)")
    ap.add_argument("--metrics", action="store_true",
                    help="attach the obs layer; print Prometheus-text and "
                         "JSON metric snapshots after serving")
    ap.add_argument("--device", default="cuda",
                    help="torch device for the index and the search "
                         "(default cuda; cpu runs the plain versions)")
    ap.add_argument("--resilient", action="store_true", help="not ported yet")
    ap.add_argument("--shards", type=int, default=0, help="not ported yet")
    ap.add_argument("--audit", action="store_true", help="not ported yet")
    args = ap.parse_args(argv)
    for name in _NOT_PORTED:
        if getattr(args, name):
            ap.error(f"--{name} is not ported to PyTorch yet; run "
                     "`python -m repro.launch.serve` for it")

    # full float32 matrix products (no TF32), as the JAX package computes
    torch.backends.cuda.matmul.allow_tf32 = False
    registry = tracer = None
    if args.metrics:
        registry = declare_serve_metrics(MetricsRegistry())
        tracer = Tracer()

    print(f"[serve] building δ-EMQG over n={args.n} d={args.dim} on "
          f"{args.device} …")
    base = clustered_vectors(args.n, args.dim, 48, seed=0)
    t0 = time.perf_counter()
    idx = build_emqg(base, BuildParams(
        max_degree=args.max_degree, beam_width=args.beam, delta=args.delta,
        t=args.beam // 2, iters=2, block=1024, align_degree=True),
        metrics=registry, device=args.device)
    print(f"[serve] built in {time.perf_counter() - t0:.1f}s "
          f"(mean degree {float(idx.graph.degrees().float().mean()):.1f})")

    queries = clustered_vectors(args.queries, args.dim, 48, seed=1)
    _, gt_i = brute_force_knn(queries, idx.graph.vectors, args.k)
    gt_i = gt_i.cpu().numpy()
    params = SearchParams(k=args.k, l0=args.k, l_max=256, alpha=args.alpha,
                          adaptive=True, max_hops=2048)
    srv = AnnServer(idx, params, max_batch=128, buckets=(32, 128),
                    metrics=registry, tracer=tracer, device=args.device)
    srv.submit_many(queries)
    results = srv.drain()
    ids = np.stack([r[0] for r in results])
    rec = np.mean([len(set(ids[i].tolist()) & set(gt_i[i].tolist())) / args.k
                   for i in range(len(results))])
    print(f"[serve] {srv.stats.n_requests} requests in "
          f"{srv.stats.n_batches} batches; recall@{args.k}={rec:.4f}; "
          f"QPS={srv.stats.qps:.1f} ({idx.device}); "
          f"p_max_latency={srv.stats.max_latency_s * 1e3:.1f} ms")
    if registry is not None:
        print("=== metrics (prometheus text) ===")
        print(to_prometheus(registry), end="")
        print("=== metrics (json) ===")
        print(to_json(registry, tracer))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
