"""ANN serving entry point of the port — builds a δ-EMQG index on the card
and serves a query stream through the batched request loop.

    PYTHONPATH=src python -m repro_torch.launch.serve --n 4000 --dim 48 \\
        --queries 512 --alpha 1.2 --k 10 [--device cuda|cpu] [--metrics]

The single-node path of ``repro.launch.serve``.  ``--audit`` runs the
graph-invariant auditor (``core.verify``) on the built index before
serving and exits 1 on a violation.  ``--resilient`` serves the stream
through the resilience layer (admission control, per-request deadlines,
the error-bounded degradation ladder, circuit-breaker fallback —
``serve.resilience``; ``--deadline-ms``, ``--max-queue``, ``--degrade-at``,
``--recover-at``, ``--rungs``) and reports its counters and the worst δ
bound any response was served under.  ``--metrics`` attaches the
observability layer and prints Prometheus-text and JSON snapshots after
serving; ``--metrics-every S`` also prints a one-line stderr summary at
most every S seconds while draining (implies ``--metrics``).
``--shards`` belongs to the sharded index, not yet ported, and is refused
with a message.
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from ..core import BuildParams, SearchParams, build_emqg
from ..core.distances import brute_force_knn
from ..core.types import resolve_device
from ..data import clustered_vectors
from ..kernels import _build
from ..obs import (
    MetricsRegistry,
    PeriodicSummary,
    Tracer,
    declare_serve_metrics,
    to_json,
    to_prometheus,
)
from ..serve import AnnServer, ResilienceConfig, ResilientAnnServer


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
    ap.add_argument("--resilient", action="store_true",
                    help="serve through the resilience layer")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline (resilient mode)")
    ap.add_argument("--max-queue", type=int, default=4096,
                    help="admission-control queue cap (resilient mode)")
    ap.add_argument("--degrade-at", type=int, default=64,
                    help="queue depth that steps the ladder down one rung")
    ap.add_argument("--recover-at", type=int, default=8,
                    help="queue depth that steps the ladder back up")
    ap.add_argument("--rungs", type=int, default=4,
                    help="degradation-ladder depth (resilient mode)")
    ap.add_argument("--audit", action="store_true",
                    help="run the graph-invariant auditor (core.verify) on "
                         "the built index before serving; non-zero exit on "
                         "violations")
    ap.add_argument("--metrics", action="store_true",
                    help="attach the obs layer; print Prometheus-text and "
                         "JSON metric snapshots after serving")
    ap.add_argument("--metrics-every", type=float, default=0.0,
                    help="emit a one-line stderr metrics summary at most "
                         "every S seconds while serving (implies --metrics)")
    ap.add_argument("--device", default="cuda",
                    help="torch device for the index and the search "
                         "(default cuda; cpu runs the plain versions)")
    ap.add_argument("--shards", type=int, default=0, help="not ported yet")
    args = ap.parse_args(argv)
    if args.shards:
        ap.error("--shards is not ported to PyTorch yet (the sharded index, "
                 "ROADMAP A.6); run `python -m repro.launch.serve` for it")

    # full float32 matrix products (no TF32), as the JAX package computes
    torch.backends.cuda.matmul.allow_tf32 = False
    registry = tracer = summary = None
    if args.metrics or args.metrics_every > 0:
        registry = declare_serve_metrics(MetricsRegistry())
        tracer = Tracer()
        summary = PeriodicSummary(registry, args.metrics_every)

    if resolve_device(args.device).type == "cuda":
        # compile every kernel now, so that no nvcc runs in the timed parts
        _build.build_all()
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

    if args.audit:
        from ..core.verify import audit
        rep = audit(idx.graph)
        print(rep.summary())
        if not rep.ok:
            return 1

    queries = clustered_vectors(args.queries, args.dim, 48, seed=1)
    _, gt_i = brute_force_knn(queries, idx.graph.vectors, args.k)
    gt_i = gt_i.cpu().numpy()
    params = SearchParams(k=args.k, l0=args.k, l_max=256, alpha=args.alpha,
                          adaptive=True, max_hops=2048)

    def drive(srv, queries):
        """Submit + drain, chunked when a periodic summary is live so the
        heartbeat can fire between batches of a long replay."""
        if summary is None or summary.every_s <= 0:
            srv.submit_many(queries)
            return srv.drain()
        out = []
        chunk = max(srv.max_batch, 1)
        for s in range(0, len(queries), chunk):
            srv.submit_many(queries[s : s + chunk])
            out.extend(srv.drain())
            summary.tick()
        summary.tick(force=True)
        return out

    if args.resilient:
        cfg = ResilienceConfig(
            max_queue=args.max_queue,
            deadline_s=None if args.deadline_ms is None
            else args.deadline_ms / 1e3,
            degrade_depth=args.degrade_at, recover_depth=args.recover_at,
            n_rungs=args.rungs)
        srv = ResilientAnnServer(idx, params, config=cfg,
                                 max_batch=128, buckets=(32, 128),
                                 metrics=registry, tracer=tracer,
                                 device=args.device)
        responses = drive(srv, queries)
        served = [(i, r) for i, r in enumerate(responses) if r.ok]
        rec = np.mean([
            len(set(r.ids.tolist()) & set(gt_i[i].tolist())) / args.k
            for i, r in served]) if served else 0.0
        worst = max((r.delta_bound for _, r in served), default=math.inf)
        s = srv.stats
        print(f"[serve] {s.n_requests} served / {len(responses)} submitted "
              f"in {s.n_batches} batches; recall@{args.k}={rec:.4f}; "
              f"QPS={s.qps:.1f} ({idx.device}); "
              f"p_max_latency={s.max_latency_s * 1e3:.1f} ms")
        print(f"[serve] resilience: shed={s.n_shed} rejected={s.n_rejected} "
              f"degraded={s.n_degraded} retried={s.n_retried} "
              f"fallback={s.n_fallback} deadline_missed={s.n_deadline_missed} "
              f"failed={s.n_failed}; worst δ bound="
              f"{worst if math.isfinite(worst) else 'unbounded (δ unknown)'}")
        _dump_metrics(registry, tracer)
        return 0

    srv = AnnServer(idx, params, max_batch=128, buckets=(32, 128),
                    metrics=registry, tracer=tracer, device=args.device)
    results = drive(srv, queries)
    ids = np.stack([r[0] for r in results])
    rec = np.mean([len(set(ids[i].tolist()) & set(gt_i[i].tolist())) / args.k
                   for i in range(len(results))])
    print(f"[serve] {srv.stats.n_requests} requests in "
          f"{srv.stats.n_batches} batches; recall@{args.k}={rec:.4f}; "
          f"QPS={srv.stats.qps:.1f} ({idx.device}); "
          f"p_max_latency={srv.stats.max_latency_s * 1e3:.1f} ms")
    _dump_metrics(registry, tracer)
    return 0


def _dump_metrics(registry, tracer) -> None:
    if registry is None:
        return
    print("=== metrics (prometheus text) ===")
    print(to_prometheus(registry), end="")
    print("=== metrics (json) ===")
    print(to_json(registry, tracer))


if __name__ == "__main__":
    raise SystemExit(main())
