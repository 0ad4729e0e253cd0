"""Unified observability layer: metrics registry, span tracing, exporters.

A copy of the JAX package's ``repro.obs`` (stdlib only), so the port
imports nothing of that package.  The server (``repro_torch.serve``) and
the builder (``core.build_approx``) observe into the same registry types,
so "what does a request cost" has a single answer with a single bucket
math.  ``record_search_result`` moves tensor counters to the host first.

Metric taxonomy (names are stable API — the README documents them):

======================================  =========  ==============================
name                                    kind       meaning
======================================  =========  ==============================
serve_request_latency_seconds           histogram  submit → response, monotonic
serve_queue_wait_seconds                histogram  submit → batch dispatch
serve_batch_execute_seconds             histogram  device search per batch
serve_batch_size                        histogram  requests per dispatched batch
serve_responses_total{status}           counter    ok/rejected/shed/deadline/failed
serve_degradation_transitions_total
  {direction,rung}                      counter    ladder steps (event: bound)
serve_breaker_transitions_total
  {from,to}                             counter    circuit-breaker tier moves
serve_rung                              gauge      current ladder rung
search_dist_comps_total                 counter    exact distance evals (Exp-5)
search_approx_comps_total               counter    quantized evals (δ-EMQG)
search_hops_total                       counter    expansions
search_encounters_total                 counter    pre-dedup candidate encounters
search_saturated_total                  counter    queries whose adaptive l capped
search_final_l                          histogram  per-query final beam length
shard_live{shard}                       gauge      1 = some replica live
shard_coverage                          gauge      live logical shards / S
shard_failover                          gauge      shards served by non-primary
shard_heartbeat_age_seconds{shard}      gauge      min age over live replicas
shard_replica_heartbeat_age_seconds
  {shard,replica}                       gauge      raw per-slot heartbeat age
shard_marked_dead_total                 counter    health-checker kills
repair_started_total                    counter    repair attempts begun
repair_succeeded_total                  counter    verified installs completed
repair_failed_total                     counter    contained repair failures
shard_under_repair{shard}               gauge      1 from first attempt→success
repair_duration_seconds                 histogram  successful repair wall time
wal_append_seconds                      histogram  journal record commit
wal_fsync_seconds                       histogram  fsync inside atomic writes
wal_records_total{op}                   counter    committed journal records
checkpoint_save_seconds                 histogram  full snapshot commit
checkpoint_restore_seconds              histogram  recover() restore+replay
build_phase_seconds{phase}              histogram  builder phase wall time
build_nodes_total                       counter    nodes processed by the builder
======================================  =========  ==============================

Span taxonomy: ``serve.request`` (child ``serve.queue_wait``) per request;
``serve.batch`` per dispatched batch with children ``serve.batch_form``,
``serve.device_execute`` (children ``shard{shard,live}`` under sharded
fan-out) and ``serve.merge``.

The search and the build take ``tracer=None`` (without one they make no
span, launch nothing more and wait for nothing):

======================  ================================================
span {attributes}       covers
======================  ================================================
ann.call                ``make_sharded_search``'s ``run`` (and
  {queries,shards}      ``launch.steps.ann_serve``'s call)
search.lockstep {rows}  ``_lockstep_search``: the stack, the query
                        contexts, the start's distance, the loop (S·B rows)
probe.iter              one pass of ``_beam_probing_batch``; ``active``,
  {i,rows,active}       the rows still searching, read in the pass's one
                        sync (the last pass reads 0 and ends the loop)
probe.sync              the pass's host sync, first in the pass
probe.select            NeedProbing and a branch's top-W select (twice a
                        pass: the probe branch, then the expand branch)
probe.exact             the exact distances of the W probed ids
probe.dedup             neighbour gather, bitset test, per-row unique
probe.estimate          the RaBitQ estimates (``fused_estimate``)
probe.merge             the two ``batch_merge_topc``
probe.transition        ``adaptive_transition`` and the counters
search.merge            the lists' masking and the top-k merge
build {n}               one ``build_approx`` / ``build_emqg``
build.bootstrap         medoid and brute-force k-NN graph
build.refine {iter}     a refinement: ``build.search`` (the beam searches)
                        and ``build.select`` (dedup, re-rank, select) a
                        block
build.repair {iter}     reverse edges and connectivity (``iter`` "align"
                        after the degree alignment)
build.align             the degree alignment
build.quantize          the RaBitQ codes (``build_emqg``)
======================  ================================================

A build span closes after the device is synchronised, so it holds the
device work it enqueued; the phase events' ``elapsed_s`` is then read the
same way (with a tracer, the spans' durations).  A search span is host
time only.  ``make_sharded_search``'s ``stats`` dict receives
``iterations``, the loop's passes with a row still searching (one
``fused_estimate`` launch each on a card), a host count that costs
nothing.  ``Tracer.n_dropped`` counts the spans the ring pushed out;
``Tracer.anchors`` pairs ``time.perf_counter_ns()`` with ``time.time_ns()``
(at construction and at each export), which maps spans onto a profiler's
Unix-epoch timeline (``perfbench/pbench/spans.py``).

Everything here is stdlib-only and observation-only: enabling metrics can
not change search results (pinned bit-identical by ``tests/test_obs.py``).
"""

from .exporters import (  # noqa: F401
    PeriodicSummary,
    snapshot,
    summary_line,
    to_json,
    to_prometheus,
)
from .metrics import (  # noqa: F401
    DEFAULT_LATENCY_BUCKETS_S,
    DEFAULT_WORK_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    Timer,
)
from .tracing import Span, Tracer, maybe_span  # noqa: F401


def declare_serve_metrics(registry: MetricsRegistry,
                          n_shards: int = 1) -> MetricsRegistry:
    """Pre-register the full serve taxonomy so exports have a stable schema
    from the first scrape (families exist with zero samples before the
    first request arrives — standard exporter practice)."""
    registry.histogram("serve_request_latency_seconds",
                       help="submit-to-response latency (monotonic clock)")
    registry.histogram("serve_queue_wait_seconds",
                       help="submit-to-dispatch queue wait")
    registry.histogram("serve_batch_execute_seconds",
                       help="device search time per batch")
    registry.histogram("serve_batch_size", buckets=DEFAULT_WORK_BUCKETS,
                       help="requests per dispatched batch")
    for status in ("ok", "rejected", "shed", "deadline", "failed"):
        registry.counter("serve_responses_total", {"status": status},
                         help="responses by terminal status")
    registry.counter("serve_degradation_transitions_total",
                     {"direction": "down", "rung": "1"},
                     help="degradation-ladder transitions")
    registry.gauge("serve_rung", help="current degradation-ladder rung")
    registry.counter("search_dist_comps_total",
                     help="exact distance evaluations (Exp-5 metric)")
    registry.counter("search_approx_comps_total",
                     help="quantized distance evaluations")
    registry.counter("search_hops_total", help="search expansions")
    registry.counter("search_encounters_total",
                     help="pre-dedup candidate encounters")
    registry.counter("search_saturated_total",
                     help="queries whose adaptive l hit the cap")
    registry.histogram("search_final_l", buckets=DEFAULT_WORK_BUCKETS,
                       help="per-query final beam length")
    registry.gauge("shard_coverage",
                   help="live logical shards / total").set(1.0)
    registry.gauge("shard_failover",
                   help="shards served by a non-primary replica")
    for s in range(n_shards):
        registry.gauge("shard_live", {"shard": s},
                       help="1 if some replica of the shard is live").set(1.0)
    registry.counter("shard_marked_dead_total",
                     help="shards auto-killed by the health checker")
    registry.counter("repair_started_total",
                     help="shard repair attempts begun")
    registry.counter("repair_succeeded_total",
                     help="shard repairs verified and installed")
    registry.counter("repair_failed_total",
                     help="shard repair attempts that failed (will retry)")
    registry.histogram("repair_duration_seconds",
                       help="wall time of successful shard repairs")
    registry.histogram("wal_append_seconds",
                       help="WAL record commit (payload+manifest)")
    registry.histogram("wal_fsync_seconds",
                       help="fsync inside atomic WAL/meta writes")
    registry.histogram("checkpoint_save_seconds",
                       help="full snapshot commit")
    registry.histogram("checkpoint_restore_seconds",
                       help="recover(): restore + WAL replay")
    return registry


def record_search_result(registry: MetricsRegistry, res,
                         n_live: int = None) -> None:
    """Aggregate one batch's device-side ``SearchResult`` counters into
    host-side metrics.  ``n_live`` restricts the aggregation to the first
    ``n_live`` rows (padded rows repeat the last real query — counting them
    would double-bill the pad).  Read-only on ``res``.
    """
    import numpy as np  # deferred: keep this package importable stdlib-only

    def rows(x):
        # a tensor (possibly on the card) comes to the host first; numpy
        # cannot read device memory
        if hasattr(x, "detach"):
            x = x.detach().cpu().numpy()
        a = np.asarray(x)
        return a[:n_live] if n_live is not None else a

    registry.counter("search_dist_comps_total").inc(
        float(rows(res.n_dist_comps).sum()))
    registry.counter("search_hops_total").inc(float(rows(res.n_hops).sum()))
    if getattr(res, "n_approx_comps", None) is not None:
        registry.counter("search_approx_comps_total").inc(
            float(rows(res.n_approx_comps).sum()))
    if getattr(res, "n_encounters", None) is not None:
        registry.counter("search_encounters_total").inc(
            float(rows(res.n_encounters).sum()))
    registry.counter("search_saturated_total").inc(
        float(rows(res.saturated).sum()))
    fl = registry.histogram("search_final_l", buckets=DEFAULT_WORK_BUCKETS)
    for v in rows(res.final_l).tolist():
        fl.observe(float(v))
