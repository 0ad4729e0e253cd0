"""Resilience layer for ANN serving: admission control, per-request
deadlines, an error-bounded degradation ladder, and failure containment.

Counterpart of ``repro.serve.resilience``: the same layers, statuses,
counters and transition events, in front of the port's ``AnnServer``;
``ShardedResilientAnnServer`` fronts a ``core.distributed.ShardedIndex``
(the two exact merges as its breaker chain, shard death reported per
response, self-repair from a ``core.repair.ShardVectorStore``).

δ-EMG makes *principled* degradation possible.  A recall-tuned index that
shrinks its search budget under load returns arbitrarily bad results; a
δ-monotonic graph does not — any greedy search converges to a
``(1/δ)``-approximate neighbor, and the adaptive α-stop rule (Alg. 3)
tightens that to ``1/(δ·α)``.  So the ladder here trades *bound* for
*latency* along a known curve: each rung steps ``l_max`` / ``beam_width``
down and relaxes the adaptive δ-target (α → 1) under queue pressure, and
every response reports the approximation factor it was served under.

Containment layers, outermost first:

1. **Admission control** — ``submit`` sheds requests beyond ``max_queue``
   (terminal ``status="shed"`` response, never an exception).
2. **Per-request validation** — shape/dtype/NaN/Inf checks reject a bad
   query *individually* instead of poisoning its whole batch.
3. **Deadlines** — requests already past their deadline at dispatch are
   answered with ``status="deadline"`` instead of burning search budget;
   requests that complete late are flagged ``deadline_missed``.
4. **Retry with backoff** — transient search faults are retried on the
   same tier before the breaker reacts.
5. **Circuit breaker** — repeated faults open the tier and fall back down
   the chain ``beam/auto → beam/jnp → beam/jnp/w1`` where ``auto`` is
   itself the plain PyTorch path (an index on the CPU), each switch
   counted in ``n_fallback`` and ``serve_breaker_transitions_total``;
   after a cooldown the tier is probed again (half-open) and closes on
   success.  The chain bottoms out at ``beam/jnp/w1`` — greedy best-first
   on the same lock-step engine, the minimal configuration that still
   carries the ``1/(δ·α)`` guarantee.  On the card ``auto`` is the CUDA
   kernels and the chain is that one tier: a kernel that fails is retried
   and then fails its batch, it is never answered by the plain version.
   Exhausting every tier raises ``SearchFailure`` inside the containment,
   which ``drain()`` converts to per-request ``status="failed"``
   responses — never a crash, and never a hidden fallback.

Everything is single-threaded and deterministically testable: the breaker
takes an injectable clock and the fault harness (``testing.faults``)
wraps the one seam every batch passes through (``AnnServer._search``).

Observability (``metrics=`` / ``tracer=``, inherited from ``AnnServer``):
on top of the base serve taxonomy, the resilience layer emits *structured
transition events* — every degradation-ladder step records
``serve_degradation_transition`` (rung, direction, queue-depth reason, and
the ``1/(δ·α)`` bound now in force) and every circuit-breaker tier move
records ``serve_breaker_transition`` (from/to tier) — alongside labeled
counters (``serve_degradation_transitions_total{direction,rung}``,
``serve_breaker_transitions_total{from,to}``) and a ``serve_rung`` gauge,
so the blind spots the ad-hoc ``ServeStats`` totals left (when did we
degrade, why, under what bound) are first-class telemetry.  All clocks are
monotonic (``obs.Timer``); deadlines are absolute ``perf_counter``
instants.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch

from ..core import EMQGIndex, SearchParams, SearchResult
from ..obs import Timer

from .ann_server import AnnServer, _Request


# ---------------------------------------------------------------------------
# Per-request validation.
# ---------------------------------------------------------------------------


def validate_query(query, dim: int) -> Optional[str]:
    """Return a rejection reason, or None if the query is servable."""
    try:
        q = np.asarray(query)
    except Exception as e:                      # ragged / unconvertible input
        return f"unconvertible query: {e}"
    if q.dtype == object:
        return f"unconvertible query dtype: {q.dtype}"
    if not (np.issubdtype(q.dtype, np.floating)
            or np.issubdtype(q.dtype, np.integer)):
        return f"non-numeric query dtype: {q.dtype}"
    if q.ndim != 1:
        return f"expected a rank-1 query, got shape {q.shape}"
    if q.shape[0] != dim:
        return f"query dim {q.shape[0]} != index dim {dim}"
    if not np.all(np.isfinite(q)):
        return "query contains non-finite values (NaN/Inf)"
    return None


# ---------------------------------------------------------------------------
# Error-bounded degradation ladder.
# ---------------------------------------------------------------------------


class DegradationLadder:
    """Rungs of ``SearchParams`` from full quality (rung 0) down.

    Rung ``r`` halves ``l_max`` (floor ``k``) and ``beam_width`` (floor 1)
    per step and, for adaptive search, decays the α margin toward 1
    (``α_r = 1 + (α₀−1)·2^{−r}`` — α→1 stops the adaptive widening sooner,
    i.e. relaxes the δ-target).  ``delta_bound(r)`` is the approximation
    factor the paper guarantees for that rung: returned distances are
    within ``1/(δ·α_r)`` of the true k-NN distance (``1/δ`` for
    non-adaptive greedy search), finite whenever the construction δ is
    known — which is exactly what makes shedding *quality* safer than
    shedding *requests* on this index family.
    """

    def __init__(self, base: SearchParams, delta: float, n_rungs: int = 4):
        if n_rungs < 1:
            raise ValueError(f"n_rungs must be ≥ 1, got {n_rungs}")
        self.delta = float(delta)
        self._rungs: list[SearchParams] = []
        for r in range(n_rungs):
            l_max = max(base.k, base.l_max >> r)
            self._rungs.append(dataclasses.replace(
                base,
                l_max=l_max,
                l0=min(base.l0, l_max),
                beam_width=max(1, base.beam_width >> r),
                alpha=1.0 + (base.alpha - 1.0) * (0.5 ** r)
                if base.adaptive else base.alpha,
            ))

    def __len__(self) -> int:
        return len(self._rungs)

    def params(self, rung: int) -> SearchParams:
        return self._rungs[min(max(rung, 0), len(self._rungs) - 1)]

    def delta_bound(self, rung: int) -> float:
        """Approximation factor at ``rung``; ``inf`` if δ is unknown (≤ 0)."""
        if self.delta <= 0.0:
            return math.inf
        p = self.params(rung)
        alpha = p.alpha if p.adaptive else 1.0
        return 1.0 / (self.delta * max(alpha, 1.0))


# ---------------------------------------------------------------------------
# Circuit breaker over (backend, beam width) tiers of the beam engine.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Tier:
    backend: str
    beam_width: Optional[int] = None    # pin W for this tier (None → ladder's)
    engine: str = "beam"                # "sharded": backend names the merge
    failures: int = 0
    open_until: float = 0.0

    @property
    def name(self) -> str:
        base = f"{self.engine}/{self.backend}"
        return base if self.beam_width is None else f"{base}/w{self.beam_width}"


class CircuitBreaker:
    """Fall-back chain of search tiers with per-tier failure tracking.

    A tier is CLOSED while its consecutive-failure count is below
    ``threshold``; at the threshold it OPENs for ``cooldown_s`` and
    ``current()`` moves down the chain.  After the cooldown the tier is
    HALF_OPEN: it is offered again, a success closes it (count reset), a
    failure re-opens it for another cooldown.  The last tier never opens —
    the server always has *something* to run a batch on.
    """

    def __init__(self, tiers: list[tuple], threshold: int = 3,
                 cooldown_s: float = 30.0, clock=time.monotonic):
        if not tiers:
            raise ValueError("breaker needs at least one tier")
        self.tiers = [_Tier(*t) for t in tiers]
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self.clock = clock

    def current(self) -> tuple[int, _Tier]:
        now = self.clock()
        for i, t in enumerate(self.tiers):
            if t.failures < self.threshold or now >= t.open_until:
                return i, t
        return len(self.tiers) - 1, self.tiers[-1]

    def record_success(self, i: int) -> None:
        self.tiers[i].failures = 0
        self.tiers[i].open_until = 0.0

    def record_failure(self, i: int) -> None:
        t = self.tiers[i]
        t.failures += 1
        if t.failures >= self.threshold:
            t.open_until = self.clock() + self.cooldown_s


def default_tiers(backend: str, device) -> list[tuple]:
    """``(backend, beam_width)`` tiers of the beam engine, ``None`` for the
    ladder's W.  On the card a kernel backend is the only tier: past its
    retries the batch fails (``SearchFailure``), the plain version never
    answers for a kernel.  Elsewhere, as in the JAX package: the primary
    tier, then the plain ``jnp`` path, then ``(jnp, W=1)`` — greedy
    best-first, the minimal tier that still carries the δ-EMG bound."""
    if torch.device(device).type == "cuda" and backend != "jnp":
        return [(backend, None)]
    chain = [(backend, None)]
    if backend != "jnp":
        chain.append(("jnp", None))
    chain.append(("jnp", 1))
    return list(dict.fromkeys(chain))


# ---------------------------------------------------------------------------
# The resilient server.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    max_queue: int = 4096               # admission control: shed beyond this
    deadline_s: Optional[float] = None  # default per-request deadline
    degrade_depth: int = 64             # queue depth that trips one rung down
    recover_depth: int = 8              # queue depth that climbs one rung up
    n_rungs: int = 4
    max_retries: int = 2                # per batch, before declaring failure
    backoff_s: float = 0.02             # base retry backoff (doubles per try)
    backoff_cap_s: float = 1.0
    breaker_threshold: int = 3          # consecutive faults to open a tier
    breaker_cooldown_s: float = 30.0
    delta: Optional[float] = None       # override index δ for bound reporting


@dataclasses.dataclass
class Response:
    """Per-request outcome.  ``status``:

    * ``ok``       — served; ``ids``/``dists`` valid, ``delta_bound`` is the
      approximation factor of the rung it was served at (``saturated=True``
      marks queries whose adaptive ``l`` hit the cap — bound caveat, see
      ``SearchResult``).
    * ``rejected`` — failed per-request validation (``error`` says why).
    * ``shed``     — refused by admission control (queue full).
    * ``deadline`` — dropped at dispatch, already past its deadline.
    * ``failed``   — every tier/retry exhausted (``error`` has the fault).
    """

    seq: int
    status: str
    ids: Optional[np.ndarray] = None
    dists: Optional[np.ndarray] = None
    rung: int = 0
    delta_bound: float = math.inf
    tier: str = ""
    saturated: bool = False
    deadline_missed: bool = False
    latency_s: float = 0.0
    error: Optional[str] = None
    # -- shard coverage accounting (1.0 / 0 on single-node serving) ----------
    coverage: float = 1.0               # live logical shards / S
    max_missed: int = 0                 # worst-case true neighbors lost

    @property
    def ok(self) -> bool:
        return self.status == "ok"


@dataclasses.dataclass
class _RRequest(_Request):
    deadline_t: float = math.inf        # wall-clock absolute deadline


class SearchFailure(RuntimeError):
    """Raised internally when a batch exhausts every tier and retry."""


class ResilientAnnServer(AnnServer):
    """``AnnServer`` wrapped in the containment layers (module docstring).

    ``drain()`` returns ``list[Response]`` in submission order — terminal
    responses (rejected / shed / deadline) included, so trace replays get
    one response per submitted request, crash-free by construction.
    """

    def __init__(self, index, params: SearchParams, *,
                 config: ResilienceConfig = ResilienceConfig(),
                 clock=time.monotonic, **kw):
        super().__init__(index, params, **kw)
        self.config = config
        graph = index.graph if isinstance(index, EMQGIndex) else index
        delta = config.delta if config.delta is not None \
            else float(getattr(graph, "delta", 0.0))
        self.ladder = DegradationLadder(params, delta, config.n_rungs)
        self.breaker = CircuitBreaker(
            default_tiers(self.backend, self.index.device),
            threshold=config.breaker_threshold,
            cooldown_s=config.breaker_cooldown_s, clock=clock)
        self.rung = 0
        self._done: list[Response] = []
        self._last_tier: Optional[int] = None
        self._last_result = None            # full SearchResult of last batch
        self._last_coverage: float = 1.0
        self._last_max_missed: int = 0

    # -- request path -------------------------------------------------------
    def submit(self, query,
               deadline_s: Optional[float] = None) -> Optional[Response]:
        """Queue a request.  Returns the terminal ``Response`` immediately if
        it was rejected or shed (also delivered again by ``drain()``), else
        ``None`` — the result arrives from ``drain()``."""
        wall = Timer.now()
        seq = self._seq
        self._seq += 1
        reason = validate_query(query, self.index.dim)
        if reason is not None:
            self.stats.n_rejected += 1
            if self.metrics is not None:
                self.metrics.counter("serve_responses_total",
                                     {"status": "rejected"}).inc()
            resp = Response(seq=seq, status="rejected", error=reason)
            self._done.append(resp)
            return resp
        if len(self._queue) >= self.config.max_queue:
            self.stats.n_shed += 1
            if self.metrics is not None:
                self.metrics.counter("serve_responses_total",
                                     {"status": "shed"}).inc()
            resp = Response(seq=seq, status="shed",
                            error=f"queue full ({self.config.max_queue})")
            self._done.append(resp)
            return resp
        deadline_s = deadline_s if deadline_s is not None \
            else self.config.deadline_s
        self._queue.append(_RRequest(
            wall_t=wall, query=np.asarray(query, np.float32), seq=seq,
            deadline_t=wall + deadline_s if deadline_s is not None
            else math.inf))
        return None

    # -- degradation ladder --------------------------------------------------
    def _adjust_rung(self, depth: int) -> None:
        old = self.rung
        if depth > self.config.degrade_depth:
            self.rung = min(self.rung + 1, len(self.ladder) - 1)
        elif depth < self.config.recover_depth:
            self.rung = max(self.rung - 1, 0)
        if self.metrics is not None and self.rung != old:
            direction = "down" if self.rung > old else "up"
            self.metrics.counter(
                "serve_degradation_transitions_total",
                {"direction": direction, "rung": str(self.rung)}).inc()
            self.metrics.event(
                "serve_degradation_transition",
                from_rung=old, rung=self.rung, direction=direction,
                reason=f"queue_depth={depth}",
                delta_bound=self.ladder.delta_bound(self.rung))
            self.metrics.gauge("serve_rung").set(self.rung)

    # -- failure containment around the hot path -----------------------------
    def _search_contained(self, qs: np.ndarray, params: SearchParams):
        """One batch through retry + breaker.  Returns (result, tier_name)
        with host arrays (a kernel's asynchronous error surfaces in the copy
        to the host, inside the containment), or raises
        ``SearchFailure``."""
        cfg = self.config
        last_err: Optional[BaseException] = None
        # Budget enough attempts to walk the whole fallback chain even when
        # every upper tier must first fail its way to OPEN — a batch should
        # only fail once the *last* tier has genuinely been exhausted.
        attempts = cfg.max_retries + \
            cfg.breaker_threshold * (len(self.breaker.tiers) - 1) + 1
        for attempt in range(attempts):
            i, tier = self.breaker.current()
            if self._last_tier is not None and i != self._last_tier:
                self.stats.n_fallback += 1
                if self.metrics is not None:
                    prev = self.breaker.tiers[self._last_tier].name
                    self.metrics.counter(
                        "serve_breaker_transitions_total",
                        {"from": prev, "to": tier.name}).inc()
                    self.metrics.event("serve_breaker_transition",
                                       from_tier=prev, to_tier=tier.name,
                                       reason="tier_open"
                                       if i > self._last_tier else "recovery")
            self._last_tier = i
            try:
                tier_params = params if tier.beam_width is None else \
                    dataclasses.replace(params, beam_width=tier.beam_width)
                res = self._search(
                    torch.as_tensor(qs).to(self.index.device),
                    params=tier_params, backend=tier.backend)
                out = (res.ids.cpu().numpy(), res.dists.cpu().numpy(),
                       res.saturated.cpu().numpy())
                self.breaker.record_success(i)
                self._last_result = res     # device counters for _obs_batch
                return out, tier.name
            except Exception as e:
                last_err = e
                self.breaker.record_failure(i)
                if attempt < attempts - 1:
                    self.stats.n_retried += 1
                    if cfg.backoff_s > 0:
                        time.sleep(min(cfg.backoff_s * (2 ** attempt),
                                       cfg.backoff_cap_s))
        raise SearchFailure(f"{type(last_err).__name__}: {last_err}") \
            from last_err

    # -- serve loop ----------------------------------------------------------
    def drain(self) -> list[Response]:
        """Serve everything queued; one ``Response`` per submitted request,
        in submission order.  Never raises on search faults — worst case is
        ``status="failed"`` responses with the error attached."""
        out = self._done
        self._done = []
        tr = self.tracer
        while self._queue:
            self._adjust_rung(len(self._queue))
            take = self._queue[: self.max_batch]
            self._queue = self._queue[self.max_batch:]

            bspan = tr.start_span("serve.batch", rung=self.rung) \
                if tr else None
            fspan = tr.start_span("serve.batch_form", parent=bspan) \
                if tr else None
            now = Timer.now()
            live = []
            for req in take:
                if now > req.deadline_t:
                    self.stats.n_deadline_missed += 1
                    self._obs_response(req, now, now, "deadline",
                                       batch_span=bspan)
                    out.append(Response(
                        seq=req.seq, status="deadline",
                        latency_s=now - req.wall_t,
                        error="deadline exceeded before dispatch"))
                else:
                    live.append(req)
            if not live:
                if tr:
                    tr.end_span(fspan, size=0)
                    tr.end_span(bspan, size=0)
                continue

            qs = np.stack([r.query for r in live])
            bucket = self._bucket(len(live))
            pad = bucket - len(live)
            if pad:
                qs = np.concatenate([qs, np.repeat(qs[-1:], pad, axis=0)])
            rung = self.rung
            params = self.ladder.params(rung)
            bound = self.ladder.delta_bound(rung)
            if tr:
                tr.end_span(fspan, size=len(live), bucket=bucket)
            espan = None
            if tr:
                espan = tr.start_span("serve.device_execute", parent=bspan,
                                      rung=rung)
                tr.activate(espan)      # shard fan-out spans nest under it
            t0 = Timer.now()
            try:
                (ids, dists, sat), tier_name = \
                    self._search_contained(qs, params)
            except SearchFailure as e:
                t1 = Timer.now()
                if tr:
                    tr.deactivate(espan)
                    tr.end_span(espan, error=str(e))
                self._obs_batch(len(live), None, t1 - t0)
                for req in live:
                    self.stats.n_failed += 1
                    self._obs_response(req, t0, t1, "failed",
                                       batch_span=bspan)
                    out.append(Response(seq=req.seq, status="failed",
                                        rung=rung, latency_s=t1 - req.wall_t,
                                        error=str(e)))
                self.stats.n_batches += 1
                self.stats.total_search_s += t1 - t0
                if tr:
                    tr.end_span(bspan, size=len(live), status="failed")
                continue
            t1 = Timer.now()
            if tr:
                tr.deactivate(espan)
                tr.end_span(espan, tier=tier_name)
            self._obs_batch(len(live), self._last_result, t1 - t0)
            mspan = tr.start_span("serve.merge", parent=bspan) if tr else None
            for i, req in enumerate(live):
                lat = t1 - req.wall_t
                missed = t1 > req.deadline_t
                self.stats.n_requests += 1
                self.stats.total_latency_s += lat
                self.stats.max_latency_s = max(self.stats.max_latency_s, lat)
                if rung > 0:
                    self.stats.n_degraded += 1
                if missed:
                    self.stats.n_deadline_missed += 1
                self._obs_response(req, t0, t1, "ok", batch_span=bspan)
                out.append(Response(
                    seq=req.seq, status="ok", ids=ids[i], dists=dists[i],
                    rung=rung, delta_bound=bound, tier=tier_name,
                    saturated=bool(sat[i]), deadline_missed=missed,
                    latency_s=lat, coverage=self._last_coverage,
                    max_missed=self._last_max_missed))
            self.stats.n_batches += 1
            self.stats.total_search_s += t1 - t0
            if tr:
                tr.end_span(mspan)
                tr.end_span(bspan, size=len(live), tier=tier_name)
        out.sort(key=lambda r: r.seq)
        return out


# ---------------------------------------------------------------------------
# Sharded resilient serving (distributed fault tolerance).
# ---------------------------------------------------------------------------


class ShardedResilientAnnServer(ResilientAnnServer):
    """The resilient server fronting a ``ShardedIndex``.

    The search seam routes to a registry-masked single-controller sharded
    search (``core.distributed.FaultTolerantShardedSearch``: each live
    slot's kernel search, then the exact merge).  The breaker chain is the
    two merge strategies, ``sharded/all_gather`` and ``sharded/ring``: a
    merge-time fault opens the primary merge tier and the other,
    equally exact merge serves.  Both tiers run the same per-shard search
    on ``backend`` (the kernels on the card), so a fallback never lets the
    plain version answer for a kernel.  Shard death is NOT a breaker
    event: the registry masks the dead shard out and serving continues at
    reduced coverage, reported per response (``coverage``,
    ``max_missed``).

    ``kill_shard`` / ``revive_shard`` are the operator surface; with
    ``n_replicas > 1`` a killed primary fails over to its replica before
    coverage degrades.  ``health_deadline_s`` adds a
    ``DeadlineHealthChecker`` fed by ``heartbeat``.

    **Self-healing** (``auto_repair=``): with a durable ``vector_store``
    (a ``core.repair.ShardVectorStore`` or its directory path), a
    ``RepairController`` is swept once per dispatch — after the health
    check, before the batch routes — so a dead slot is rebuilt from
    source, verified, atomically installed and ``mark_live``-d without an
    operator call.  Pass ``True`` for the default ``RepairConfig`` or a
    ``RepairConfig``.
    """

    def __init__(self, sidx, params: SearchParams, *,
                 merge: str = "all_gather", quantized: bool = False,
                 n_replicas: int = 1,
                 config: ResilienceConfig = ResilienceConfig(),
                 clock=time.monotonic, health_deadline_s=None,
                 auto_repair=None, vector_store=None,
                 repair_fault_hook=None, backend: str = "auto", **kw):
        from ..core.distributed import (DeadlineHealthChecker,
                                        FaultTolerantShardedSearch,
                                        ShardHealthRegistry)
        super().__init__(sidx, params, config=config, clock=clock,
                         backend=backend, **kw)
        self.quantized = quantized          # a ShardedIndex defeats isinstance
        self.registry = ShardHealthRegistry(sidx.n_shards // n_replicas,
                                            n_replicas, clock=clock)
        # replicas heartbeat via ``heartbeat()``; a stale one is
        # mark_dead-ed before the next batch dispatches (None → explicit
        # kill_shard / revive_shard only)
        self.health_checker = None if health_deadline_s is None else \
            DeadlineHealthChecker(self.registry, health_deadline_s,
                                  metrics=self.metrics)
        merges = [merge, "ring" if merge == "all_gather" else "all_gather"]
        self._ft = {
            m: FaultTolerantShardedSearch(
                sidx, merge=m, quantized=quantized, n_replicas=n_replicas,
                registry=self.registry, backend=backend)
            for m in merges
        }
        self.breaker = CircuitBreaker(
            [(m, None, "sharded") for m in merges],
            threshold=config.breaker_threshold,
            cooldown_s=config.breaker_cooldown_s, clock=clock)
        self.repair = None
        if auto_repair:
            from ..core.repair import (RepairConfig, RepairController,
                                       ShardVectorStore)
            if vector_store is None:
                raise ValueError("auto_repair requires vector_store (a "
                                 "ShardVectorStore or its directory path)")
            if isinstance(vector_store, str):
                vector_store = ShardVectorStore(vector_store)
            self.repair = RepairController(
                vector_store, self.registry,
                get_sidx=lambda: self.index,
                set_sidx=self._install_sidx,
                config=auto_repair if isinstance(auto_repair, RepairConfig)
                else None,
                clock=clock, metrics=self.metrics,
                fault_hook=repair_fault_hook)

    def _install_sidx(self, sidx) -> None:
        """Atomic index swap: the new index replaces the old for every
        searcher at once (the next batch sees one consistent index)."""
        self.index = sidx
        for ft in self._ft.values():
            ft.sidx = sidx

    # -- operator surface ----------------------------------------------------
    def kill_shard(self, shard: int, replica: int = 0) -> None:
        self.registry.mark_dead(shard, replica)

    def revive_shard(self, shard: int, replica: int = 0) -> None:
        self.registry.mark_live(shard, replica)

    def heartbeat(self, shard: int, replica: int = 0) -> None:
        """Liveness signal from a shard's host, consumed by the deadline
        health checker."""
        self.registry.heartbeat(shard, replica)

    @property
    def coverage(self) -> float:
        return self.registry.coverage()

    # -- search seam ---------------------------------------------------------
    def _search(self, queries, params: Optional[SearchParams] = None,
                backend: Optional[str] = None):
        """One batch: health check, repair sweep, then the sharded search
        with the merge ``backend`` names (the breaker's tier)."""
        params = params if params is not None else self.params
        merge = backend if backend in self._ft else next(iter(self._ft))
        if self.health_checker is not None:
            self.health_checker.check()     # stale heartbeats → mark_dead
        if self.repair is not None:
            self.repair.sweep()             # dead slots → rebuild + install
        tr = self.tracer
        if tr is None:
            r = self._ft[merge](queries, params)
        else:
            # one child per logical shard under a fanout parent (itself a
            # child of the batch's device_execute span).  The single
            # controller searches every live slot in one lock-step loop,
            # so each live shard's child spans that one search (the
            # children nest, opened in slot order); a dead shard's child
            # is empty and carries live=False
            fanout = tr.start_span("serve.shard_fanout", merge=merge)
            R = self.registry.n_replicas
            for s in self.registry.dead_shards():
                tr.end_span(tr.start_span("shard", parent=fanout, shard=s,
                                          live=False))
            r = self._ft[merge](
                queries, params,
                around=lambda slot: tr.span("shard", parent=fanout,
                                            shard=slot // R,
                                            replica=slot % R, live=True))
            tr.end_span(fanout, coverage=r.coverage,
                        max_missed=r.max_missed)
        if self.metrics is not None:
            self.registry.publish(self.metrics)
        self._last_coverage = r.coverage
        self._last_max_missed = r.max_missed
        B = r.ids.shape[0]
        zeros = torch.zeros((B,), dtype=torch.int32, device=r.ids.device)
        return SearchResult(ids=r.ids, dists=r.dists, n_dist_comps=zeros,
                            n_approx_comps=zeros, n_hops=zeros,
                            final_l=zeros,
                            saturated=torch.zeros((B,), dtype=torch.bool,
                                                  device=r.ids.device),
                            n_encounters=zeros)
