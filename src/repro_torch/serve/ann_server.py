"""Batched ANN request serving on a δ-EMG / δ-EMQG index.

Counterpart of ``repro.serve.ann_server``: requests accumulate, each batch
is padded to a fixed bucket size (the last query repeated), searched on the
lock-step beam engine, and the per-request results are fanned back out.
``drain`` moves each padded batch to the index's device once; on the card
the exact tier runs the CUDA ``gather_l2_tiled`` kernel (``backend="auto"``).

The server runs the batch-level beam engine; ``_search(queries, params,
backend)`` is the one seam every batch passes through, which the
resilience layer (``resilience.py``) steers (ladder params, breaker tier)
and the fault harness (``testing.faults``) wraps.

Clocks, metrics and spans are those of the JAX package's server: every
request records its monotonic submit time ``wall_t`` (``obs.Timer``);
latency is submit → completion on the monotonic clock.
With ``metrics=`` / ``tracer=`` the server emits the serve taxonomy
(request-latency / queue-wait / batch-execute histograms, per-status
counters, batch-aggregated search counters) and the spans
``serve.request`` → ``serve.queue_wait`` and ``serve.batch`` →
``serve.batch_form`` / ``serve.device_execute`` / ``serve.merge``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core import EMQGIndex, GraphIndex, SearchParams, probing_search, search
from ..core.types import resolve_device
from ..obs import (
    DEFAULT_WORK_BUCKETS,
    MetricsRegistry,
    Timer,
    Tracer,
    record_search_result,
)


@dataclasses.dataclass
class ServeStats:
    """Serve-loop counters.  The resilience counters (``n_rejected``
    onward) stay zero under the plain ``AnnServer``; ``ResilientAnnServer``
    drives them."""

    n_requests: int = 0
    n_batches: int = 0
    total_latency_s: float = 0.0
    max_latency_s: float = 0.0
    total_search_s: float = 0.0
    # -- resilience counters -------------------------------------------------
    n_rejected: int = 0          # failed per-request validation (shape/NaN/…)
    n_shed: int = 0              # refused by admission control (queue full)
    n_degraded: int = 0          # served at a ladder rung below full quality
    n_retried: int = 0           # search attempts retried after a fault
    n_fallback: int = 0          # circuit-breaker tier switches
    n_deadline_missed: int = 0   # completed after their deadline
    n_failed: int = 0            # exhausted every tier/retry; error response

    @property
    def mean_latency_s(self) -> float:
        return self.total_latency_s / max(self.n_requests, 1)

    @property
    def qps(self) -> float:
        return self.n_requests / max(self.total_search_s, 1e-9)


@dataclasses.dataclass
class _Request:
    """A queued request and its monotonic submit time."""

    wall_t: float
    query: np.ndarray
    seq: int


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index is None or b.index is None
                                 or a.index == b.index)


class AnnServer:
    def __init__(self, index: GraphIndex | EMQGIndex, params: SearchParams,
                 max_batch: int = 64, buckets: tuple[int, ...] = (8, 32, 64),
                 backend: str = "auto",
                 metrics: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None, device="cuda"):
        self.device = resolve_device(device)
        if not _same_device(index.device, self.device):
            raise ValueError(f"index lives on {index.device}, server was "
                             f"asked for {self.device}")
        self.index = index
        self.params = params
        self.max_batch = max_batch
        self.buckets = tuple(sorted(set(b for b in buckets if b <= max_batch))) \
            or (max_batch,)
        self.quantized = isinstance(index, EMQGIndex)
        self.backend = backend
        self.metrics = metrics
        self.tracer = tracer
        self._queue: list[_Request] = []
        self._seq = 0
        self.stats = ServeStats()

    def _search(self, queries: torch.Tensor,
                params: Optional[SearchParams] = None,
                backend: Optional[str] = None):
        """Run one batch through the beam engine.  The overrides are the
        seam the resilience layer steers and the fault harness wraps."""
        params = params if params is not None else self.params
        backend = backend if backend is not None else self.backend
        if self.quantized:
            return probing_search(self.index, queries, params, backend=backend)
        return search(self.index, queries, params, backend=backend)

    # -- observability seams -------------------------------------------------
    def _obs_batch(self, n_live: int, res, exec_s: float) -> None:
        """Batch-level metrics; ``n_live`` excludes pad rows."""
        if self.metrics is None:
            return
        self.metrics.histogram("serve_batch_execute_seconds").observe(exec_s)
        self.metrics.histogram("serve_batch_size",
                               buckets=DEFAULT_WORK_BUCKETS).observe(n_live)
        if res is not None:
            record_search_result(self.metrics, res, n_live=n_live)

    def _obs_response(self, req: _Request, dispatch_t: float, done_t: float,
                      status: str, batch_span=None) -> None:
        """Per-request metrics + retroactive request/queue-wait spans."""
        if self.metrics is not None:
            self.metrics.counter("serve_responses_total",
                                 {"status": status}).inc()
            if status in ("ok", "failed"):
                self.metrics.histogram(
                    "serve_request_latency_seconds").observe(
                        done_t - req.wall_t)
                self.metrics.histogram("serve_queue_wait_seconds").observe(
                    max(dispatch_t - req.wall_t, 0.0))
        if self.tracer is not None:
            rspan = self.tracer.start_span(
                "serve.request", seq=req.seq, status=status,
                batch=None if batch_span is None else batch_span.span_id)
            rspan.start = req.wall_t
            qspan = self.tracer.start_span("serve.queue_wait", parent=rspan)
            qspan.start = req.wall_t
            self.tracer.end_span(qspan, end=dispatch_t)
            self.tracer.end_span(rspan, end=done_t)

    # -- request path -------------------------------------------------------
    def submit(self, query: np.ndarray):
        self._queue.append(_Request(
            wall_t=Timer.now(), query=np.asarray(query, np.float32),
            seq=self._seq))
        self._seq += 1

    def submit_many(self, queries: np.ndarray):
        for q in queries:
            self.submit(q)

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        # n exceeds every bucket (max_batch > largest bucket): serve unpadded
        return n

    def drain(self) -> list[tuple[np.ndarray, np.ndarray]]:
        """Serve everything queued; returns [(ids, dists)] per request in
        submission order, as host numpy arrays."""
        out = []
        tr = self.tracer
        while self._queue:
            take = self._queue[: self.max_batch]
            self._queue = self._queue[self.max_batch:]
            bspan = tr.start_span("serve.batch") if tr else None
            fspan = tr.start_span("serve.batch_form", parent=bspan) \
                if tr else None
            qs = np.stack([r.query for r in take])
            bucket = self._bucket(len(take))
            pad = bucket - len(take)
            if pad:
                qs = np.concatenate([qs, np.repeat(qs[-1:], pad, axis=0)])
            if tr:
                tr.end_span(fspan, size=len(take), bucket=bucket)
            espan = tr.start_span("serve.device_execute", parent=bspan,
                                  backend=self.backend) if tr else None
            t0 = Timer.now()
            res = self._search(torch.as_tensor(qs).to(self.index.device))
            ids = res.ids.cpu().numpy()        # waits for the device
            dists = res.dists.cpu().numpy()
            t1 = Timer.now()
            if tr:
                tr.end_span(espan)
            self._obs_batch(len(take), res, t1 - t0)
            mspan = tr.start_span("serve.merge", parent=bspan) if tr else None
            for i, req in enumerate(take):
                out.append((ids[i], dists[i]))
                lat = t1 - req.wall_t
                self.stats.n_requests += 1
                self.stats.total_latency_s += lat
                self.stats.max_latency_s = max(self.stats.max_latency_s, lat)
                self._obs_response(req, t0, t1, "ok", batch_span=bspan)
            if tr:
                tr.end_span(mspan)
                tr.end_span(bspan, size=len(take))
            self.stats.n_batches += 1
            self.stats.total_search_s += t1 - t0
        return out
