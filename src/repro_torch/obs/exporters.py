"""Exporters: Prometheus text exposition, JSON snapshot, stderr summary.

All three render the same :class:`~repro_torch.obs.metrics.MetricsRegistry`; none
of them mutate it, so exporting can never perturb serving (the
metrics-on/off conformance test in ``tests/test_obs.py`` pins that).

* ``to_prometheus`` — text exposition format (``# TYPE`` headers,
  cumulative ``_bucket{le=...}`` lines, ``_sum``/``_count``, plus
  non-cumulative ``{quantile=...}`` convenience lines so p50/p95/p99 are
  scrapeable without a ``histogram_quantile`` recording rule).
* ``to_json`` / ``snapshot`` — a round-trippable dict (counters, gauges,
  histograms with percentiles, recent structured events, optional spans).
* ``summary_line`` / ``PeriodicSummary`` — the one-line operator heartbeat
  ``launch/serve.py --metrics-every`` emits to stderr between batches.
"""

from __future__ import annotations

import json
import math
import sys
import time
from typing import Optional

from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .tracing import Tracer

_QUANTILES = (0.5, 0.95, 0.99)


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    return repr(float(v))


def _label_str(label_key: tuple, extra: Optional[list] = None) -> str:
    pairs = list(label_key) + (extra or [])
    if not pairs:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in pairs) + "}"


def to_prometheus(registry: MetricsRegistry) -> str:
    lines: list[str] = []
    for name, kind, help, children in registry.families():
        if help:
            lines.append(f"# HELP {name} {help}")
        lines.append(f"# TYPE {name} {kind}")
        for label_key, child in children:
            if kind == "counter":
                lines.append(f"{name}{_label_str(label_key)} "
                             f"{_fmt(child.value)}")
            elif kind == "gauge":
                lines.append(f"{name}{_label_str(label_key)} "
                             f"{_fmt(child.value)}")
            else:
                for edge, cum in child.cumulative():
                    lines.append(
                        f"{name}_bucket"
                        f"{_label_str(label_key, [('le', _fmt(edge))])} "
                        f"{cum}")
                lines.append(f"{name}_sum{_label_str(label_key)} "
                             f"{_fmt(child.sum)}")
                lines.append(f"{name}_count{_label_str(label_key)} "
                             f"{child.count}")
                for q in _QUANTILES:
                    lines.append(
                        f"{name}{_label_str(label_key, [('quantile', str(q))])}"
                        f" {_fmt(child.quantile(q))}")
    return "\n".join(lines) + "\n"


def snapshot(registry: MetricsRegistry,
             tracer: Optional[Tracer] = None) -> dict:
    """Registry (and optionally trace ring) as a plain round-trippable dict."""
    out: dict = {"counters": {}, "gauges": {}, "histograms": {}, "events": []}
    for name, kind, _help, children in registry.families():
        for label_key, child in children:
            key = name + _label_str(label_key)
            if isinstance(child, Counter):
                out["counters"][key] = child.value
            elif isinstance(child, Gauge):
                out["gauges"][key] = child.value
            elif isinstance(child, Histogram):
                out["histograms"][key] = {
                    "count": child.count,
                    "sum": child.sum,
                    "mean": child.mean,
                    "min": child.min if child.count else None,
                    "max": child.max if child.count else None,
                    "buckets": [[b, c] for b, c in
                                zip(child.bounds, child.counts)],
                    "overflow": child.overflow,
                    **child.percentiles(),
                }
    out["events"] = [dict(e) for e in registry.events]
    if tracer is not None:
        out["spans"] = tracer.to_dicts()
    return out


def to_json(registry: MetricsRegistry, tracer: Optional[Tracer] = None,
            indent: Optional[int] = None) -> str:
    return json.dumps(snapshot(registry, tracer), indent=indent,
                      sort_keys=True)


def summary_line(registry: MetricsRegistry) -> str:
    """One operator-readable line: request volume, latency quantiles, rung,
    coverage — whatever of the standard taxonomy is present."""
    parts = []
    snap = snapshot(registry)
    lat = snap["histograms"].get("serve_request_latency_seconds")
    if lat:
        parts.append(f"req={lat['count']} "
                     f"p50={lat['p50'] * 1e3:.1f}ms "
                     f"p95={lat['p95'] * 1e3:.1f}ms "
                     f"p99={lat['p99'] * 1e3:.1f}ms")
    qw = snap["histograms"].get("serve_queue_wait_seconds")
    if qw and qw["count"]:
        parts.append(f"qwait_p95={qw['p95'] * 1e3:.1f}ms")
    for g in ("serve_rung", "shard_coverage"):
        if g in snap["gauges"]:
            parts.append(f"{g.split('_', 1)[1]}={snap['gauges'][g]:g}")
    for status in ("failed", "shed"):
        v = snap["counters"].get('serve_responses_total{status="%s"}' % status)
        if v:
            parts.append(f"{status}={v:g}")
    ndist = snap["counters"].get("search_dist_comps_total")
    if ndist is not None:
        parts.append(f"ndist={ndist:g}")
    return "[obs] " + (" ".join(parts) if parts else "no samples")


class PeriodicSummary:
    """Emit ``summary_line`` to ``stream`` at most every ``every_s`` seconds.

    Call :meth:`tick` from the serve loop between batches; it is a no-op
    until the interval has elapsed (monotonic clock).  ``every_s <= 0``
    disables it entirely.
    """

    def __init__(self, registry: MetricsRegistry, every_s: float,
                 stream=None, clock=time.perf_counter):
        self.registry = registry
        self.every_s = float(every_s)
        self.stream = stream if stream is not None else sys.stderr
        self.clock = clock
        self._last = clock()

    def tick(self, force: bool = False) -> Optional[str]:
        if self.every_s <= 0 and not force:
            return None
        now = self.clock()
        if force or now - self._last >= self.every_s:
            self._last = now
            line = summary_line(self.registry)
            print(line, file=self.stream, flush=True)
            return line
        return None
