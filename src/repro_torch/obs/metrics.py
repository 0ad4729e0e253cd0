"""Dependency-free metrics substrate: counters, gauges, histograms, timer.

Design constraints (this is the serving hot path's telemetry, not an APM
suite):

* **Stdlib only.**  The registry must be importable from every layer —
  kernels' host wrappers, the builder, the servers — without dragging in a
  client library the container doesn't have.
* **Monotonic clocks only.**  Every duration here comes from
  ``time.perf_counter()`` via ``Timer``.  ``time.time()`` is wall clock and
  steps under NTP — the seed's serve stats could report *negative*
  latencies after a clock slew.  No ``time.time()`` latency math is
  allowed in the serve packages.
* **Fixed-bucket histograms.**  Latency histograms use a fixed exponential
  bucket ladder so p50/p95/p99 extraction is O(#buckets), mergeable across
  processes, and *identical math* between the benchmark harness and the
  serve-time exporters (``benchmarks/qps_recall.py`` observes into the same
  ``Histogram``).
* **Labels are first-class but flat.**  A metric family (one name) has
  children keyed by a sorted ``(key, value)`` label tuple — enough for
  ``{shard="3"}`` / ``{status="ok"}`` cardinality, no label matchers.

Observation never raises into the serving path: values are coerced with
``float()`` and NaN observations are dropped (counted in ``n_dropped``).
"""

from __future__ import annotations

import math
import time
from collections import deque
from typing import Optional

# Exponential ladder 100 µs → ~13 s; doubling buckets keep relative
# quantile error ≤ 2× at every scale a CPU-or-TPU batch can land on.
DEFAULT_LATENCY_BUCKETS_S: tuple[float, ...] = tuple(
    1e-4 * (2.0 ** i) for i in range(18)
)

# For device-side work counters surfaced per batch (final_l, hops):
# powers of two up to the largest l_max anyone configures.
DEFAULT_WORK_BUCKETS: tuple[float, ...] = tuple(
    float(2 ** i) for i in range(1, 15)
)

LabelDict = Optional[dict]


def _label_key(labels: LabelDict) -> tuple:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotonic counter.  ``inc`` only goes up; decrements raise."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value: float = 0.0

    def inc(self, n: float = 1.0) -> None:
        n = float(n)
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        self.value += n


class Gauge:
    """Point-in-time value (liveness, queue depth, coverage)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value: float = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += float(n)

    def dec(self, n: float = 1.0) -> None:
        self.value -= float(n)


class Histogram:
    """Fixed-bucket histogram with Prometheus-style cumulative export and
    interpolated quantile extraction.

    ``bounds`` are the inclusive upper edges of the finite buckets
    (ascending); observations above the last edge land in the +Inf
    overflow bucket.  ``quantile(q)`` walks the cumulative counts and
    linearly interpolates inside the winning bucket; overflow-bucket
    quantiles report the exact observed max (tracked separately) rather
    than pretending +Inf.
    """

    __slots__ = ("bounds", "counts", "overflow", "sum", "count",
                 "min", "max", "n_dropped")

    def __init__(self, bounds: tuple[float, ...] = DEFAULT_LATENCY_BUCKETS_S):
        if not bounds or any(b <= a for a, b in zip(bounds, bounds[1:])):
            raise ValueError(f"bucket bounds must be ascending: {bounds}")
        self.bounds = tuple(float(b) for b in bounds)
        self.counts = [0] * len(self.bounds)
        self.overflow = 0
        self.sum = 0.0
        self.count = 0
        self.min = math.inf
        self.max = -math.inf
        self.n_dropped = 0

    def observe(self, v: float) -> None:
        v = float(v)
        if math.isnan(v):
            self.n_dropped += 1
            return
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        # linear scan: 18 buckets, branch-predictable; not worth bisect
        for i, b in enumerate(self.bounds):
            if v <= b:
                self.counts[i] += 1
                return
        self.overflow += 1

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def cumulative(self) -> list[tuple[float, int]]:
        """[(upper_edge, cumulative_count)] including the +Inf bucket."""
        out, acc = [], 0
        for b, c in zip(self.bounds, self.counts):
            acc += c
            out.append((b, acc))
        out.append((math.inf, acc + self.overflow))
        return out

    def quantile(self, q: float) -> float:
        """Interpolated q-quantile (q in [0, 1]); 0.0 when empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        if self.count == 0:
            return 0.0
        rank = q * self.count
        acc = 0
        lo = 0.0
        for b, c in zip(self.bounds, self.counts):
            if acc + c >= rank and c > 0:
                frac = (rank - acc) / c
                lo_edge = max(lo, self.min if acc == 0 else lo)
                hi_edge = min(b, self.max)
                return lo_edge + frac * max(hi_edge - lo_edge, 0.0)
            acc += c
            lo = b
        # overflow bucket: the honest answer is the tracked max
        return self.max

    def percentiles(self) -> dict[str, float]:
        return {"p50": self.quantile(0.50),
                "p95": self.quantile(0.95),
                "p99": self.quantile(0.99)}


class Timer:
    """Monotonic-clock duration capture (``time.perf_counter``).

    Use as a context manager — ``with Timer(hist) as t: ...`` observes the
    elapsed seconds into ``hist`` (if given) on exit and leaves it on
    ``t.elapsed`` — or call ``Timer.now()`` for a raw monotonic timestamp
    where two-point arithmetic is clearer than a ``with`` block.
    """

    __slots__ = ("hist", "start", "elapsed")

    now = staticmethod(time.perf_counter)

    def __init__(self, hist: Optional[Histogram] = None):
        self.hist = hist
        self.start = 0.0
        self.elapsed = 0.0

    def __enter__(self) -> "Timer":
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.elapsed = time.perf_counter() - self.start
        if self.hist is not None:
            self.hist.observe(self.elapsed)


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Get-or-create registry of metric families with flat labels.

    A *family* is (name, kind, help, bucket bounds); *children* are the
    per-label-set instances.  Re-requesting a name with a different kind
    raises — a name means one thing for the life of the process.

    ``event(name, **fields)`` appends a structured record (ladder
    transitions, breaker trips, build phases) to a bounded ring and bumps
    the ``{name}_total`` counter, so events are countable in Prometheus
    text and inspectable with payloads in the JSON export.
    """

    def __init__(self, max_events: int = 2048):
        self._families: dict[str, dict] = {}
        self._children: dict[tuple[str, tuple], object] = {}
        self.events: deque = deque(maxlen=max_events)

    # -- family accessors ----------------------------------------------------
    def _get(self, kind: str, name: str, labels: LabelDict, help: str,
             buckets: Optional[tuple[float, ...]] = None):
        fam = self._families.get(name)
        if fam is None:
            fam = {"kind": kind, "help": help,
                   "buckets": buckets or DEFAULT_LATENCY_BUCKETS_S}
            self._families[name] = fam
        elif fam["kind"] != kind:
            raise TypeError(f"metric {name!r} already registered as "
                            f"{fam['kind']}, requested {kind}")
        key = (name, _label_key(labels))
        child = self._children.get(key)
        if child is None:
            child = Histogram(fam["buckets"]) if kind == "histogram" \
                else _KINDS[kind]()
            self._children[key] = child
        return child

    def counter(self, name: str, labels: LabelDict = None,
                help: str = "") -> Counter:
        return self._get("counter", name, labels, help)

    def gauge(self, name: str, labels: LabelDict = None,
              help: str = "") -> Gauge:
        return self._get("gauge", name, labels, help)

    def histogram(self, name: str, labels: LabelDict = None, help: str = "",
                  buckets: Optional[tuple[float, ...]] = None) -> Histogram:
        return self._get("histogram", name, labels, help, buckets)

    def timer(self, name: str, labels: LabelDict = None,
              help: str = "") -> Timer:
        return Timer(self.histogram(name, labels, help))

    # -- structured events ---------------------------------------------------
    def event(self, name: str, **fields) -> dict:
        rec = {"name": name, "t_mono": time.perf_counter(), **fields}
        self.events.append(rec)
        self.counter(f"{name}_total").inc()
        return rec

    # -- iteration (exporters) -----------------------------------------------
    def families(self):
        """Yields (name, kind, help, [(label_tuple, child), ...])."""
        for name, fam in sorted(self._families.items()):
            children = [(lk, c) for (n, lk), c in
                        sorted(self._children.items()) if n == name]
            yield name, fam["kind"], fam["help"], children
