"""The port's spans (``repro_torch.obs.Tracer``) laid over the device trace
of ``torch.profiler``: which span launched each device op, and which span
the host was in when the device went idle.

The profiler stamps its events on the Unix epoch's clock in nanoseconds
(``time.time_ns``); the spans use ``time.perf_counter``.  The tracer's
clock anchors (``Tracer.anchors``, pairs of both clocks read back to back)
map each span onto the profiler's timeline, by the line through the first
and the last anchor.  A device op belongs to the innermost span whose
interval holds the host call that launched it (the runtime event with the
op's correlation id); an idle gap belongs to the span that launched the
op that ended it.  Ops launched outside every span are "unattributed".

Readings, each None where the spans are missing or the ring dropped some
(``Tracer.n_dropped``):

* ``merge_ms``: device ms of the ops launched in ``probe.merge``, per
  iteration (a ``probe.iter`` with ``active`` > 0);
* ``active_row_share``: Σ ``active`` over Σ ``rows`` of those iterations,
  in %;
* ``host_launch_ms``: the mean host ms of such an iteration less its
  ``probe.sync``: the host's own time to issue an iteration;
* ``build_search_s``: the seconds of every ``build.search`` span.
"""

from __future__ import annotations

import bisect
from typing import Callable

from pbench.trace import _ns, short_name

UNATTRIBUTED = "unattributed"


# -- the spans on the profiler's clock ---------------------------------------

def mapped_spans(spans: list[dict], anchors: list) -> list[dict]:
    """``spans`` (``Tracer.to_dicts()``, finished) with ``t0`` and ``t1``,
    their start and end in ns on the Unix epoch's clock."""
    (p0, u0), (p1, u1) = anchors[0], anchors[-1]
    slope = drift_ns(anchors) / (p1 - p0) if p1 != p0 else 0.0

    def to_epoch(t: float) -> int:
        p = round(t * 1e9)
        return p + (u0 - p0) + round(slope * (p - p0))

    return [dict(s, t0=to_epoch(s["start"]), t1=to_epoch(s["end"]))
            for s in spans if s["end"] is not None]


def drift_ns(anchors: list) -> int:
    """How far the two clocks moved apart between the first anchor and the
    last."""
    (p0, u0), (p1, u1) = anchors[0], anchors[-1]
    return (u1 - p1) - (u0 - p0)


def _segments(spans: list[dict]) -> tuple[list[int], list[int]]:
    """The timeline cut where the innermost open span changes: segment
    ``j`` starts at ``bounds[j]`` and belongs to span ``owners[j]`` (an
    index into ``spans``; -1 for none).  Spans nest (a single-threaded
    tracer's do); a span's interval is [t0, t1)."""
    order = sorted(range(len(spans)),
                   key=lambda i: (spans[i]["t0"], -spans[i]["t1"]))
    bounds: list[int] = []
    owners: list[int] = []

    def cut(t: int, owner: int) -> None:
        if bounds and bounds[-1] == t:
            owners[-1] = owner
        else:
            bounds.append(t)
            owners.append(owner)

    stack: list[int] = []
    for i in order:
        while stack and spans[stack[-1]]["t1"] <= spans[i]["t0"]:
            j = stack.pop()
            cut(spans[j]["t1"], stack[-1] if stack else -1)
        stack.append(i)
        cut(spans[i]["t0"], i)
    while stack:
        j = stack.pop()
        cut(spans[j]["t1"], stack[-1] if stack else -1)
    return bounds, owners


def owner_of(bounds: list[int], owners: list[int], t) -> int:
    """The innermost span open at ``t`` (an index), -1 for none."""
    if t is None:
        return -1
    j = bisect.bisect_right(bounds, t) - 1
    return owners[j] if j >= 0 else -1


# -- the profiler's events -----------------------------------------------------

def profiler_events(raw_events) -> tuple[list[tuple], dict[int, int]]:
    """From ``kineto_results.events()``: the device ops as (name, start ns,
    end ns, correlation id), sorted by start, and the host's CUDA API
    calls (``cuda…``, ``cu…``) as {correlation id: start ns}.  The
    profiler's own host events (a buffer flush) may carry a call's id and
    are left out."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    ops, launches = [], {}
    for ev in raw_events:
        corr = int(ev.correlation_id())
        if ev.device_type() == cuda:
            start = _ns(ev, "start")
            ops.append((ev.name(), start, start + _ns(ev, "duration"), corr))
        elif corr > 0 and ev.name().startswith("cu"):
            launches.setdefault(corr, _ns(ev, "start"))
    ops.sort(key=lambda o: o[1])
    return ops, launches


def profiled(fn: Callable[[], object], device="cuda"):
    """``fn()`` under the profiler: (its result, the seconds it took, the
    device ops and the launches of ``profiler_events``).  On a card it
    records device activity only, as ``pbench.trace.traced`` does; on the
    CPU (a rehearsal) the host's operators, which launch nothing."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    from pbench.launches import sync

    cuda = torch.device(device).type == "cuda"
    sync(device)
    with profile(activities=[ProfilerActivity.CUDA if cuda
                             else ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync(device)
        window_s = time.perf_counter() - t0
    ops, launches = profiler_events(prof.profiler.kineto_results.events())
    return out, window_s, ops, launches


# -- attribution -----------------------------------------------------------------

def iterations(spans: list[dict]) -> list[dict]:
    """The ``probe.iter`` spans of passes that searched (``active`` > 0)."""
    return [s for s in spans
            if s["name"] == "probe.iter" and s["attrs"].get("active", 0) > 0]


def attribute(spans: list[dict], ops: list[tuple],
              launches: dict[int, int]) -> dict:
    """Each device op and idle gap given to a span (``spans`` mapped).

    Returns {"rows": {span name: {"device_ns", "ops", "host_self_ns",
    "idle_ns", "spans"}}, one row ``UNATTRIBUTED``; "owners": each op's
    span index (-1 for none); "gaps" and "device": {span name: {op short
    name: ns}}, the idle time before each op and each op's device time;
    "busy_ns": the union of the ops' intervals}."""
    bounds, owners = _segments(spans)
    rows: dict[str, dict] = {}
    short: dict[str, str] = {}

    def row(name: str) -> dict:
        return rows.setdefault(name, {"device_ns": 0, "ops": 0,
                                      "host_self_ns": 0, "idle_ns": 0,
                                      "spans": 0})

    row(UNATTRIBUTED)
    by_id = {s["span_id"]: i for i, s in enumerate(spans)}
    child_ns = [0] * len(spans)
    for s in spans:
        parent = by_id.get(s["parent_id"])
        if parent is not None:
            child_ns[parent] += s["t1"] - s["t0"]
    for i, s in enumerate(spans):
        r = row(s["name"])
        r["spans"] += 1
        r["host_self_ns"] += (s["t1"] - s["t0"]) - child_ns[i]

    op_owner, gaps, device, busy, end = [], {}, {}, 0, None
    for name, start, stop, corr in ops:
        k = owner_of(bounds, owners, launches.get(corr))
        op_owner.append(k)
        key = spans[k]["name"] if k >= 0 else UNATTRIBUTED
        r = row(key)
        r["device_ns"] += stop - start
        r["ops"] += 1
        op = short.get(name) or short.setdefault(name, short_name(name))
        per = device.setdefault(key, {})
        per[op] = per.get(op, 0) + (stop - start)
        if end is None or start >= end:
            if end is not None and start > end:
                r["idle_ns"] += start - end
                per = gaps.setdefault(key, {})
                per[op] = per.get(op, 0) + (start - end)
            busy += stop - start
            end = stop
        elif stop > end:
            busy += stop - end
            end = stop
    return {"rows": rows, "owners": op_owner, "gaps": gaps,
            "device": device, "busy_ns": busy}


def launch_lags(ops: list[tuple], launches: dict[int, int]) -> list[int]:
    """Each device op's start less the start of the host call that
    launched it, in ns, sorted (negative: the op reads as started before
    its call)."""
    return sorted(start - launches[corr] for _, start, _, corr in ops
                  if corr in launches)


def early_starts(ops: list[tuple], launches: dict[int, int],
                 slack_ns: int = 2000) -> int:
    """Device ops that start more than ``slack_ns`` before the host call
    that launched them: each is a fault of the clocks' mapping."""
    return sum(1 for lag in launch_lags(ops, launches) if lag < -slack_ns)


def share_in(ops: list[tuple], op_owner: list[int], spans: list[dict],
             pattern: str, span_name: str) -> tuple[int, int]:
    """(ops whose name matches ``pattern`` that were launched in a span
    named ``span_name``, all ops that match)."""
    import re
    rx = re.compile(pattern)
    hit = total = 0
    for (name, *_), k in zip(ops, op_owner):
        if rx.search(name):
            total += 1
            hit += k >= 0 and spans[k]["name"] == span_name
    return hit, total


def idle_gaps(gaps: dict, top: int = 10, width: int = 64) -> list:
    """The largest idle gaps as [``"<span>: before <op>"``, seconds], the
    span first so that a cut to ``width`` keeps it."""
    flat = [(f"{span}: before {op}", ns / 1e9)
            for span, per in gaps.items() for op, ns in per.items()]
    flat.sort(key=lambda kv: -kv[1])
    return [[k[:width], v] for k, v in flat[:top]]


def table(rows: dict, n_iter: int) -> list[str]:
    """The per-span table: each span name's device ms, launches, host self
    ms and idle ms per iteration, most device time first."""
    per = max(n_iter, 1)
    lines = [f"{'span':<20}{'device ms':>12}{'launches':>10}"
             f"{'host self ms':>14}{'idle ms':>10}{'spans':>9}"]
    for name, r in sorted(rows.items(), key=lambda kv: -kv[1]["device_ns"]):
        lines.append(f"{name:<20}{r['device_ns'] / 1e6 / per:>12.4f}"
                     f"{r['ops'] / per:>10.2f}"
                     f"{r['host_self_ns'] / 1e6 / per:>14.4f}"
                     f"{r['idle_ns'] / 1e6 / per:>10.4f}{r['spans']:>9}")
    return lines


# -- the readings ------------------------------------------------------------------

def merge_ms(rows: dict, spans: list[dict], n_dropped: int):
    iters = iterations(spans)
    if n_dropped or not iters or "probe.merge" not in rows:
        return None
    return rows["probe.merge"]["device_ns"] / 1e6 / len(iters)


def active_row_share(spans: list[dict], n_dropped: int):
    iters = iterations(spans)
    if n_dropped or not iters:
        return None
    return 100.0 * sum(s["attrs"]["active"] for s in iters) \
        / sum(s["attrs"]["rows"] for s in iters)


def host_launch_ms(spans: list[dict], n_dropped: int):
    iters = iterations(spans)
    if n_dropped or not iters:
        return None
    sync = {s["parent_id"]: s["end"] - s["start"] for s in spans
            if s["name"] == "probe.sync"}
    if any(s["span_id"] not in sync for s in iters):
        return None
    return 1000.0 * sum(s["end"] - s["start"] - sync[s["span_id"]]
                        for s in iters) / len(iters)


def build_search_s(spans: list[dict], n_dropped: int):
    found = [s["end"] - s["start"] for s in spans
             if s["name"] == "build.search" and s["end"] is not None]
    if n_dropped or not found:
        return None
    return sum(found)
