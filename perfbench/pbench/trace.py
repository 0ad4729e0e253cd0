"""One call under ``torch.profiler``, reduced to what the per-layer
metrics and the result's ``breakdown`` read.

Only device activity is recorded (``ProfilerActivity.CUDA``: the kernels,
copies and fills, with the runtime's launch calls).  The host's operators
would multiply the events a call makes many times over, and the profiler's
own processing of them would outlast the run.  The events are read from the
profiler's raw results (``kineto_results``), never through
``key_averages``, whose processing of a call's ~10⁶ events takes minutes.
"""

from __future__ import annotations

import re
import time
from typing import Callable

SUMMARY_TOP = 10          # entries in each list of the breakdown


def _ns(ev, which: str) -> int:
    fn = getattr(ev, f"{which}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(ev, f"{which}_us")() * 1000)


def short_name(name: str, width: int = 96) -> str:
    """A device op's name without ``void``, its namespaces' noise and its
    parameter list: ``void l2rows::rows_kernel<true, 2>(float const*, ...)``
    → ``l2rows::rows_kernel<true, 2>``."""
    s = name[5:] if name.startswith("void ") else name
    s = s.replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(s):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            s = s[:i]
            break
    return s if len(s) <= width else s[:width - 3] + "..."


def device_ops(raw_events) -> list[tuple[str, int, int]]:
    """(name, start ns, end ns) of every operation that ran on the device,
    sorted by start."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    ops = []
    for ev in raw_events:
        if ev.device_type() != cuda:
            continue
        start = _ns(ev, "start")
        ops.append((ev.name(), start, start + _ns(ev, "duration")))
    ops.sort(key=lambda o: o[1])
    return ops


def summarize(ops: list[tuple[str, int, int]], window_s: float) -> dict:
    """The device's busy seconds (the union of its operations' intervals),
    each op name's seconds and count, and the idle gaps between operations
    grouped by the operation that ended them: in a loop the host paces,
    a gap is the host's work toward that launch."""
    busy_ns = 0
    per_op: dict[str, list] = {}
    gaps: dict[str, int] = {}
    end = None
    for name, s, e in ops:
        rec = per_op.setdefault(name, [0, 0])
        rec[0] += e - s
        rec[1] += 1
        if end is None or s >= end:
            if end is not None and s > end:
                key = "before " + short_name(name)
                gaps[key] = gaps.get(key, 0) + (s - end)
            busy_ns += e - s
            end = e
        elif e > end:
            busy_ns += e - end
            end = e
    span_s = (ops[-1][2] - ops[0][1]) / 1e9 if ops else 0.0
    outside = max(window_s - span_s, 0.0)
    gap_list = sorted(((k, v / 1e9) for k, v in gaps.items()),
                      key=lambda kv: -kv[1])
    if outside > 0:
        gap_list.append(("host, outside the device's first and last op",
                         outside))
        gap_list.sort(key=lambda kv: -kv[1])
    kernels = {name: (rec[0] / 1e9, rec[1]) for name, rec in per_op.items()}
    top = sorted(((short_name(n), t) for n, (t, _) in kernels.items()),
                 key=lambda kv: -kv[1])
    merged: dict[str, float] = {}
    for n, t in top:
        merged[n] = merged.get(n, 0.0) + t
    return {
        "busy_s": busy_ns / 1e9,
        "window_s": window_s,
        "kernels": kernels,
        "breakdown": {
            "device_ops": [[n, t] for n, t in sorted(
                merged.items(), key=lambda kv: -kv[1])[:SUMMARY_TOP]],
            "idle_gaps": [[n, t] for n, t in gap_list[:SUMMARY_TOP]],
        },
    }


def traced(fn: Callable[[], object]) -> tuple[object, dict]:
    """``fn()`` under the profiler: (its result, ``summarize``'s dict plus
    the seconds the profiler's stop and the reading of its events took)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    ops = device_ops(prof.profiler.kineto_results.events())
    summary = summarize(ops, window_s)
    summary.update(stop_s=t1 - t0 - window_s, read_s=time.perf_counter() - t1,
                   n_device_ops=len(ops))
    return out, summary


def kernel_seconds(summary: dict, pattern: str) -> tuple[float, int]:
    """Device seconds and launches of the ops whose full name matches
    ``pattern`` (a regular expression)."""
    rx = re.compile(pattern)
    secs, count = 0.0, 0
    for name, (t, c) in summary["kernels"].items():
        if rx.search(name):
            secs += t
            count += c
    return secs, count
