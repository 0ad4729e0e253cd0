"""The port's spans over the device trace of one cell, on the card.

    python3 perfbench/trace_spans.py --workload synth-d128.batch \
        --seed 3900000001 --calls 2

Sets the cell up as a run does, with one ``repro_torch.obs.Tracer`` bound
into the build (``core.distributed.build_sharded``), warms it up, makes
``--calls`` calls of the cell's traffic with the tracer off, then replays
call 0 six times: under the profiler with the tracer off and on, and
without the profiler off, on, off and on.  It logs the per-span table of
the profiled replay with the tracer on (device ms, launches, host self
ms and idle ms per iteration; ``pbench/spans.py``) and the host's times
of the first unprofiled replay with the tracer on, the idle gaps named
by span, the clock controls, and each call's
``stats["iterations"]`` beside its ``fused_estimate`` launches; it prints
one JSON line with the readings (``merge_ms``, ``active_row_share``,
``host_launch_ms``, ``build_search_s``) and writes it, with the table, to
``--out``.  The benchmark's own runs never run it.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import functools  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

# the clock controls: each must hold for the attribution to be trusted
SHARE_FLOOR = 0.999          # of a kernel's launches in its own span
EARLY_NS = 2000              # a device op may start this far before its call
UNATTRIBUTED_CAP = 0.01      # of busy_s
SUM_TOLERANCE = 0.01         # per-span device times against busy_s


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@contextlib.contextmanager
def build_traced(tracer):
    """``core.distributed.build_sharded`` with ``tracer`` bound while the
    cell's set-up runs (it looks the function up when it builds)."""
    from repro_torch.core import distributed
    original = distributed.build_sharded
    distributed.build_sharded = functools.partial(original, tracer=tracer)
    try:
        yield
    finally:
        distributed.build_sharded = original


def one_call(state: dict, inp: dict, tracer=None) -> dict:
    """One served batch through the port's ``ann_serve`` call,
    synchronised: its answers, seconds, ``stats["iterations"]`` and
    ``fused_estimate`` launches."""
    from pbench.launches import fused_estimate_launches, sync
    stats = {}
    before = fused_estimate_launches()
    t0 = time.perf_counter()
    ids, dists = state["run"](inp["queries"], stats, tracer=tracer)
    sync(state["device"])
    return {"ids": ids, "dists": dists, "seconds": time.perf_counter() - t0,
            "iterations": stats["iterations"],
            "launches": fused_estimate_launches() - before}


def same(a: dict, b: dict) -> bool:
    """The two calls' answers are equal, bit for bit."""
    import torch
    return all(torch.equal(a[k], b[k]) for k in ("ids", "dists"))


def clock_controls(att: dict, mapped: list, ops: list,
                   launches: dict) -> dict:
    """The checks that the spans and the device trace share one clock."""
    from pbench import spans
    est = spans.share_in(ops, att["owners"], mapped,
                         r"fused_estimate_kernel", "probe.estimate")
    l2 = spans.share_in(ops, att["owners"], mapped,
                        r"l2rows::|gather_l2", "probe.exact")
    busy = max(att["busy_ns"], 1)
    total = sum(r["device_ns"] for r in att["rows"].values())
    lags = spans.launch_lags(ops, launches)
    # the least lag in each tenth of the replay, by launch time: a lag that
    # falls steadily is the two clocks running at different rates
    timed = sorted((launches[c], start - launches[c])
                   for _, start, _, c in ops if c in launches)
    tenths = [timed[i * len(timed) // 10:(i + 1) * len(timed) // 10]
              for i in range(10)]
    # how far a fused_estimate launch call lies inside its mapped span
    inside = sorted(launches[c] - mapped[k]["t0"]
                    for (name, _, _, c), k in zip(ops, att["owners"])
                    if "fused_estimate_kernel" in name and k >= 0)
    out = {
        "launch_lag_ns": {f"p{q}": lags[min(len(lags) - 1,
                                            len(lags) * q // 100)]
                          for q in (0, 1, 5, 10, 25, 50)} if lags else {},
        "least_lag_by_tenth_ns": [min(lag for _, lag in t) for t in tenths
                                  if t],
        "early_ops_by_tenth": [sum(lag < -EARLY_NS for _, lag in t)
                               for t in tenths],
        "estimate_launch_after_span_start_ns":
            [inside[0], inside[len(inside) // 2], inside[-1]]
            if inside else [],
        "fused_estimate_in_probe_estimate": list(est),
        "gather_l2_in_probe_exact": list(l2),
        "early_ops": spans.early_starts(ops, launches, EARLY_NS),
        "ops_with_a_launch": [sum(1 for *_, c in ops if c in launches),
                              len(ops)],
        "unattributed_share_of_busy":
            att["rows"][spans.UNATTRIBUTED]["device_ns"] / busy,
        "span_device_sum_over_busy": total / busy,
    }
    out["ok"] = (est[1] > 0 and est[0] >= SHARE_FLOOR * est[1]
                 and l2[1] > 0 and l2[0] >= SHARE_FLOOR * l2[1]
                 and out["early_ops"] == 0
                 and out["unattributed_share_of_busy"] < UNATTRIBUTED_CAP
                 and abs(out["span_device_sum_over_busy"] - 1)
                 < SUM_TOLERANCE)
    return out


def run(cell, seed: int, calls: int, device, t_start: float,
        log=log) -> dict:
    """Everything the module docstring lists, for ``cell``; returns the
    result."""
    import torch

    from pbench import spans
    from pbench import trace as tracing
    from pbench.cell import forbidden_modules
    from pbench.launches import sync
    from repro_torch.obs import Tracer

    sysmod = cell.system
    tracer = Tracer(max_spans=2 ** 17)
    with build_traced(tracer):
        state = sysmod.setup(cell.config, seed, device)
    sysmod.warmup(state, cell.traffic, seed)
    sync(device)
    setup_s = time.perf_counter() - t_start
    build = [s for s in tracer.to_dicts() if s["name"].startswith("build")]
    log(f"[spans] {cell.name}: set-up {setup_s:.3f} s, "
        f"{len(build)} build spans")

    done = []
    for i in range(calls):
        inp = sysmod.make_inputs(state, cell.traffic, seed, i)
        done.append((inp, one_call(state, inp)))
        c = done[-1][1]
        log(f"[spans] call {i}: {c['seconds']:.3f} s, iterations "
            f"{c['iterations']}, fused_estimate launches {c['launches']}: "
            f"{'equal' if c['iterations'] == c['launches'] else 'DIFFER'}")
    inp, first = done[0]

    # call 0 again: under the profiler with the tracer off, then on;
    # without the profiler, off, then on
    off_p, off_s, _, _ = spans.profiled(lambda: one_call(state, inp), device)
    n_before = len(tracer.finished)
    on_p, on_s, ops, launches = spans.profiled(
        lambda: one_call(state, inp, tracer), device)
    # the tracer's own cost, off and on twice in turn, without the profiler
    plain = Tracer(max_spans=2 ** 17)
    replays = {"profiled_off": off_p, "profiled_on": on_p,
               "unprofiled_off": one_call(state, inp),
               "unprofiled_on": one_call(state, inp, plain),
               "unprofiled_off_2": one_call(state, inp),
               "unprofiled_on_2": one_call(state, inp,
                                           Tracer(max_spans=2 ** 17))}
    for name, r in replays.items():
        log(f"[spans] replay {name}: {r['seconds']:.3f} s, iterations "
            f"{r['iterations']}, launches {r['launches']}, answers equal to "
            f"call 0's: {same(r, first)}")

    exported = tracer.to_dicts()
    mapped = spans.mapped_spans(exported[n_before:], tracer.anchors)
    build_mapped = spans.mapped_spans(build, tracer.anchors)
    att = spans.attribute(mapped, ops, launches)
    iters = spans.iterations(mapped)
    dropped = tracer.n_dropped
    readings = {
        "merge_ms": spans.merge_ms(att["rows"], mapped, dropped),
        "active_row_share": spans.active_row_share(mapped, dropped),
        "host_launch_ms": spans.host_launch_ms(mapped, dropped),
        "build_search_s": spans.build_search_s(build_mapped, dropped),
    }
    # the host's time to issue an iteration without the profiler's
    # per-launch callbacks, and each span's host self time there
    plain_spans = spans.mapped_spans(plain.to_dicts(), plain.anchors)
    unprofiled = {
        "host_launch_ms": spans.host_launch_ms(plain_spans,
                                               plain.n_dropped),
        "table": spans.table(spans.attribute(plain_spans, [], {})["rows"],
                             len(spans.iterations(plain_spans)))}
    log(f"[spans] without the profiler: host_launch_ms "
        f"{unprofiled['host_launch_ms']}")
    for line in unprofiled["table"]:
        log("  " + line)
    if dropped:
        log(f"[spans] the ring dropped {dropped} spans: no readings")
    lines = spans.table(att["rows"], len(iters))
    log(f"[spans] per span, per iteration ({len(iters)} iterations):")
    for line in lines:
        log("  " + line)
    gaps = spans.idle_gaps(att["gaps"])
    log("[spans] idle gaps: " + json.dumps(gaps))
    top_ops = {name: sorted(((op, ns / 1e9) for op, ns in per.items()),
                            key=lambda kv: -kv[1])[:4]
               for name, per in att["device"].items()}
    log("[spans] each span's largest device ops (s): " + json.dumps(top_ops))
    controls = clock_controls(att, mapped, ops, launches)
    log("[spans] clock controls: " + json.dumps(controls))
    phases = {}
    for s in build_mapped:
        phases[s["name"]] = phases.get(s["name"], 0.0) \
            + s["end"] - s["start"]
    log("[spans] build phases (s): " + json.dumps(phases))
    summary = tracing.summarize([o[:3] for o in ops], on_s)
    is_cuda = torch.device(device).type == "cuda"
    return {
        "workload": cell.name, "seed": seed,
        "card": torch.cuda.get_device_name(0) if is_cuda else "cpu",
        "setup_s": setup_s, "readings": readings, "iterations": len(iters),
        "calls": [{k: c[k] for k in ("seconds", "iterations", "launches")}
                  for _, c in done],
        "replays": {k: {"seconds": r["seconds"],
                        "iterations": r["iterations"],
                        "launches": r["launches"], "equal": same(r, first)}
                    for k, r in replays.items()},
        "profiled_window_s": {"off": off_s, "on": on_s},
        "busy_s": summary["busy_s"], "n_device_ops": len(ops),
        "n_dropped": dropped, "anchors": tracer.anchors,
        "drift_ns": spans.drift_ns(tracer.anchors),
        "controls": controls, "table": lines, "idle_gaps": gaps,
        "span_device_ops": top_ops,
        "device_ops": summary["breakdown"]["device_ops"],
        "build_phases_s": phases, "unprofiled": unprofiled,
        "forbidden": forbidden_modules(),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--calls", type=int, default=2)
    ap.add_argument("--out", default="build/trace_spans.json")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(BENCH))
    sys.path.insert(0, str(ROOT / "src"))
    import os
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" /
                                             "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")

    import torch

    from pbench.cell import Cell

    if not torch.cuda.is_available():
        log("trace_spans: needs a CUDA card")
        return 3
    result = run(Cell(args.workload), args.seed, args.calls, "cuda",
                 T_START)
    out = ROOT / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps({k: result[k] for k in
                      ("workload", "seed", "card", "readings", "iterations",
                       "busy_s", "n_dropped", "drift_ns")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
