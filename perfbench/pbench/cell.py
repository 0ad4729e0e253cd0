"""One run of one cell: find its files by the names in ``BENCHMARK.json``,
set it up, warm it up, measure a window of back-to-back calls, optionally
replay the window's first call under the profiler, check every answer
against the plain reference and print the result line.

The files a cell is made of, each found by its name:

* ``configs/<config>.json``: the configuration as it is run; its
  ``system`` names the module that serves it, its ``limits`` the limit of
  each number the check compares;
* ``configs/<config>.ref.py``: its plain reference;
* ``systems/<system>.py``: how the port serves that configuration
  (``setup``, ``make_inputs``, ``warmup``, ``call``, ``snapshot``,
  ``check``, ``control_call``, ``PROGRAM_STATE``);
* ``traffic/<traffic>.json``: the traffic's parameters, read by the
  system's ``make_inputs``;
* ``metrics/<metric>.py``: a per-layer metric's reader, ``read(ctx)``, and
  for a roofline its ``HOOK`` and ``launch_bytes``.

A later cell, configuration, traffic or metric is a new entry in
``BENCHMARK.json`` and new files; nothing here names one.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ident(name: str) -> str:
    return "".join(c if c.isalnum() else "_" for c in name)


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


class Cell:
    """Everything one workload of ``BENCHMARK.json`` is made of."""

    def __init__(self, workload: str, bench_dir: Path = BENCH):
        spec = json.loads((bench_dir.parent / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in spec["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                           f"(there are {sorted(cells)})")
        self.workload = cells[workload]
        cname = self.workload["config"]
        self.config = json.loads((bench_dir / "configs" / f"{cname}.json")
                                 .read_text())
        self.traffic = json.loads(
            (bench_dir / "traffic" / f"{self.workload['traffic']}.json")
            .read_text())
        self.system = load_module(
            bench_dir / "systems" / f"{self.config['system']}.py",
            f"perfbench_system_{_ident(self.config['system'])}")
        self.ref = load_module(bench_dir / "configs" / f"{cname}.ref.py",
                               f"perfbench_ref_{_ident(cname)}")
        self.end_to_end = [m for m in spec["end_to_end"]
                           if applies(m, workload)]
        self.per_layer = [m for m in spec["per_layer"]
                          if applies(m, workload)]
        self.readers = {
            m["name"]: load_module(bench_dir / "metrics" / f"{m['name']}.py",
                                   f"perfbench_metric_{_ident(m['name'])}")
            for m in self.per_layer}

    @property
    def name(self) -> str:
        return self.workload["name"]


def window(cell: Cell, state: dict, seed: int, seconds: float):
    """Closed loop: one caller issues the next call when the last returns,
    until ``seconds`` have passed; the call running then completes and
    counts, and the window ends at its end.  Returns (calls as (inputs,
    outputs), records, the window's seconds)."""
    sysmod, traffic = cell.system, cell.traffic
    calls, recs = [], []
    t0 = time.perf_counter()
    while True:
        inp = sysmod.make_inputs(state, traffic, seed, len(calls))
        out, rec = sysmod.call(state, inp)
        calls.append((inp, out))
        recs.append(rec)
        if time.perf_counter() - t0 >= seconds:
            break
    return calls, recs, time.perf_counter() - t0


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, log=print) -> dict:
    """One run; returns the result line as a dict (``checks`` last)."""
    import torch

    from . import launches
    from . import trace as tracing

    sysmod = cell.system
    state = sysmod.setup(cell.config, seed, device)
    sysmod.warmup(state, cell.traffic, seed)
    launches.sync(device)
    setup_s = time.perf_counter() - t_start
    log(f"[perfbench] {cell.name}: set-up {setup_s:.3f} s")

    calls, recs, window_s = window(cell, state, seed, seconds)
    for (_, out), rec in zip(calls, recs):
        if "hops" in out:
            rec["hops_sum"] = int(out["hops"].sum())
    queries = sum(r["queries"] for r in recs)
    log(f"[perfbench] {cell.name}: {len(recs)} calls, {queries} queries in "
        f"{window_s:.3f} s")
    ctx = {"calls": recs, "window_s": window_s, "trace": None, "bytes": None}
    line = {}
    if trace:
        # the window's first call again, under the profiler, then once more
        # with its launches' bytes counted: the search is deterministic, so
        # both replays do the device work the untraced call did
        inp, first = calls[0]
        (out, _), summary = tracing.traced(lambda: sysmod.call(state, inp))
        summary["untraced_s"] = recs[0]["seconds"]
        same = all(torch.equal(out[k], first[k]) for k in ("ids", "dists"))
        hooked = {n: m for n, m in cell.readers.items() if hasattr(m, "HOOK")}
        with launches.counting(hooked) as totals:
            sysmod.call(state, inp)
        ctx.update(trace=summary, bytes=totals)
        log(f"[perfbench] traced replay of call 0: {summary['window_s']:.3f}"
            f" s (untraced {recs[0]['seconds']:.3f} s), "
            f"{summary['n_device_ops']} device ops, busy "
            f"{summary['busy_s']:.3f} s; profiler stop "
            f"{summary['stop_s']:.3f} s, reading {summary['read_s']:.3f} s;"
            f" answers equal to call 0's: {same}; bytes counted "
            f"{json.dumps(totals)}")
    is_cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if is_cuda else 0

    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = cell.readers[m["name"]].read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        for note in ctx.get("notes", []):
            log(f"[perfbench] {note}")

    snap = sysmod.snapshot(state)
    for key in sysmod.PROGRAM_STATE:
        state.pop(key, None)
    gc.collect()
    if is_cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    result = sysmod.check(state, snap, calls, cell.ref, device)
    log(f"[perfbench] check: {time.perf_counter() - t_check:.3f} s over "
        f"{result['attempted']} queries")

    if not trace:
        e2e = {"qps": queries / window_s, "recall": result["recall"],
               "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    limits = cell.config["limits"]
    checks = {name: {"value": value, "limit": limits[name]}
              for name, value in result["numbers"].items()}
    correct = result["attempted"] > 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    line.update(correct=correct, attempted=result["attempted"],
                failed=result["failed"], metrics=metrics)
    line["device"] = {
        "platform": "gpu" if is_cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if is_cuda else "cpu",
        "count": cell.workload["chips"], "memory_peak_bytes": peak}
    if trace:
        line["device"].update(busy_s=ctx["trace"]["busy_s"],
                              window_s=ctx["trace"]["window_s"])
        line["breakdown"] = ctx["trace"]["breakdown"]
    line["checks"] = checks
    return line


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that are JAX or the JAX package,
    compared whole (``repro_torch`` is the port, not ``repro``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))
