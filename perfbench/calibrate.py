"""Readings that set the benchmark's limits and sizes, on the card.

    python3 perfbench/calibrate.py --workload synth-d128.batch \
        --seeds 1,2,3,4,5,6,7,8,9,10,11,12 \
        --faults half_stopped,zero_estimates,shuffled,truncated \
        --fault-seeds 1,2,3 \
        --control-seeds 11,12,13
    python3 perfbench/calibrate.py --workload synth-d128.batch --seed 5 \
        --sweep 10000,20000,40000

``--seeds``: the program's sound readings.  One index is built and warmed
up as a run builds it; then for each seed the window's first call of the
cell's own traffic, and the numbers the check compares on its answers
and on the built index.

``--faults`` (``pbench/faults.py``) on ``--fault-seeds``: the same with a
fault planted in the timed path (a loop fault) or in the graph the check
reads (a graph fault); each must fail a limit.

``--control-seeds``: the control, the plain reference put in the program's
place in the precision below the configuration's (float32 with TF32
products), over ``--calls`` calls of the cell's own traffic per seed; each
seed prints the numbers the check compares, which must fail their limits.
The benchmark's own runs never run it.

``--sweep``: one index built from ``--seed``, then at each batch size
(queries a call) one call and its replay under the profiler: the
call's seconds and iterations, and the device's idle share (busy seconds
of the replay over the untraced call's), to choose the cell's batch.

One JSON line per reading on standard output.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from contextlib import nullcontext
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def control_readings(cell, seed: int, calls: int, device) -> dict:
    """The numbers the check compares when the control answers ``calls``
    calls of the cell's traffic under ``seed``."""
    sysmod = cell.system
    state = sysmod.setup(cell.config, seed, device, build=False)
    answered = []
    for i in range(calls):
        inp = sysmod.make_inputs(state, cell.traffic, seed, i)
        out, _ = sysmod.control_call(state, inp, cell.ref)
        answered.append((inp, out))
    result = sysmod.check(state, None, answered, cell.ref, device)
    limits = cell.config["limits"]
    failed = [n for n, v in result["numbers"].items() if v > limits[n]]
    return {"seed": seed, "numbers": result["numbers"], "failed": failed,
            "recall": result["recall"]}


def program_readings(cell, seeds: list[int], faults: list[str],
                     fault_seeds: list[int], device) -> list[dict]:
    """Sound readings on ``seeds``, then each fault on ``fault_seeds``:
    one index, built once.  A graph fault is read on the sound call of its
    seed (the fault is in what the check reads, not in the call)."""
    from pbench import faults as planted

    sysmod = cell.system
    state = sysmod.setup(cell.config, seeds[0] if seeds else 0, device)
    sysmod.warmup(state, cell.traffic, state["seed"])
    snap = sysmod.snapshot(state)
    limits = cell.config["limits"]
    sound = {}

    def answered(seed, loop):
        if loop is None and seed in sound:
            return sound[seed]
        inp = sysmod.make_inputs(state, cell.traffic, seed, 0)
        with (planted.loop_fault(loop) if loop else nullcontext()):
            out, rec = sysmod.call(state, inp)
        if loop is None:
            sound[seed] = inp, out, rec
        return inp, out, rec

    def reading(seed, fault=None):
        state["seed"] = seed
        inp, out, rec = answered(
            seed, fault if fault in planted.LOOP_FAULTS else None)
        seen = planted.graph_fault(snap, fault, seed) \
            if fault in planted.GRAPH_FAULTS else snap
        t0 = time.perf_counter()
        res = sysmod.check(state, seen, [(inp, out)], cell.ref, device)
        nums = res["numbers"]
        return {"seed": seed, "fault": fault, "numbers": nums,
                "failed": [n for n, v in nums.items() if v > limits[n]],
                "recall": res["recall"], "call_s": rec["seconds"],
                "iterations": rec["iterations"],
                "hops_mean": float(out["hops"].float().mean()),
                "check_s": time.perf_counter() - t0}

    rows = [reading(seed) for seed in seeds]
    for fault in faults:
        rows += [reading(seed, fault) for seed in fault_seeds]
    return rows


def sweep(cell, seed: int, sizes: list[int], device) -> list[dict]:
    from pbench import trace as tracing

    sysmod = cell.system
    state = sysmod.setup(cell.config, seed, device)
    sysmod.warmup(state, cell.traffic, seed)
    rows = []
    for size in sizes:
        inp = sysmod.make_inputs(state, cell.traffic, seed, 0, size=size)
        _, rec = sysmod.call(state, inp)
        _, summary = tracing.traced(lambda: sysmod.call(state, inp))
        rows.append({"size": size, "queries": rec["queries"],
                     "seconds": rec["seconds"],
                     "iterations": rec["iterations"],
                     "qps": rec["queries"] / rec["seconds"],
                     "busy_s": summary["busy_s"],
                     "idle_share": 1 - summary["busy_s"] / rec["seconds"],
                     "device_ops": summary["breakdown"]["device_ops"][:5]})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--calls", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sweep", default="")
    ap.add_argument("--seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="1,2,3")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(BENCH))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from pbench.cell import Cell

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 3
    cell = Cell(args.workload)
    card = torch.cuda.get_device_name(0)
    for s in filter(None, args.control_seeds.split(",")):
        t0 = time.perf_counter()
        row = control_readings(cell, int(s), args.calls, "cuda")
        row.update(kind="control", workload=cell.name, card=card,
                   seconds=time.perf_counter() - t0)
        print(json.dumps(row), flush=True)
    def ints(text):
        return [int(x) for x in filter(None, text.split(","))]

    if args.seeds or args.faults:
        t0 = time.perf_counter()
        for row in program_readings(cell, ints(args.seeds),
                                    list(filter(None, args.faults.split(","))),
                                    ints(args.fault_seeds), "cuda"):
            row.update(kind="program", workload=cell.name, card=card,
                       since_start=time.perf_counter() - t0)
            print(json.dumps(row), flush=True)
    if args.sweep:
        for row in sweep(cell, args.seed, [int(x) for x in
                                           args.sweep.split(",")], "cuda"):
            row.update(kind="sweep", workload=cell.name, card=card)
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
