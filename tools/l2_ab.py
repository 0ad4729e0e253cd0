#!/usr/bin/env python3
"""Time the gather-L2 and batched-L2 kernels of this tree against other
versions of their sources, in one process on one card.

    git show <commit>:src/repro_torch/kernels/csrc/gather_l2.cu > build/ab/old/gather_l2.cu
    git show <commit>:src/repro_torch/kernels/csrc/batched_l2.cu > build/ab/old/batched_l2.cu
    python3 tools/l2_ab.py --variant old=build/ab/old

Each ``--variant TAG=DIR`` names a directory holding a ``gather_l2.cu`` and
a ``batched_l2.cu`` (headers they include resolve in DIR first, then in
``src/repro_torch/kernels/csrc``; a copy of ``l2_rows.cuh`` there with
another setting times that setting).  They are built with the port's own
``nvcc`` flags, all at once, into ``build/ab/``.  Every C entry point of
the gather and batched signatures that a library exports is timed at the
shapes of ``chip_smoke.py`` (``GATHER_CASES``, ``batched_cases()``) on its
inputs (a base of 1M rows, input sets over three times the L2, CUDA-graph
replays: ``chip_smoke.device_ms``), and held against the plain versions
(rtol 1e-5, atol 1e-4).  The kernels of one shape are timed in turns, in
order and then in reverse (a, b, …, b, a); a row gives both times a launch
and their mean, and the kernel's own duration from torch.profiler.  A
first row times the harness's floor, a launch that does nothing.  One JSON
line per row goes to stdout and to ``build/l2_ab.jsonl``, after the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the entry points timed where a library exports them: the one-kernel
# entry points of the earliest sources (gather_l2_tiled, batched_l2) and
# the kernels behind each in later ones
GATHER_FNS = ("gather_l2_tiled", "gather_l2_blocks", "gather_l2_rows",
              "gather_l2_ragged")
BATCHED_FNS = ("batched_l2", "batched_l2_blocks", "batched_l2_rows",
               "batched_l2_ragged")


def build(variants: dict) -> dict:
    """{tag: {source name: loaded library}}: this tree's libraries under the
    tag "tree", and each variant's built next to one another."""
    from repro_torch.kernels import _build

    out_dir = ROOT / "build" / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for tag, src_dir in variants.items():
        for name in ("gather_l2", "batched_l2"):
            lib = out_dir / f"{tag}_{name}.so"
            cmd = [_build._nvcc(), *_build._flags(name),
                   "-I", str(_build.CSRC), "-o", str(lib),
                   str(Path(src_dir) / f"{name}.cu")]
            procs.append((tag, name, lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    libs = {"tree": {n: _build.load(n) for n in ("gather_l2", "batched_l2")}}
    for tag, name, lib, proc in procs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {tag}/{name}.cu:\n{text}")
        (out_dir / f"{tag}_{name}.log").write_text(text)
        libs.setdefault(tag, {})[name] = ctypes.CDLL(str(lib))
    return libs


def entry_points(libs: dict, source: str, names: tuple) -> list:
    """[(label, C function)] of every name a library of ``source`` exports."""
    found = []
    for tag, by_source in libs.items():
        for name in names:
            fn = getattr(by_source[source], name, None)
            if fn is not None:
                found.append((f"{tag}:{name}", fn))
    return found


# the kernels behind an entry point, each taking every shape the one
# before it takes (l2dist/ops.py's choice)
KINDS = ("rows", "ragged", "blocks")


def takes(fns: list, picks: str) -> list:
    """The entry points that take a shape for which the wrapper picks
    ``picks``: an earlier source's one-kernel entry point, and each kernel
    of a kind no earlier in ``KINDS`` than the picked one's (the float4
    register kernel only where it is picked, the ragged-d one up to d =
    256)."""
    def kind(name):
        return name.rsplit("_", 1)[1]

    return [(label, fn) for label, fn in fns
            if kind(label) not in KINDS
            or KINDS.index(kind(label)) >= KINDS.index(kind(picks))]


def kernel_ms(torch, call) -> float:
    """Mean duration of the kernels ``call()`` launches, from
    torch.profiler: each kernel's own time on the card, without the gaps
    between launches that ``device_ms`` includes."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    count = sum(e.count for e in kernels)
    return sum(e.self_device_time_total for e in kernels) / 1e3 / max(count, 1)


def timed(cs, torch, calls: dict, sets: int, **fields) -> list:
    """One row per call: ms a launch timed in turns (in order, then in
    reverse: ``turns``), their mean (``ms``), and the kernel's own duration
    (``kernel_ms``).  Each call launches ``sets`` times."""
    labels = list(calls)
    first = {k: cs.device_ms(torch, calls[k]) / sets for k in labels}
    second = {k: cs.device_ms(torch, calls[k]) / sets for k in reversed(labels)}
    return [dict(fields, kernel=k, ms=(first[k] + second[k]) / 2,
                 turns=[first[k], second[k]],
                 kernel_ms=kernel_ms(torch, calls[k])) for k in labels]


def floor_row(cs, torch, card: str) -> dict:
    """The least time a launch takes in the same harness: a graph of
    one-element fills, 100 a replay."""
    tiny = torch.zeros(1, device="cuda")
    ms = cs.device_ms(torch, lambda: [tiny.zero_() for _ in range(100)]) / 100
    return dict(shape="[1]", path="launch floor", kernel="torch fill_",
                ms=ms, card=card)


def gather_rows(cs, torch, libs, card: str) -> list:
    from repro_torch.kernels.l2dist import ops as l2ops
    from repro_torch.kernels.l2dist import ref as l2ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    n = 1_000_000
    bases = {}
    fns = entry_points(libs, "gather_l2", GATHER_FNS)
    for fn in (f for _, f in fns):
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] + \
            [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    rows = []
    for name, B, M, d, path in cs.GATHER_CASES:
        if name != "gather_l2_tiled":
            continue
        if d not in bases:
            bases.clear()                # one 0.5 GB base at a time
            torch.cuda.empty_cache()
            bases[d] = torch.randn((n, d), generator=g, device=dev)
        base = bases[d]
        sets = cs.sets_for(torch, B * M * 4 * d)
        ids = torch.randint(0, n, (sets, B, M), generator=g, device=dev,
                            dtype=torch.int32)
        ids.view(sets, -1)[:, ::7] = -1
        queries = torch.randn((B, d), generator=g, device=dev)
        outs = torch.empty((sets, B, M), device=dev)
        expect = l2ref.gather_l2_ref(base, ids[0], queries)
        ok = ids[0] >= 0
        picks = l2ops.tiled_kernel(base, queries)
        calls, errs = {}, {}
        for label, fn in takes(fns, picks):
            def call(fn=fn, label=label):
                stream = torch.cuda.current_stream().cuda_stream
                for s in range(sets):
                    rc = fn(base.data_ptr(), ids[s].data_ptr(),
                            queries.data_ptr(), outs[s].data_ptr(), n, B, M, d,
                            stream)
                    if rc:
                        raise SystemExit(f"{label} failed to launch: {rc}")
            call()
            torch.cuda.synchronize()
            got = outs[0]
            cs.check(bool(torch.isinf(got[~ok]).all()) and torch.allclose(
                got[ok], expect[ok], rtol=1e-5, atol=1e-4),
                f"{label} [{B},{M}] disagrees with the plain version")
            errs[label] = float((got[ok] - expect[ok]).abs().max())
            calls[label] = call
        uniq = cs.unique_per_set(torch, ids)
        valid = int((ids >= 0).sum()) / sets
        bound_ms, _ = cs.bound(4 * (B * M + uniq * d + B * d + B * M),
                               3 * valid * d)
        for row in timed(cs, torch, calls, sets, shape=f"ids[{B},{M}] d={d}",
                         path=path, bound_ms=bound_ms, card=card,
                         wrapper_picks=picks):
            rows.append(dict(row, max_abs_err=errs[row["kernel"]]))
        del ids, outs
    del base, bases
    torch.cuda.empty_cache()
    return rows


def batched_rows(cs, torch, libs, card: str) -> list:
    from repro_torch.kernels.l2dist import ops as l2ops
    from repro_torch.kernels.l2dist import ref as l2ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    fns = entry_points(libs, "batched_l2", BATCHED_FNS)
    for fn in (f for _, f in fns):
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + \
            [ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    rows = []
    for B, M, d, path in cs.batched_cases():
        sets = cs.sets_for(torch, B * M * d * 4)
        tiles, queries = cs.batched_inputs(torch, g, sets, B, M, d, path)
        outs = torch.empty((sets, B, M), device=dev)
        expect = l2ref.batched_l2_ref(tiles[0], queries[0])
        picks = l2ops.batched_kernel(tiles[0], queries[0])
        calls, errs = {}, {}
        for label, fn in takes(fns, picks):
            def call(fn=fn, label=label):
                stream = torch.cuda.current_stream().cuda_stream
                for s in range(sets):
                    rc = fn(tiles[s].data_ptr(), queries[s].data_ptr(),
                            outs[s].data_ptr(), B, M, d,
                            queries[s].stride(0), stream)
                    if rc:
                        raise SystemExit(f"{label} failed to launch: {rc}")
            call()
            torch.cuda.synchronize()
            cs.check(torch.allclose(outs[0], expect, rtol=1e-5, atol=1e-4),
                     f"{label} [{B},{M},{d}] disagrees with the plain version")
            errs[label] = float((outs[0] - expect).abs().max())
            calls[label] = call
        bound_ms, _ = cs.bound(4 * (B * M * d + B * d + B * M), 3 * B * M * d)
        for row in timed(cs, torch, calls, sets, shape=f"rows[{B},{M},{d}]",
                         path=path, bound_ms=bound_ms, card=card,
                         wrapper_picks=picks):
            rows.append(dict(row, max_abs_err=errs[row["kernel"]]))
        del tiles, queries, outs
    torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", action="append", default=[],
                    metavar="TAG=DIR", help="sources to time beside the tree's")
    args = ap.parse_args(argv)
    variants = dict(v.split("=", 1) for v in args.variant)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("l2_ab: needs an NVIDIA card", file=sys.stderr)
        return 3
    card = cs.card_line()
    print(card)
    libs = build(variants)
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    with open(out / "l2_ab.jsonl", "w") as f:
        for row in ([floor_row(cs, torch, card)]
                    + gather_rows(cs, torch, libs, card)
                    + batched_rows(cs, torch, libs, card)):
            line = json.dumps(row)
            print(line)
            f.write(line + "\n")
    from repro_torch.kernels import _build

    logs = {f"tree_{n}": _build.build_log(n) for n in ("gather_l2", "batched_l2")}
    logs.update((p.stem, p.read_text())
                for p in sorted((ROOT / "build" / "ab").glob("*.log")))
    for tag, text in logs.items():
        print(f"[ptxas] {tag}: " + " | ".join(
            ln.strip() for ln in text.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling" in ln))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
