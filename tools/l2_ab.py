#!/usr/bin/env python3
"""Time the L2 kernels (gather-L2, batched-L2) and the RaBitQ kernels
(bitdot, fused_estimate) of this tree against other versions of their
sources, in one process on one card.

    OLD=5121c10; mkdir -p build/ab/old
    for f in gather_l2.cu batched_l2.cu l2_rows.cuh; do
      git show $OLD:src/repro_torch/kernels/csrc/$f > build/ab/old/$f; done
    python3 tools/l2_ab.py --variant old=build/ab/old

Each ``--variant TAG=DIR`` names a directory holding any of
``gather_l2.cu``, ``batched_l2.cu``, ``bitdot.cu`` and
``fused_estimate.cu`` (headers they include resolve in DIR first, then in
``src/repro_torch/kernels/csrc``; a copy of ``l2_rows.cuh`` or
``rabitq_rows.cuh`` there with another setting times that setting).  They
are built with the port's own ``nvcc`` flags, all at once, into
``build/ab/``.  Every C entry point of the timed signatures that a library
exports is timed at the shapes of ``chip_smoke.py`` on its inputs:
gather_l2 and gather_l2_tiled at ``GATHER_CASES`` (a base of 1M rows),
each case by the kernels that take its shape and the entry point's own
one-kernel C function in an earlier source (``takes``), and batched_l2 at
``batched_cases()``, all held against the plain versions (rtol 1e-5, atol
1e-4; each row also says whether it equals the kernel the wrapper picks
to the bit); bitdot at ``BITDOT_CASES`` (``bitdot_rows`` takes the query line
as it is, an earlier source's ``bitdot`` padded to 32·W: at these shapes
the same line) and fused_estimate at ``ESTIMATE_CASES`` (over
``ESTIMATE_TABLES`` code tables of 1M rows), each held to this tree's
output to the bit.  Input sets hold over three times the L2 and are
replayed in CUDA graphs (``chip_smoke.device_ms``).  The kernels of one
shape are timed in turns, in order and then in reverse (a, b, …, b, a); a
row gives both times a launch and their mean, and the kernel's own
duration from torch.profiler.  A first row times the harness's floor, a
launch that does nothing.  One JSON line per row goes to stdout and to
``build/l2_ab.jsonl``, after the card's name and power limit; then
ptxas's report of each library and, from ``cuobjdump -sass``, each gather-L2
and RaBitQ kernel's barriers and the order of its loads and adds, and of
a gather-L2 kernel's loads, shuffles, barriers and shared-memory accesses
(the listings go to ``build/ab/<tag>_<source>.sass``).
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
# entry points of earlier sources (gather_l2_tiled, gather_l2, batched_l2)
# and the kernels behind each in later ones
GATHER_FNS = ("gather_l2_tiled", "gather_l2", "gather_l2_blocks",
              "gather_l2_rows", "gather_l2_ragged", "gather_l2_row1",
              "gather_l2_ragged1")
BATCHED_FNS = ("batched_l2", "batched_l2_blocks", "batched_l2_rows",
               "batched_l2_ragged")
# bitdot's entry points: an earlier source's takes the query line padded to
# 32·W, this tree's bitdot_rows takes it as it is and d
BITDOT_FNS = ("bitdot", "bitdot_rows")
SOURCES = ("gather_l2", "batched_l2", "bitdot", "fused_estimate")


def build(variants: dict) -> dict:
    """{tag: {source name: loaded library}}: this tree's libraries under the
    tag "tree", and each variant's built next to one another."""
    from repro_torch.kernels import _build

    out_dir = ROOT / "build" / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for tag, src_dir in variants.items():
        for name in SOURCES:
            src = Path(src_dir) / f"{name}.cu"
            if not src.exists():
                continue
            lib = out_dir / f"{tag}_{name}.so"
            cmd = [_build._nvcc(), *_build._flags(name),
                   "-I", str(_build.CSRC), "-o", str(lib), str(src)]
            procs.append((tag, name, lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    _build.build_all(SOURCES)
    libs = {"tree": {n: _build.load(n) for n in SOURCES}}
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
            fn = getattr(by_source.get(source), name, None)
            if fn is not None:
                found.append((f"{tag}:{name}", fn))
    return found


# the kernels behind each entry point, each taking every shape the one
# before it takes (l2dist/ops.py's choice)
KINDS = {"gather_l2_tiled": ("rows", "ragged", "blocks"),
         "gather_l2": ("row1", "ragged1", "blocks"),
         "batched_l2": ("rows", "ragged", "blocks")}


def takes(fns: list, entry: str, picks: str) -> list:
    """The C functions that take a shape at which the wrapper of ``entry``
    picks ``picks``: an earlier source's one-kernel function named
    ``entry``, and each kernel of ``entry`` of a kind no earlier in its
    ``KINDS`` than the picked one's (the float4 register kernel only where
    it is picked, the ragged-d one up to d = 256)."""
    prefix = entry.removesuffix("_tiled") + "_"
    kinds = KINDS[entry]
    names = {entry} | {prefix + k for k in
                       kinds[kinds.index(picks.removeprefix(prefix)):]}
    return [(label, fn) for label, fn in fns
            if label.split(":", 1)[1] in names]


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
        picks = (l2ops.tiled_kernel if name == "gather_l2_tiled"
                 else l2ops.one_row_kernel)(base, queries)
        calls, errs, bits = {}, {}, {}
        for label, fn in takes(fns, name, picks):
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
            bits[label] = got.view(torch.int32).clone()
            calls[label] = call
        tree = bits[f"tree:{picks}"]
        uniq = cs.unique_per_set(torch, ids)
        valid = int((ids >= 0).sum()) / sets
        bound_ms, _ = cs.bound(4 * (B * M + uniq * d + B * d + B * M),
                               3 * valid * d)
        for row in timed(cs, torch, calls, sets, shape=f"ids[{B},{M}] d={d}",
                         path=path, bound_ms=bound_ms, card=card, entry=name,
                         wrapper_picks=picks):
            rows.append(dict(row, max_abs_err=errs[row["kernel"]],
                             bitwise_equal_to_picked=bool(torch.equal(
                                 bits[row["kernel"]], tree))))
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
        calls, errs, bits = {}, {}, {}
        for label, fn in takes(fns, "batched_l2", picks):
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
            bits[label] = outs[0].view(torch.int32).clone()
            calls[label] = call
        tree = bits[f"tree:{picks}"]
        bound_ms, _ = cs.bound(4 * (B * M * d + B * d + B * M), 3 * B * M * d)
        for row in timed(cs, torch, calls, sets, shape=f"rows[{B},{M},{d}]",
                         path=path, bound_ms=bound_ms, card=card,
                         entry="batched_l2", wrapper_picks=picks):
            rows.append(dict(row, max_abs_err=errs[row["kernel"]],
                             bitwise_equal_to_picked=bool(torch.equal(
                                 bits[row["kernel"]], tree))))
        del tiles, queries, outs
    torch.cuda.empty_cache()
    return rows


def bitdot_ab(cs, torch, libs, card: str) -> list:
    from repro_torch.kernels.bitdot import ref as bitdot_ref

    g = torch.Generator(device="cuda").manual_seed(2)
    fns = entry_points(libs, "bitdot", BITDOT_FNS)
    for label, fn in fns:
        ints = 3 if label.endswith(":bitdot") else 4
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * ints + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    rows = []
    for B, K, path in cs.BITDOT_CASES:
        codes, q = cs.bitdot_inputs(torch, g, B, K)
        sets, W = codes.shape[0], codes.shape[-1]
        outs = torch.empty((sets, B, K), device="cuda")
        calls, got = {}, {}
        for label, fn in fns:
            d = () if label.endswith(":bitdot") else (q.shape[1],)

            def call(fn=fn, label=label, d=d):
                stream = torch.cuda.current_stream().cuda_stream
                for s in range(sets):
                    rc = fn(codes[s].data_ptr(), q.data_ptr(),
                            outs[s].data_ptr(), B, K, W, *d, stream)
                    if rc:
                        raise SystemExit(f"{label} failed to launch: {rc}")
            call()
            torch.cuda.synchronize()
            got[label] = outs[0].clone()
            calls[label] = call
        tree = got["tree:bitdot_rows"]
        cs.check(torch.equal(tree, bitdot_ref.s_plus_kernel_order(codes[0], q)),
                 f"tree:bitdot_rows [{B},{K},{W}] is not the kernel-order sum")
        for label, out in got.items():
            cs.check(torch.equal(out, tree), f"{label} [{B},{K},{W}] is not "
                     "this tree's bitdot_rows to the bit")
        err = float((tree - bitdot_ref.bitdot_ref(codes[0], q)).abs().max())
        bound_ms, _ = cs.bitdot_bound(torch, codes, q)
        rows += timed(cs, torch, calls, sets, shape=f"codes[{B},{K},{W}]",
                      path=path, bound_ms=bound_ms, card=card,
                      max_abs_err=err, bitwise_equal_to_tree=True)
        del codes, outs
    torch.cuda.empty_cache()
    return rows


def estimate_ab(cs, torch, libs, card: str) -> list:
    from repro_torch.kernels.bitdot import ref as bitdot_ref

    g = torch.Generator(device="cuda").manual_seed(3)
    n = 1_000_000
    fns = entry_points(libs, "fused_estimate", ("fused_estimate",))
    for _, fn in fns:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int64] + \
            [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    rows = []
    for B, K, W, d, path in cs.ESTIMATE_CASES:
        tables, ids, args = cs.estimate_inputs(torch, g, n, B, K, W, d)
        sets = ids.shape[0]
        outs = torch.empty((sets, B, K), device="cuda")
        calls, got = {}, {}
        for label, fn in fns:
            def call(fn=fn, label=label):
                stream = torch.cuda.current_stream().cuda_stream
                for s in range(sets):
                    rc = fn(*(t.data_ptr() for t in args(s)),
                            outs[s].data_ptr(), n, B, K, W, d, stream)
                    if rc:
                        raise SystemExit(f"{label} failed to launch: {rc}")
            call()
            torch.cuda.synchronize()
            got[label] = outs[0].view(torch.int32).clone()
            calls[label] = call
        tree = got["tree:fused_estimate"]
        cs.check(torch.equal(tree, bitdot_ref.fused_estimate_kernel_order(
            *args(0)).view(torch.int32)), f"tree:fused_estimate [{B},{K}] "
            f"W={W} is not the kernel-order estimate")
        for label, out in got.items():
            cs.check(torch.equal(out, tree), f"{label} [{B},{K}] W={W} is "
                     "not this tree's fused_estimate to the bit")
        _, bound_ms, _ = cs.estimate_costs(torch, tables, ids, d)
        rows += timed(cs, torch, calls, sets,
                      shape=f"ids[{B},{K}] codes[{n},{W}] d={d}", path=path,
                      bound_ms=bound_ms, card=card,
                      bitwise_equal_to_tree=True)
        del tables, ids, args, outs
    torch.cuda.empty_cache()
    return rows


# the memory and exchange instructions a gather-L2 kernel's ``order`` lists
ORDER_OPS = ("LDG", "SHFL", "BAR", "LDS", "STS", "STG")


def sass_report(tag: str, source: str, lib: Path) -> str:
    """From ``cuobjdump -sass`` of a gather-L2 or RaBitQ library: each
    kernel's barriers; outside its loops (a backward branch and its target
    bound one), its global loads before its first float add and after it;
    its loads inside loops; and its shuffles and adds.  For gather-L2 also
    its ``order``: its global loads, shuffles, barriers, shared-memory
    accesses and stores in address order, a run of one kind as ``OPxN`` and
    a loop in brackets (the one-row register kernels read ``LDGx2 SHFL
    LDG …``: the id and the query line at once, the id handed to the lanes,
    then the row).  The listing goes to ``build/ab/<tag>_<source>.sass``."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=120)
    if sass.returncode != 0:
        return f"[sass] {tag}_{source}: cuobjdump exit {sass.returncode}"
    (ROOT / "build" / "ab" / f"{tag}_{source}.sass").write_text(sass.stdout)
    kernels, ops = {}, None
    inst = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)"
                      r"(?:\s+(0x[0-9a-f]+|`\(\.L_x_\d+\)))?")
    for line in sass.stdout.splitlines():
        if "Function :" in line:
            ops = kernels.setdefault(line.split("Function :")[1].strip(), [])
        elif ops is not None and (m := inst.search(line)):
            target = m.group(3)
            ops.append((int(m.group(1), 16), m.group(2).split(".")[0],
                        int(target, 16) if target and target.startswith("0x")
                        else None))
    parts = []
    for name, ops in kernels.items():
        loops = [(t, a) for a, op, t in ops
                 if op == "BRA" and t is not None and t <= a]
        straight = [op for a, op, _ in ops
                    if not any(lo <= a <= hi for lo, hi in loops)]
        first_add = (straight.index("FADD") if "FADD" in straight
                     else len(straight))
        names = [op for _, op, _ in ops]
        order = ""
        if source == "gather_l2":
            seq = []
            for a, op, _ in ops:
                if any(lo == a for lo, _ in loops):
                    seq.append(["[", 1])
                if op in ORDER_OPS:
                    if seq and seq[-1][0] == op:
                        seq[-1][1] += 1
                    else:
                        seq.append([op, 1])
                if any(hi == a for _, hi in loops):
                    seq.append(["]", 1])
            order = "; order " + " ".join(
                op if k == 1 else f"{op}x{k}" for op, k in seq)
        parts.append(
            f"{name}: BAR {names.count('BAR')}; outside loops LDG "
            f"{straight[:first_add].count('LDG')} before the first FADD, "
            f"{straight[first_add:].count('LDG')} after it; in loops LDG "
            f"{names.count('LDG') - straight.count('LDG')}; SHFL "
            f"{names.count('SHFL')}, FADD {names.count('FADD')}, "
            f"{len(ops)} instructions{order}")
    return f"[sass] {tag}_{source}: " + " | ".join(parts)


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
                    + batched_rows(cs, torch, libs, card)
                    + bitdot_ab(cs, torch, libs, card)
                    + estimate_ab(cs, torch, libs, card)):
            line = json.dumps(row)
            print(line)
            f.write(line + "\n")
    from repro_torch.kernels import _build

    logs = {f"tree_{n}": _build.build_log(n) for n in SOURCES}
    logs.update((p.stem, p.read_text())
                for p in sorted((ROOT / "build" / "ab").glob("*.log")))
    for tag, text in logs.items():
        print(f"[ptxas] {tag}: " + " | ".join(
            ln.strip() for ln in text.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling" in ln))
    for source in ("gather_l2", "bitdot", "fused_estimate"):
        print(sass_report("tree", source, _build.library_path(source)))
        for tag in variants:
            lib = ROOT / "build" / "ab" / f"{tag}_{source}.so"
            if lib.exists():
                print(sass_report(tag, source, lib))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
