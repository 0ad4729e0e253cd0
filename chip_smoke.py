#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # serve phase at n = 500,000, d = 128
    python3 chip_smoke.py --n 1000000   # the SIFT1M shape, the target

The serve phase's n is cut from the SIFT1M target of 1,000,000 to
500,000: at 1M the build alone took 740.6 s on an H100 80GB HBM3 at
700 W and the whole run 808 s, over half of the 1200 s a smoke run may
take.  The kernel phase always uses the 1M base.

Phases, each of which raises on a failed check (the script then exits
non-zero and prints no result line):

1. set-up   — torch, the card's name and power limit, and the build of
               every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one
               ``nvcc`` per source, all started together);
2. kernels  — ``gather_l2``, ``gather_l2_tiled`` and ``bitdot`` against
               their plain PyTorch versions on the same card tensors, at
               the shapes each path below gives them (base 1M × 128; ids
               [128, 1] in the drain, [1024, 24] in the build's searches,
               [128, 24] in the exact searches; codes [128, 24, 4] in the
               probe phase; and W = 4's [128, 96]), then timed with CUDA
               events over input sets that hold twice the card's L2;
3. serve    — the port's ``launch.serve`` path: ``build_emqg`` on the card
               and ``AnnServer.drain`` over 512 queries; the served
               distances are the exact ones, the ids those of the plain
               path on the same card, and recall@10 is printed;
4. probe    — ``probing_search(use_kernel=True)`` (the bitdot kernel)
   exact      and ``search`` with ``backend="kernel"`` / ``"kernel_tiled"``
               against their plain paths, on the same index;
5. profile  — ``torch.profiler`` over one served batch of 128 queries
               with max_hops = 128 and over one 1024-node candidate
               search of the build, on the same index; one JSON line each (device busy share, kernel
               launches, ms per hop), and the operator tables written to
               ``build/profile/`` under the checkout.

Every kernel's launch count is set to 0 just before the path that runs it
and read just after; a kernel that path never launched fails the run.  The
``kernels`` line reports each kernel at the shape of the path whose launch
count it prints.  The line before the last is the card; the one before it
the ``kernels`` JSON; the last line is the device JSON.  It needs one card
and exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_FLOP_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
SERVE_PARAMS = dict(k=10, l0=10, l_max=256, alpha=1.2, adaptive=True,
                    max_hops=2048)
BUILD_PARAMS = dict(max_degree=24, beam_width=64, t=32, iters=2, block=1024,
                    align_degree=True)
MIN_AGREE = 0.99
PROFILE_HOPS = 128             # max_hops of the batch under the profiler
TARGET_N = 1_000_000           # SIFT1M's shape
SERVE_N = TARGET_N // 2        # halved to fit the run's time limit


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def device_ms(torch, fn, reps: int = 20) -> float:
    """Mean device time of one ``fn()`` call: ``fn`` is captured once into a
    CUDA graph and replayed ``reps`` times between two events, so the host's
    per-call cost is out of the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """(ms, what bounds it): the least time the card could take for the
    bytes moved and the float32 operations done, the larger of the two."""
    by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    by_ops = 1e3 * flops / FP32_FLOP_PER_S
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def agree(a, b) -> float:
    """Share of rows (queries) whose id lists are identical."""
    return float((a == b).all(1).float().mean())


def sets_for(torch, bytes_per_set: float) -> int:
    """How many distinct input sets a timed loop cycles through: enough that
    together they hold three times the card's L2 cache (collisions and
    invalid ids take some back), so a replay reads from device memory."""
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    return max(1, int(-(-3 * l2 // bytes_per_set)))


def check_misses_l2(torch, name: str, footprint: int) -> None:
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    check(footprint >= 2 * l2, f"{name}: timed inputs hold {footprint} bytes, "
          f"under twice the {l2}-byte L2")


# (kernel, B, M, the path that gives it this shape)
GATHER_CASES = (
    ("gather_l2_tiled", 128, 1, "drain"),            # start and probes: [B, W]
    ("gather_l2_tiled", 1024, 24, "build"),          # searches: [block, W·M]
    ("gather_l2_tiled", 128, 24, "exact_kernel_tiled"),
    ("gather_l2_tiled", 128, 96, "W=4, no path here"),
    ("gather_l2", 128, 24, "exact_kernel"),
    ("gather_l2", 128, 96, "W=4, no path here"),
)
# (B, K = W·M, path) of the bitdot launch: the expand branch's estimates
BITDOT_CASES = ((128, 24, "probe"), (128, 96, "W=4, no path here"))
# each kernel's row in the kernels line: the path whose launches it reports
REPORTED = {"gather_l2_tiled": "drain", "gather_l2": "exact_kernel",
            "bitdot": "probe"}


def kernel_phase(torch, card: str):
    from repro_torch.kernels.bitdot import ops as bitdot_ops
    from repro_torch.kernels.bitdot import ref as bitdot_ref
    from repro_torch.kernels.l2dist import ops as l2ops
    from repro_torch.kernels.l2dist import ref as l2ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    n, d = 1_000_000, 128
    base = torch.randn((n, d), generator=g, device=dev)
    replaces = {"gather_l2": "src/repro/kernels/l2dist/l2dist.py:87",
                "gather_l2_tiled": "src/repro/kernels/l2dist/l2dist.py:145"}
    rows = {}
    for name, B, M, path in GATHER_CASES:
        sets = sets_for(torch, B * M * 4 * d)
        ids = torch.randint(0, n, (sets, B, M), generator=g, device=dev,
                            dtype=torch.int32)
        ids.view(sets, -1)[:, ::7] = -1      # some invalid slots in every set
        queries = torch.randn((B, d), generator=g, device=dev)
        fn = getattr(l2ops, name)
        out = fn(base, ids[0], queries)
        torch.cuda.synchronize()
        expect = l2ref.gather_l2_ref(base, ids[0], queries)
        check(bool(torch.isinf(out[ids[0] < 0]).all()),
              f"{name}: invalid ids must give +inf")
        ok = ids[0] >= 0
        err = float((out[ok] - expect[ok]).abs().max())
        check(torch.allclose(out[ok], expect[ok], rtol=1e-5, atol=1e-4),
              f"{name} [{B},{M}] disagrees with its plain version: {err}")

        def run_kernel(fn=fn, ids=ids, queries=queries):
            for s in range(sets):
                fn(base, ids[s], queries)

        def run_plain(ids=ids, queries=queries):
            for s in range(sets):
                l2ref.gather_l2_ref(base, ids[s], queries)

        flat = ids.view(sets, -1).sort(1).values
        first = torch.ones_like(flat, dtype=torch.bool)
        first[:, 1:] = flat[:, 1:] != flat[:, :-1]
        uniq = int((first & (flat >= 0)).sum()) / sets    # rows a launch reads
        footprint = 4 * d * int(torch.unique(ids[ids >= 0]).numel())
        check_misses_l2(torch, f"{name} [{B},{M}]", footprint)
        ms = device_ms(torch, run_kernel) / sets
        plain_ms = device_ms(torch, run_plain) / sets
        valid = int((ids >= 0).sum()) / sets
        nbytes = 4 * (B * M + uniq * d + B * d + B * M)
        bound_ms, bound_by = bound(nbytes, 3 * valid * d)
        rows[(name, path)] = dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/gather_l2.cu",
            replaces=replaces[name], path=path,
            shape=f"ids[{B},{M}] base[{n},{d}]", max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None, timed_sets=sets, timed_mb=footprint / 1e6)
        del ids

    W = 4
    shifts = torch.arange(32, device=dev, dtype=torch.int32)
    for B, K, path in BITDOT_CASES:
        sets = sets_for(torch, B * K * W * 4)
        codes = torch.randint(-2**31, 2**31 - 1, (sets, B, K, W), generator=g,
                              device=dev, dtype=torch.int32)
        q_unit = torch.randn((B, 32 * W), generator=g, device=dev)
        out = bitdot_ops.bitdot(codes[0], q_unit)
        torch.cuda.synchronize()
        expect = bitdot_ref.bitdot_ref(codes[0], q_unit)
        err = float((out - expect).abs().max())
        check(torch.allclose(out, expect, rtol=1e-5, atol=1e-4),
              f"bitdot [{B},{K},{W}] disagrees with its plain version: {err}")
        footprint = codes.numel() * 4
        check_misses_l2(torch, f"bitdot [{B},{K},{W}]", footprint)
        ms = device_ms(torch, lambda: [bitdot_ops.bitdot(codes[s], q_unit)
                                       for s in range(sets)]) / sets
        plain_ms = device_ms(torch, lambda: [
            bitdot_ref.bitdot_ref(codes[s], q_unit) for s in range(sets)]) / sets
        set_bits = sum(int(((c[..., None] >> shifts) & 1).sum())
                       for c in codes.split(64)) / sets
        # one add of q[32w + j] for each set bit j of each word w
        bound_ms, bound_by = bound(4 * (B * K * W + B * 32 * W + B * K),
                                   set_bits)
        rows[("bitdot", path)] = dict(
            name="bitdot", route="cuda",
            source="src/repro_torch/kernels/csrc/bitdot.cu",
            replaces="src/repro/kernels/bitdot/bitdot.py:45", path=path,
            shape=f"codes[{B},{K},{W}] q[{B},{32 * W}]", max_abs_err=err,
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None, timed_sets=sets, timed_mb=footprint / 1e6)
        del codes
    del base
    torch.cuda.empty_cache()
    for r in rows.values():
        print(f"[kernel] {r['name']} {r['shape']} ({r['path']}): err "
              f"{r['max_abs_err']:.3g} ms {r['ms']:.5f} plain_ms "
              f"{r['plain_ms']:.5f} bound_ms {r['bound_ms']:.5f} "
              f"({r['bound_by']}); {r['timed_sets']} sets, "
              f"{r['timed_mb']:.1f} MB ({card})")
    return rows


def serve_phase(torch, n: int, card: str):
    from repro_torch.core import BuildParams, SearchParams, build_emqg
    from repro_torch.core import probing_search
    from repro_torch.core.distances import brute_force_knn
    from repro_torch.data import clustered_vectors
    from repro_torch.kernels.l2dist import ops as l2ops
    from repro_torch.serve import AnnServer

    d = 128
    base = clustered_vectors(n, d, 48, seed=0)
    queries = clustered_vectors(512, d, 48, seed=1)
    counts = {}

    l2ops.LAUNCHES.update(gather_l2=0, gather_l2_tiled=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx = build_emqg(base, BuildParams(**BUILD_PARAMS),
                     generator=torch.Generator().manual_seed(0),
                     verbose=True, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    counts["build"] = dict(l2ops.LAUNCHES)
    deg = idx.graph.degrees().float()
    print(f"[serve] built δ-EMQG n={n} d={d} in {build_s:.1f} s, mean degree "
          f"{float(deg.mean()):.2f}, gather_l2_tiled launches "
          f"{counts['build']['gather_l2_tiled']} ({card})")
    check(counts["build"]["gather_l2_tiled"] > 0,
          "the build's searches never launched gather_l2_tiled")

    srv = AnnServer(idx, SearchParams(**SERVE_PARAMS), max_batch=128,
                    buckets=(32, 128), device="cuda")
    l2ops.LAUNCHES.update(gather_l2=0, gather_l2_tiled=0)
    srv.submit_many(queries)
    out = srv.drain()
    counts["drain"] = dict(l2ops.LAUNCHES)
    check(counts["drain"]["gather_l2_tiled"] > 0,
          "AnnServer.drain never launched gather_l2_tiled")
    ids = torch.as_tensor(np.stack([o[0] for o in out]))
    dists = torch.as_tensor(np.stack([o[1] for o in out]))
    check(tuple(ids.shape) == (512, 10) and bool(torch.isfinite(dists).all()),
          "served results are not 512 × 10 finite distances")

    vq = torch.as_tensor(queries, device="cuda")
    ids_d = ids.to("cuda").long()
    exact = torch.linalg.norm(idx.graph.vectors[ids_d] - vq[:, None, :], dim=-1)
    check(torch.allclose(dists.to("cuda"), exact, rtol=1e-4, atol=1e-4),
          "served distances are not the exact distances of the served ids")

    plain = probing_search(idx, vq, SearchParams(**SERVE_PARAMS), backend="jnp")
    share = agree(plain.ids.cpu(), ids)
    check(share >= MIN_AGREE,
          f"served ids match the plain path on {share:.4f} of queries")
    _, gt = brute_force_knn(vq, idx.graph.vectors, 10)
    gt = gt.cpu()
    recall = float(sum(len(set(a.tolist()) & set(b.tolist()))
                       for a, b in zip(ids, gt))) / ids.numel()
    s = srv.stats
    # one gather_l2_tiled launch per hop, plus one per batch for the start
    hops = counts["drain"]["gather_l2_tiled"] - s.n_batches
    ms_per_hop = s.total_search_s * 1e3 / max(hops, 1)
    print(f"[serve] n={n}: {s.n_requests} requests in {s.n_batches} batches; "
          f"recall@10={recall:.4f}; QPS={s.qps:.1f}; max latency "
          f"{s.max_latency_s * 1e3:.1f} ms; {hops} hops at {ms_per_hop:.3f} "
          f"ms a hop; ids equal to the plain path on {share:.4f} of "
          f"queries; gather_l2_tiled launches in drain "
          f"{counts['drain']['gather_l2_tiled']} ({card})")
    return idx, vq, dict(n=n, build_s=build_s, recall=recall, qps=s.qps,
                         max_latency_ms=s.max_latency_s * 1e3,
                         drain_s=s.total_search_s, hops=hops,
                         ms_per_hop=ms_per_hop), counts


def probe_exact_phase(torch, idx, vq, card: str, counts: dict) -> None:
    from repro_torch.core import SearchParams, probing_search, search
    from repro_torch.kernels.bitdot import ops as bitdot_ops
    from repro_torch.kernels.l2dist import ops as l2ops

    q = vq[:128]
    p = SearchParams(**SERVE_PARAMS)
    plain = probing_search(idx, q, p, use_kernel=False)
    bitdot_ops.LAUNCHES["bitdot"] = 0
    kern = probing_search(idx, q, p, use_kernel=True)
    torch.cuda.synchronize()
    counts["probe"] = dict(bitdot_ops.LAUNCHES)
    check(counts["probe"]["bitdot"] > 0,
          "probing_search(use_kernel=True) never launched bitdot")
    share = agree(kern.ids, plain.ids)
    check(share >= MIN_AGREE,
          f"use_kernel=True ids match use_kernel=False on {share:.4f}")
    print(f"[probe] bitdot launches {counts['probe']['bitdot']}; ids equal "
          f"to use_kernel=False on {share:.4f} of 128 queries ({card})")

    ref = search(idx.graph, q, p, backend="jnp")
    for backend, name in (("kernel", "gather_l2"),
                          ("kernel_tiled", "gather_l2_tiled")):
        l2ops.LAUNCHES.update(gather_l2=0, gather_l2_tiled=0)
        res = search(idx.graph, q, p, backend=backend)
        torch.cuda.synchronize()
        counts[f"exact_{backend}"] = dict(l2ops.LAUNCHES)
        check(l2ops.LAUNCHES[name] > 0, f"search(backend={backend!r}) "
              f"never launched {name}")
        share = agree(res.ids, ref.ids)
        check(share >= MIN_AGREE,
              f"search backend={backend} ids match jnp on {share:.4f}")
        print(f"[exact] backend={backend}: {name} launches "
              f"{l2ops.LAUNCHES[name]}; ids equal to jnp on {share:.4f} of "
              f"128 queries ({card})")


def _device_us(torch, event) -> float:
    """Device time of a kernel or copy row; 0 for a host row (whose
    ``self_device_time_total`` repeats its kernels' time)."""
    if event.device_type != torch.autograd.DeviceType.CUDA:
        return 0.0
    return float(event.self_device_time_total)


def _profiled(torch, fn, phase: str, out: Path) -> dict:
    from repro_torch.kernels.l2dist import ops as l2ops

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    hops0 = l2ops.LAUNCHES["gather_l2_tiled"]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    avgs = prof.key_averages()
    device_us = sum(_device_us(torch, e) for e in avgs)
    launches = sum(e.count for e in avgs
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cudaLaunchKernelExC"))
    # one gather_l2_tiled launch per hop, plus one for the start distance
    hops = l2ops.LAUNCHES["gather_l2_tiled"] - hops0 - 1
    out.mkdir(parents=True, exist_ok=True)
    (out / f"profile_{phase}.txt").write_text(
        avgs.table(sort_by="self_cpu_time_total", row_limit=40) + "\n"
        + avgs.table(sort_by="self_device_time_total", row_limit=25))
    return dict(phase=phase, wall_ms=wall_s * 1e3,
                device_ms=device_us / 1e3 if device_us else None,
                device_busy=(device_us / 1e6 / wall_s) if device_us else None,
                hops=hops, kernel_launches=launches,
                ms_per_hop=wall_s * 1e3 / max(hops, 1))


def profile_phase(torch, idx, vq, out: Path, card: str) -> None:
    """Where a hop's time goes: ``torch.profiler`` over one served batch of
    128 queries with ``max_hops = PROFILE_HOPS`` (the profiler's own
    processing of a whole batch's ~300k launches took minutes), and over
    one 1024-node candidate search of the build (the build's own search
    parameters), on the served index.  The device's busy share is its
    kernel and copy time over the wall time (one stream, so the intervals
    do not overlap); the profiler's own cost is in that wall time."""
    from repro_torch.core import BuildParams, SearchParams, search
    from repro_torch.serve import AnnServer

    bp = BuildParams(**BUILD_PARAMS)
    srv = AnnServer(idx, SearchParams(**{**SERVE_PARAMS,
                                         "max_hops": PROFILE_HOPS}),
                    max_batch=128, buckets=(32, 128), device="cuda")
    batch = vq[128:256].cpu().numpy()
    L = bp.beam_width
    block = SearchParams(k=min(L, idx.graph.n), l0=L, l_max=L,
                         adaptive=False, max_hops=bp.max_hops)

    def serve():
        srv.submit_many(batch)
        srv.drain()

    def build_block():
        search(idx.graph, idx.graph.vectors[:bp.block], block,
               with_candidates=True)

    for phase, fn in (("serve", serve), ("build_block", build_block)):
        row = _profiled(torch, fn, phase, out)
        row.update(n=idx.graph.n, card=card)
        print(f"[profile] {json.dumps(row)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=SERVE_N,
                    help="corpus size of the serve phase (the target is "
                         f"{TARGET_N:,}; see the module docstring)")
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build

    card = card_line()
    t0 = time.perf_counter()
    built = _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"[setup] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"card {card}; kernels built in {build_s:.1f} s "
          f"({', '.join(built) or 'already built'})")

    t_start = time.perf_counter()
    rows = kernel_phase(torch, card)
    t_kernels = time.perf_counter()
    if args.n < TARGET_N:
        print(f"[serve] n = {args.n:,}, cut from the {TARGET_N:,} target "
              "(SIFT1M's shape) to fit the run's time limit")
    idx, vq, serve, counts = serve_phase(torch, args.n, card)
    t_serve = time.perf_counter()
    probe_exact_phase(torch, idx, vq, card, counts)
    print(f"[time] kernels {t_kernels - t_start:.1f} s, serve (build and "
          f"drain) {t_serve - t_kernels:.1f} s, probe and exact "
          f"{time.perf_counter() - t_serve:.1f} s ({card})")

    kernels = []
    for name, path in REPORTED.items():
        r = dict(rows[(name, path)])
        r["launches"] = counts[path][name]
        kernels.append(r)
    print(f"[paths] launch counts by path: {json.dumps(counts)}")
    t_prof = time.perf_counter()
    profile_phase(torch, idx, vq, ROOT / "build" / "profile", card)
    print(f"[time] profile {time.perf_counter() - t_prof:.1f} s ({card})")
    print(f"[serve-summary] {json.dumps(serve)} card={card} "
          f"wall={time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
