#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # serve phase at n = 500,000, d = 128
    python3 chip_smoke.py --n 1000000   # the SIFT1M shape, the target

The serve phase's n is cut from the SIFT1M target of 1,000,000 to
500,000: at 1M the build alone took 740.6 s on an H100 80GB HBM3 at
700 W and the whole run 808 s, over half of the 1200 s a smoke run may
take.  The kernel phase always uses the 1M base.  The exact build (n =
4,000), the five baseline builders (n = 20,000 each) and the MIPS build
(n = 50,000) are smaller still, all at d = 128: Algorithm 2 is O(n²)
(the paper calls it intractable past ~10⁵) and five more builders and a
second δ-EMQG build at 500k would not fit the limit.

The host sets most of the run's time.  On an H100 80GB HBM3 at 700 W,
in one call on one host, the script before the live and resilient
phases took 596.4 s and this one 618.6 s: its earlier phases 518.0 s,
the live and resilient phases 100.6 s (PR 18's host ran the earlier
phases in 437.6 s).  The live phase's op stream keeps its sizes
(1,024-vector inserts, 2% deletes): an insert's cost is the connectivity
repair's 8 rounds over the ≈ 10,000 nodes the build leaves cut off,
whatever the batch; journal b checkpoints by hand so that each recovery
replays at most one record, and the resilient phase checks
rung 0 against the serve phase's drain instead of serving the queries a
second time.

Phases, each of which raises on a failed check (the script then exits
non-zero and prints no result line):

1. set-up   — torch, the card's name and power limit, and the build of
               every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one
               ``nvcc`` per source, all started together);
2. kernels  — ``gather_l2``, ``gather_l2_tiled``, ``bitdot``,
               ``fused_estimate`` and ``batched_l2`` against their plain
               PyTorch versions on the same card tensors, at the shapes each
               path below gives them (base 1M × 128; ids [128, 1] in the
               drain, [1024, 24] in the build's searches and, over a base
               1M × 129, in the MIPS build's, [128, 24] in the exact
               searches; codes [128, 24, 4] in the probe phase; the
               estimate of ids [128, 24] over a 1M-row code table, W = 4 in
               the drain and W = 5 in MIPS; rows [1024, 25, 128] in the
               build's neighbor selection, [1024, 24, 128] in the live
               phase's inserts, [1024, 25, 129] in the MIPS
               build's and [524, 128, 128] in the exact build's; and W =
               4's [128, 96] and the JAX package's
               benchmark shape [64, 64, 128], on no path), then timed with
               CUDA events over input sets that hold three times the card's
               L2 (``torch.cdist`` timed beside ``batched_l2`` as its
               library yardstick); ``gather_l2_tiled``, ``gather_l2`` (one
               row a warp) and ``batched_l2`` each pick one of three kernels
               by d and alignment, and the kernel picked at a path's shape
               must launch on that path; where that is a ragged-d register
               kernel (MIPS's d + 1 = 129) or one of ``gather_l2``'s, the
               one-row-a-warp block kernel is forced at the same shape, held
               against the plain version, timed beside it, and must give
               the same floats to the bit; ``bitdot`` and
               ``fused_estimate`` are also held to the bit to plain versions
               that sum and round in the kernels' order; ptxas must report
               no shared memory, no barrier and no spills for them and for
               the L2 register kernels;
3. serve    — the port's ``launch.serve`` path: ``build_emqg`` on the card
               and ``AnnServer.drain`` over 512 queries; the served
               distances are the exact ones, the ids those of the plain
               path (``backend="jnp"``, plain on both tiers) on the same
               card, and recall@10 is printed;
4. probe    — ``probing_search(use_kernel=True)`` (the bitdot kernel)
   exact      and ``search`` with ``backend="kernel"`` / ``"kernel_tiled"``
               against their plain paths, on the same index (``"kernel"``
               must launch ``gather_l2_row1`` and no other kernel behind
               ``gather_l2``);
5. ags,     — on the same index, 128 queries, each against its plain path:
   certify,   ``ags_search``; ``search(with_candidates=True)`` and
   filtered   ``theorem4_delta_prime`` (share found, mean δ′); and
               ``filtered_search`` with a seeded 10% mask;
6. profile  — ``torch.profiler`` over one served batch of 128 queries
               with max_hops = 128 and over one 1024-node candidate
               search of the build, on the same index; one JSON line each (device busy share, kernel
               launches and launches per hop, ms per hop), and the operator tables written to
               ``build/profile/`` under the checkout;
7. live     — on the same index, ``as_live`` and two journals under
               ``build/live/`` with the op stream ``LIVE_OPS``: insert 1,024
               (twice), delete 10,000 live ids (2%), consolidate, insert
               1,024, delete half of those.  Journal ``a`` runs it
               uninterrupted (an automatic checkpoint on the way): after
               each delete ``search_live`` serves no tombstoned id; after
               each insert the inserted vectors find themselves at distance
               0 as often as 1,024 existing nodes do, less
               ``LIVE_FIND_SLACK``; ``audit_live`` finds no structural
               violation and its unreachable count equals the builder's
               BFS.  Journal ``b`` runs it with a crash mid-splice in the
               second insert, a torn record appended after the consolidate
               and a bit-flipped newest checkpoint at the end, each
               followed by ``recover``, whose state must equal ``a``'s at
               the same sequence number bit for bit (b checkpoints by hand
               after ops 1, 4, 5 and 6, so that each recovery replays
               only what its fault left: 1, 0 and 1 records);
               ``gather_l2_tiled`` and ``batched_l2`` launch on this path
               (``live``); journal a's insert and consolidate stage times
               (``live_stage_seconds`` of its metrics registry) printed;
8. resilient — ``ResilientAnnServer`` on the same index: at rung 0 the
               512 queries' ids and distances equal those of the serve
               phase's ``AnnServer.drain`` with no retry, fallback or
               breaker move (``fused_estimate`` and ``gather_l2_tiled``
               launch: path ``resilient``); 2,048 queued at once walk the
               ladder down and light traffic back to rung 0 (recall@10 by
               rung printed); 4 NaN and 2 wrong-width queries among 128 are
               rejected, the rest served; on the card the kernel tier
               ``beam/auto`` is the breaker's only tier, so a persistent
               fault there fails every response, with no fallback and no
               crash, and a transient one is retried on it;
9. exact    — ``build_exact`` (Algorithm 2) at n = 4,000, then Theorem 1:
   build      a greedy W = 1 search from the medoid for every corpus point
               returns that point at distance 0;
10. baselines — each of ``baselines.BUILDERS`` at n = 20,000: degrees at
               most M, ≥ 99% of nodes reachable from the medoid (the
               reference's repair can leave a few cut off; ``knn`` has no
               repair), recall@10 of ``error_bounded_search`` printed;
11. mips     — ``build_mips(quantized=True)`` at n = 50,000 (its launches
               counted as the path ``mips_build``: at d + 1 = 129 the
               ragged-d register kernels ``gather_l2_ragged`` and
               ``batched_l2_ragged``, and never the block kernels)
               and ``mips_search`` for 256 queries (``gather_l2_ragged`` in
               its exact tier): recall@10 against brute-force inner
               product, ids against the plain path;
12. lm      — smollm-135m at full width in bf16, weights from a seeded
               ``torch.Generator``: the ``flash_attention`` kernel (its bf16
               instance on the tensor cores, ``flash_attn_sm90.cu``) against
               the plain blockwise attention at the prefill's shape (q [1,
               32768, 9, 64], k/v [1, 32768, 3, 64], causal), timed beside
               ``scaled_dot_product_attention`` as its library yardstick
               (at most ``FLASH_MAX_SDPA_RATIO`` times its time), with the
               instance's compiled resources and HGMMA count printed,
               plus a windowed GQA shape and a ragged S against the
               full-matrix version, each element to half a bf16 ulp (the
               plain version in f32; a key tile cut from the last row must
               break it); ``transformer.prefill`` over one prompt of 32,768
               tokens (``prefill_32k``'s sequence, the batch cut from 32
               to 1: at 32 the [B, S, V] f32 logits alone would be 206 GB),
               30 kernel launches and no input copied for TMA, then that
               prefill again under ``torch.profiler`` (device busy share,
               the flash kernel's and the GEMMs' shares of device time, a
               ``[profile]`` line); the prefill with the kernel against the
               plain attention at S = 4,096; and ``lm_server.generate`` for
               8 prompts of 128 tokens, greedy, 32 new tokens, with
               ``decode_step``'s logits after the prompt against
               ``prefill``'s.  Controls with attention or the decode cache
               broken on purpose must break the logit bound.

Every kernel's launch count is set to 0 just before the path that runs it
and read just after; a kernel that path never launched fails the run.  The
``kernels`` line reports each kernel at the shape of the path whose launch
count it prints (``gather_l2_tiled`` at three paths, ``batched_l2`` at
four; ``kernel`` names the kernel behind the entry point, whose launches
those are; a ragged-d row and ``gather_l2``'s also carry ``blocks_ms``, the
block kernel's time at its shape).  Each phase prints its seconds.  The
line before the last is the card; the one before it the ``kernels`` JSON;
the last line is the device JSON.  It needs one card and exits non-zero without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_FLOP_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
BF16_TC_FLOP_PER_S = 989e12    # H100 SXM bf16 on the tensor cores, dense
SERVE_PARAMS = dict(k=10, l0=10, l_max=256, alpha=1.2, adaptive=True,
                    max_hops=2048)
BUILD_PARAMS = dict(max_degree=24, beam_width=64, t=32, iters=2, block=1024,
                    align_degree=True)
MIN_AGREE = 0.99
PROFILE_HOPS = 128             # max_hops of the batch under the profiler
TARGET_N = 1_000_000           # SIFT1M's shape
SERVE_N = TARGET_N // 2        # halved to fit the run's time limit
EXACT_N = 4_000                # Algorithm 2 is O(n²): cut to fit the limit
BASELINE_N = 20_000            # five builders: cut to fit the limit
# share of nodes a baseline must reach from its medoid: knn has no repair;
# the others' connectivity repair (the JAX package's, which the port
# reproduces node for node) evicts a full node's longest edge and can leave
# a few nodes cut off (ROADMAP C.5)
MIN_REACH = {"knn": 0.0}
MIN_REACH_REPAIRED = 0.99
MIPS_N = 50_000                # a second δ-EMQG build: cut to fit the limit
LM_ARCH = "smollm-135m"
LM_CHECK_SEQ = 4_096           # the prefill with the kernel vs plain attention
LM_GEN = dict(batch=8, prompt=128, max_new=32, max_seq=256)
LM_CONTROL_WINDOWS = (1, LM_CHECK_SEQ // 2, LM_CHECK_SEQ - 64)
# The flash kernel is held to ref.err_ratio's bound (half a bf16 ulp of each
# value plus 2^-12 of its row's RMS) against the plain version in f32.  The
# logits are a bf16 product (std 1 at init, |x| up to 4.5, where a bf16 ulp
# is 2^-5), which the two attention paths, or decode_step against prefill,
# reach through 30 layers that round in different places.  On an H100 the
# sound pairs read 0.090 and 0.094 and the subtlest control (every layer's
# window 64 keys short of the last row's reach) 0.485, so the bound sits
# near the middle of the two on a log scale.  The controls are read and
# checked against it in every run; each path's distance to the same model
# in f32 is printed beside.
LM_LOGIT_TOL = 0.2
# The bf16 flash kernel at the prefill's shape may take at most this many
# times SDPA's time in the same run (the tensor-core redesign's target)
FLASH_MAX_SDPA_RATIO = 4.0
# kernel names of the dense products (cuBLAS's GEMM / GEMV kernels) in a
# profile of the prefill
GEMM_TAGS = ("gemm", "gemv", "nvjet", "xmma")

# the live phase's op stream on the served index: (op, argument); an insert
# takes clustered_vectors(LIVE_INSERT, 128, 48, seed), "delete" LIVE_DELETE
# live ids (2% of SERVE_N, never the medoid), "delete_new" half of the
# newest insert
LIVE_INSERT = 1024
LIVE_DELETE = 10_000
LIVE_OPS = (("insert", 9), ("insert", 10), ("delete", 12), ("consolidate", None),
            ("insert", 11), ("delete_new", 13))
LIVE_CKPT_BYTES = 1_000_000    # two insert records pass it: one automatic
LIVE_FIND_SLACK = 0.05         # inserted self-hit share ≥ existing − this
LIVE_AUDIT_SAMPLE = 256
# the stages core.updates times into live_stage_seconds {op, stage}
LIVE_STAGES = {"insert": ("search", "select", "reverse_edges", "repair"),
               "consolidate": ("merge", "select", "compact")}
LIVE_AUDIT_AFTER = (1, 3, 4, 6)  # the first insert, delete and consolidate; the end
# audit violations that mean a corrupted structure (an unreachable node is
# the reference's repair at this n, ROADMAP C.5, and is counted instead)
STRUCTURAL = ("out of range", "self-loop", "duplicate", "isolated",
              "tombstoned")
FAULT_QUERIES = 16             # the resilient phase's injected-fault batches


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


def host_us(torch, fn, calls: int = 300) -> float:
    """Wall time of one eager ``fn()`` call in µs: ``calls`` calls back to
    back, then one synchronize.  At the paths' shapes this is the host's
    dispatch cost, which sets a hop's time (``device_ms`` leaves it out)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def bound(nbytes: float, flops: float,
          flop_rate: float = FP32_FLOP_PER_S) -> tuple[float, str]:
    """(ms, what bounds it): the least time the card could take for the
    bytes moved and the operations done at ``flop_rate``, the larger of the
    two."""
    by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    by_ops = 1e3 * flops / flop_rate
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def recall_at(ids, gt) -> float:
    """recall@k of id lists [B, k] against ground truth [B, k]."""
    ids, gt = ids.cpu(), gt.cpu()
    return float(sum(len(set(a.tolist()) & set(b.tolist()))
                     for a, b in zip(ids, gt))) / ids.numel()


def agree(a, b) -> float:
    """Share of rows (queries) whose id lists are identical."""
    return float((a == b).all(1).float().mean())


def sets_for(torch, bytes_per_set: float) -> int:
    """How many distinct input sets a timed loop cycles through: enough that
    together they hold three times the card's L2 cache (collisions and
    invalid ids take some back), so a replay reads from device memory."""
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    return max(1, int(-(-3 * l2 // bytes_per_set)))


def unique_per_set(torch, ids) -> float:
    """Mean count of distinct valid ids in each set ``ids[s]``."""
    flat = ids.view(ids.shape[0], -1).sort(1).values
    first = torch.ones_like(flat, dtype=torch.bool)
    first[:, 1:] = flat[:, 1:] != flat[:, :-1]
    return int((first & (flat >= 0)).sum()) / ids.shape[0]


def check_misses_l2(torch, name: str, footprint: int) -> None:
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    check(footprint >= 2 * l2, f"{name}: timed inputs hold {footprint} bytes, "
          f"under twice the {l2}-byte L2")


# (kernel, B, M, d, the path that gives it this shape)
GATHER_CASES = (
    ("gather_l2_tiled", 128, 1, 128, "drain"),       # start and probes: [B, W]
    ("gather_l2_tiled", 1024, 24, 128, "build"),     # searches: [block, W·M]
    ("gather_l2_tiled", 128, 24, 128, "exact_kernel_tiled"),
    ("gather_l2_tiled", 128, 96, 128, "W=4, no path here"),
    ("gather_l2", 128, 24, 128, "exact_kernel"),
    ("gather_l2", 128, 96, 128, "W=4, no path here"),
    ("gather_l2_tiled", 1024, 24, 129, "mips_build"),   # MIPS's ragged d + 1
)
# (B, K = W·M, path) of the bitdot launch: the expand branch's estimates
BITDOT_CASES = ((128, 24, "probe"), (128, 96, "W=4, no path here"))
# (B, K = W·M, code words, d, path) of the fused_estimate launch: the
# expand branch's estimates at d = 128, and MIPS's augmented d + 1 = 129
ESTIMATE_CASES = ((128, 24, 4, 128, "drain"), (128, 24, 5, 129, "mips"))
ESTIMATE_TABLES = 8            # distinct 1M-row code tables the timing cycles
# the kernels line: (kernel, path) of each row, which reports the kernel at
# that path's shape and its launches there
REPORTED = (("gather_l2_tiled", "drain"), ("gather_l2_tiled", "build"),
            ("gather_l2_tiled", "mips_build"), ("gather_l2", "exact_kernel"),
            ("bitdot", "probe"), ("fused_estimate", "drain"),
            ("batched_l2", "build"), ("batched_l2", "live"),
            ("batched_l2", "exact_build"),
            ("batched_l2", "mips_build"), ("flash_attention", "lm_prefill"))


def batched_cases() -> tuple:
    """(B, M, d, path) of the batched_l2 launch: the selector's kept set in
    the build (max_keep = M + 1 in the degree alignment) at d = 128 and at
    MIPS's ragged d + 1 = 129, in the live phase's insert (max_keep = M),
    the exact build's [block, max_degree] at
    EXACT_N (``build_exact``'s own defaults), and the JAX package's
    benchmark shape."""
    from repro_torch.core.build_exact import _default_block, _default_max_degree

    kept = (BUILD_PARAMS["block"], BUILD_PARAMS["max_degree"] + 1)
    # insert's selection keeps M of its LIVE_INSERT new rows
    live = (LIVE_INSERT, BUILD_PARAMS["max_degree"], 128, "live")
    return ((*kept, 128, "build"), live, (*kept, 129, "mips_build"),
            (_default_block(EXACT_N, 128), _default_max_degree(EXACT_N), 128,
             "exact_build"),
            (64, 64, 128, "reference benchmark, no path"))


def _launch_counters() -> tuple:
    from repro_torch.kernels.bitdot import ops as bitdot_ops
    from repro_torch.kernels.flashattn import ops as flash_ops
    from repro_torch.kernels.l2dist import ops as l2ops

    return (l2ops.LAUNCHES, l2ops.KERNEL_LAUNCHES, bitdot_ops.LAUNCHES,
            flash_ops.LAUNCHES)


def kernel_counts() -> dict:
    """Every entry point's and kernel's launch count, by name."""
    return {k: v for counts in _launch_counters() for k, v in counts.items()}


def reset_counts() -> None:
    """Set every kernel's launch count to 0 (just before a path runs)."""
    for counts in _launch_counters():
        for name in counts:
            counts[name] = 0


def popcount32(torch, words):
    """Set bits of each int32 word (the uint32 pattern), as int64."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def register_kernel_resources() -> None:
    """The register kernels use no shared memory and no barrier and spill
    nothing: every kernel of bitdot and fused_estimate (``rabitq_rows.cuh``)
    and every ``l2_rows.cuh`` kernel of gather_l2 (R rows a warp: 2 and 4
    for gather_l2_tiled, 1 for gather_l2, which must be there).  ptxas's
    report of each, from the build logs, printed."""
    import re

    from repro_torch.kernels import _build

    for source, only in (("bitdot", None), ("fused_estimate", None),
                         ("gather_l2", "l2rows")):
        found = []
        for text in _build.build_log(source).split("Compiling entry function")[1:]:
            if only and only not in text.split("'")[1]:
                continue
            name = re.search(r"\d([a-z_]+_kernel)(?:I(\w+?)EEv)?", text)
            args = re.findall(r"L[bi](\d+)E", name[2] or "")
            regs = re.search(r"Used (\d+) registers", text)
            found.append(f"{name[1]}<{','.join(args)}> "
                         f"{regs[1] if regs else '?'} registers")
            check(regs is not None and "used 0 barriers" in text
                  and "smem" not in text
                  and "0 bytes spill stores, 0 bytes spill loads" in text,
                  f"{source} {found[-1]}: ptxas reports a barrier, shared "
                  "memory or spills")
        check(bool(found), f"{source}: no register kernel in its build log")
        if source == "gather_l2":
            check(any(f.startswith("rows_kernel<1,1>") for f in found)
                  and any(f.startswith("ragged_kernel<1,1,") for f in found),
                  "gather_l2's build log has no one-row register kernel")
        print(f"[ptxas] {source}, no barrier, no shared memory, no spills: "
              + "; ".join(found))


def bitdot_inputs(torch, g, B: int, K: int, W: int = 4):
    """Input sets of the bitdot launch at a path's shape: random code words
    int32[sets, B, K, W] (``codes[s]``, sets enough to hold three times the
    L2) and query lines f32[B, 32 W]."""
    sets = sets_for(torch, B * K * W * 4)
    codes = torch.randint(-2**31, 2**31 - 1, (sets, B, K, W), generator=g,
                          device="cuda", dtype=torch.int32)
    return codes, torch.randn((B, 32 * W), generator=g, device="cuda")


def bitdot_bound(torch, codes, q_unit) -> tuple[float, str]:
    """bitdot's bound for one set of ``bitdot_inputs``: each word, the
    query line and the output moved once, one add per set bit."""
    sets, B, K, W = codes.shape
    shifts = torch.arange(32, device=codes.device, dtype=torch.int32)
    set_bits = sum(int(((c[..., None] >> shifts) & 1).sum())
                   for c in codes.split(64)) / sets
    return bound(4 * (B * K * W + q_unit.numel() + B * K), set_bits)


def kernel_phase(torch, card: str):
    from repro_torch.kernels.bitdot import ops as bitdot_ops
    from repro_torch.kernels.bitdot import ref as bitdot_ref
    from repro_torch.kernels.l2dist import ops as l2ops
    from repro_torch.kernels.l2dist import ref as l2ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    n = 1_000_000
    bases = {}
    replaces = {"gather_l2": "src/repro/kernels/l2dist/l2dist.py:87",
                "gather_l2_tiled": "src/repro/kernels/l2dist/l2dist.py:145"}
    rows = {}
    for name, B, M, d, path in GATHER_CASES:
        if d not in bases:
            bases.clear()                # one 0.5 GB base at a time
            torch.cuda.empty_cache()
            bases[d] = torch.randn((n, d), generator=g, device=dev)
        base = bases[d]
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

        uniq = unique_per_set(torch, ids)            # rows a launch reads
        footprint = 4 * d * int(torch.unique(ids[ids >= 0]).numel())
        check_misses_l2(torch, f"{name} [{B},{M}]", footprint)
        ms = device_ms(torch, run_kernel) / sets
        plain_ms = device_ms(torch, run_plain) / sets
        call = (host_us(torch, lambda: fn(base, ids[0], queries)),
                host_us(torch, lambda: l2ref.gather_l2_ref(base, ids[0],
                                                           queries)))
        valid = int((ids >= 0).sum()) / sets
        nbytes = 4 * (B * M + uniq * d + B * d + B * M)
        bound_ms, bound_by = bound(nbytes, 3 * valid * d)
        kernel = (l2ops.tiled_kernel if name == "gather_l2_tiled"
                  else l2ops.one_row_kernel)(base, queries)
        blocks = {}
        if kernel != "gather_l2_rows":
            launch = blocks_kernel(torch, "gather_l2")
            blocks = blocks_beside(
                torch, out, expect, ok,
                lambda s: launch(base, ids[s], queries),
                sets, f"gather_l2_blocks [{B},{M}] d={d}")
        rows[(name, path)] = dict(
            name=name, kernel=kernel, route="cuda",
            source="src/repro_torch/kernels/csrc/gather_l2.cu",
            replaces=replaces[name], path=path,
            shape=f"ids[{B},{M}] base[{n},{d}]", max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None, timed_sets=sets, timed_mb=footprint / 1e6,
            call_us=call[0], plain_call_us=call[1], **blocks)
        del ids
    del base, bases
    torch.cuda.empty_cache()

    register_kernel_resources()
    for B, K, path in BITDOT_CASES:
        codes, q_unit = bitdot_inputs(torch, g, B, K)
        sets, W = codes.shape[0], codes.shape[-1]
        out = bitdot_ops.bitdot(codes[0], q_unit)
        torch.cuda.synchronize()
        expect = bitdot_ref.bitdot_ref(codes[0], q_unit)
        err = float((out - expect).abs().max())
        check(torch.allclose(out, expect, rtol=1e-5, atol=1e-4),
              f"bitdot [{B},{K},{W}] disagrees with its plain version: {err}")
        check(torch.equal(out, bitdot_ref.s_plus_kernel_order(codes[0],
                                                              q_unit)),
              f"bitdot [{B},{K},{W}] is not the kernel-order sum to the bit")
        footprint = codes.numel() * 4
        check_misses_l2(torch, f"bitdot [{B},{K},{W}]", footprint)
        ms = device_ms(torch, lambda: [bitdot_ops.bitdot(codes[s], q_unit)
                                       for s in range(sets)]) / sets
        plain_ms = device_ms(torch, lambda: [
            bitdot_ref.bitdot_ref(codes[s], q_unit) for s in range(sets)]) / sets
        call = (host_us(torch, lambda: bitdot_ops.bitdot(codes[0], q_unit)),
                host_us(torch, lambda: bitdot_ref.bitdot_ref(codes[0], q_unit)))
        bound_ms, bound_by = bitdot_bound(torch, codes, q_unit)
        rows[("bitdot", path)] = dict(
            name="bitdot", route="cuda",
            source="src/repro_torch/kernels/csrc/bitdot.cu",
            replaces="src/repro/kernels/bitdot/bitdot.py:45", path=path,
            shape=f"codes[{B},{K},{W}] q[{B},{q_unit.shape[1]}]",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=None, timed_sets=sets,
            timed_mb=footprint / 1e6, call_us=call[0], plain_call_us=call[1])
        del codes
    torch.cuda.empty_cache()
    rows.update(estimate_rows(torch, g, n))
    rows.update(batched_l2_rows(torch, g))
    for r in rows.values():
        lib = r["library_ms"]
        print(f"[kernel] {r['name']} {r['shape']} ({r['path']}; "
              f"{r.get('kernel', r['name'])}): err {r['max_abs_err']:.3g} ms "
              f"{r['ms']:.5f} plain_ms {r['plain_ms']:.5f} bound_ms "
              f"{r['bound_ms']:.5f} ({r['bound_by']}), "
              f"{r['bound_ms'] / r['ms']:.3f} of the bound; library_ms "
              f"{'none' if lib is None else f'{lib:.5f}'}; host µs a call "
              f"{r['call_us']:.1f} (plain {r['plain_call_us']:.1f}); "
              f"{r['timed_sets']} sets, {r['timed_mb']:.1f} MB"
              + (f"; block kernel forced: ms {r['blocks_ms']:.5f} "
                 f"({r['blocks_ms'] / r['ms']:.3f}× this one's), "
                 f"err {r['blocks_err']:.3g}, bitwise equal to this one "
                 f"{r['blocks_bitwise']}" if "blocks_ms" in r else "")
              + f" ({card})")
    return rows


def blocks_kernel(torch, source: str):
    """``launch(*inputs) → out``: the one-row-a-warp kernel of ``source``
    (``gather_l2`` or ``batched_l2``), ``<source>_blocks``, called through
    its C entry point as ``l2dist/ops.py`` calls the kernel it picks, with
    gather_l2_tiled's (base, ids, queries) or batched_l2's (rows, queries);
    raises if the launch fails.  It is not counted: the wrapper picks
    another kernel at the shapes where it is timed."""
    import ctypes

    from repro_torch.kernels import _build

    fn = getattr(_build.load(source), f"{source}_blocks")
    gather = source == "gather_l2"
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p] if gather else
                   [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                   + [ctypes.c_int64, ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def launch(*inputs):
        stream = torch.cuda.current_stream().cuda_stream
        if gather:
            base, ids, queries = inputs
            out = torch.empty(ids.shape, device=ids.device)
            rc = fn(base.data_ptr(), ids.data_ptr(), queries.data_ptr(),
                    out.data_ptr(), base.shape[0], *ids.shape, base.shape[1],
                    stream)
        else:
            rows, queries = inputs
            out = torch.empty(rows.shape[:2], device=rows.device)
            rc = fn(rows.data_ptr(), queries.data_ptr(), out.data_ptr(),
                    *rows.shape, queries.stride(0), stream)
        check(rc == 0, f"{source}_blocks failed to launch: cudaError {rc}")
        return out

    return launch


def blocks_beside(torch, out, expect, ok, launch, sets: int,
                  label: str) -> dict:
    """The one-row-a-warp block kernel forced at a path's shape, beside a
    register kernel that reads the same terms in the same lanes (ragged d,
    or one float4 a lane at d <= 128): held against the plain version
    (rtol 1e-5, atol 1e-4) and to ``out``, the register kernel's output,
    to the bit, and timed over the same input sets (``launch(s)`` runs it
    on set s, through ``blocks_kernel``, which counts nothing)."""
    got = launch(0)
    torch.cuda.synchronize()
    err = float((got[ok] - expect[ok]).abs().max())
    check(torch.allclose(got[ok], expect[ok], rtol=1e-5, atol=1e-4),
          f"{label} disagrees with its plain version: {err}")
    check(torch.equal(got.view(torch.int32), out.view(torch.int32)),
          f"{label} and the register kernel differ in a bit")
    ms = device_ms(torch, lambda: [launch(s) for s in range(sets)]) / sets
    return dict(blocks_ms=ms, blocks_err=err, blocks_bitwise=True)


def estimate_inputs(torch, g, n: int, B: int, K: int, W: int, d: int):
    """Input sets of the fused_estimate launch at a path's shape:
    ``ESTIMATE_TABLES`` code tables of n rows with their scalars (one table
    fits the L2; eight do not), ids int32[sets, B, K] with invalid slots,
    and a query context; ``args(s)`` is set s's argument list."""
    dev = torch.device("cuda")
    last = torch.full((W,), -1, dtype=torch.int64, device=dev)
    last[-1] = (1 << (d - 32 * (W - 1))) - 1   # pack_bits's zero tail
    tables = []
    for _ in range(ESTIMATE_TABLES):
        codes = (torch.randint(-2**31, 2**31 - 1, (n, W), generator=g,
                               device=dev, dtype=torch.int32)
                 .to(torch.int64) & last).to(torch.int32)
        norms = 0.5 + torch.rand(n, generator=g, device=dev)
        ip_xo = 0.5 + 0.4 * torch.rand(n, generator=g, device=dev)
        tables.append((codes, norms, ip_xo))
    sets = 2 * sets_for(torch, B * K * (4 * W + 8))
    ids = torch.randint(0, n, (sets, B, K), generator=g, device=dev,
                        dtype=torch.int32)
    ids.view(sets, -1)[:, ::7] = -1
    q_unit = torch.randn((B, d), generator=g, device=dev)
    q_unit /= torch.linalg.norm(q_unit, dim=1, keepdim=True)
    ctx = (q_unit, q_unit.sum(-1), 1.0 + torch.rand(B, generator=g,
                                                    device=dev),
           torch.tensor(float(d), device=dev).sqrt())

    def args(s):
        return (*tables[s % ESTIMATE_TABLES], ids[s], *ctx)

    return tables, ids, args


def estimate_costs(torch, tables, ids, d: int) -> tuple[int, float, str]:
    """Of ``estimate_inputs``: the bytes the timed sets read, and one
    launch's bound and what bounds it: the ids, each distinct row and its
    two scalars, the query line and its scalars, √d and the output moved
    once; one add per set bit, then 13 flops of estimator algebra per id."""
    sets, B, K = ids.shape
    n, W = tables[0][0].shape
    table_of = (torch.arange(sets, device=ids.device) % ESTIMATE_TABLES)
    key = table_of[:, None, None].to(torch.int64) * n + ids
    valid = ids >= 0
    footprint = (4 * W + 8) * int(torch.unique(key[valid]).numel())
    bits = torch.stack([popcount32(torch, t[0]).sum(1) for t in tables])
    set_bits = int(bits[table_of[:, None, None].expand_as(ids)[valid],
                        ids[valid].long()].sum()) / sets
    uniq = unique_per_set(torch, ids)            # rows a launch reads
    return (footprint, *bound(
        4 * B * K + uniq * (4 * W + 8) + 4 * B * d + 8 * B + 4 + 4 * B * K,
        set_bits + 13 * int(valid.sum()) / sets))


def estimate_rows(torch, g, n: int) -> dict:
    """fused_estimate at the drain's and the MIPS path's shapes, over
    ``ESTIMATE_TABLES`` distinct code tables of n rows."""
    from repro_torch.kernels.bitdot import ops as bitdot_ops
    from repro_torch.kernels.bitdot import ref as bitdot_ref

    rows = {}
    for B, K, W, d, path in ESTIMATE_CASES:
        tables, ids, args = estimate_inputs(torch, g, n, B, K, W, d)
        sets = ids.shape[0]
        out = bitdot_ops.fused_estimate(*args(0))
        torch.cuda.synchronize()
        expect = bitdot_ref.fused_estimate_ref(*args(0))
        check(bool(torch.isinf(out[ids[0] < 0]).all()),
              "fused_estimate: invalid ids must give +inf")
        ok = ids[0] >= 0
        err = float((out[ok] - expect[ok]).abs().max())
        check(torch.allclose(out[ok], expect[ok], rtol=1e-4, atol=1e-3),
              f"fused_estimate [{B},{K}] W={W} disagrees with its plain "
              f"version: {err}")
        check(torch.equal(out.view(torch.int32), bitdot_ref.
                          fused_estimate_kernel_order(*args(0))
                          .view(torch.int32)),
              f"fused_estimate [{B},{K}] W={W} is not the kernel-order "
              f"estimate to the bit")
        footprint, bound_ms, bound_by = estimate_costs(torch, tables, ids, d)
        check_misses_l2(torch, f"fused_estimate [{B},{K}] W={W}", footprint)
        ms = device_ms(torch, lambda: [bitdot_ops.fused_estimate(*args(s))
                                       for s in range(sets)]) / sets
        plain_ms = device_ms(torch, lambda: [
            bitdot_ref.fused_estimate_ref(*args(s)) for s in range(sets)],
            reps=5) / sets
        call = (host_us(torch, lambda: bitdot_ops.fused_estimate(*args(0))),
                host_us(torch, lambda: bitdot_ref.fused_estimate_ref(*args(0))))
        rows[("fused_estimate", path)] = dict(
            name="fused_estimate", route="cuda",
            source="src/repro_torch/kernels/csrc/fused_estimate.cu",
            replaces="src/repro/kernels/bitdot/bitdot.py:78", path=path,
            shape=f"ids[{B},{K}] codes[{n},{W}] d={d}", max_abs_err=err,
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None, timed_sets=sets, timed_mb=footprint / 1e6,
            call_us=call[0], plain_call_us=call[1])
        del tables, ids, args
    torch.cuda.empty_cache()
    return rows


def batched_inputs(torch, g, sets: int, B: int, M: int, d: int, path: str):
    """``sets`` input sets of batched_l2 at a path's shape: tiles f32[sets,
    B, M, d] and query lines [B, d] (``queries[s]``).  On ``mips_build`` a
    query line is a column of the candidate tile [B, L, d], L = beam_width,
    read in place at stride L·d as ``core/geometry.py::select_neighbors``
    passes it; set s takes column s % L, so the lines start at each 4-byte
    offset from 16-byte alignment, as the selector's loop over the columns
    reads them.  The other
    paths' lines are contiguous: at d = 128 the selector's stride keeps
    every load 16-byte aligned, so the same kernel runs."""
    dev = torch.device("cuda")
    tiles = torch.randn((sets, B, M, d), generator=g, device=dev)
    if path != "mips_build":
        return tiles, torch.randn((sets, B, d), generator=g, device=dev)
    L = BUILD_PARAMS["beam_width"]
    cand = torch.randn((sets, B, L, d), generator=g, device=dev)
    return tiles, [cand[s, :, s % L] for s in range(sets)]


def batched_l2_rows(torch, g) -> dict:
    """batched_l2 at the shapes of ``batched_cases()``; its library
    yardstick is ``torch.cdist`` (the same work and a square root)."""
    from repro_torch.kernels.l2dist import ops as l2ops
    from repro_torch.kernels.l2dist import ref as l2ref

    rows = {}
    for B, M, d, path in batched_cases():
        sets = sets_for(torch, B * M * d * 4)
        tiles, queries = batched_inputs(torch, g, sets, B, M, d, path)
        out = l2ops.batched_l2(tiles[0], queries[0])
        torch.cuda.synchronize()
        expect = l2ref.batched_l2_ref(tiles[0], queries[0])
        err = float((out - expect).abs().max())
        check(torch.allclose(out, expect, rtol=1e-5, atol=1e-4),
              f"batched_l2 [{B},{M},{d}] disagrees with its plain version: "
              f"{err}")
        footprint = tiles.numel() * 4
        check_misses_l2(torch, f"batched_l2 [{B},{M},{d}]", footprint)
        ms = device_ms(torch, lambda: [l2ops.batched_l2(tiles[s], queries[s])
                                       for s in range(sets)]) / sets
        plain_ms = device_ms(torch, lambda: [
            l2ref.batched_l2_ref(tiles[s], queries[s])
            for s in range(sets)]) / sets
        library_ms = device_ms(torch, lambda: [
            torch.cdist(tiles[s], queries[s][:, None, :])
            for s in range(sets)]) / sets
        call = (host_us(torch, lambda: l2ops.batched_l2(tiles[0], queries[0])),
                host_us(torch, lambda: l2ref.batched_l2_ref(tiles[0],
                                                            queries[0])))
        bound_ms, bound_by = bound(4 * (B * M * d + B * d + B * M),
                                   3 * B * M * d)
        kernel = l2ops.batched_kernel(tiles[0], queries[0])
        blocks = {}
        if kernel == "batched_l2_ragged":
            launch = blocks_kernel(torch, "batched_l2")
            blocks = blocks_beside(
                torch, out, expect, torch.ones_like(out, dtype=torch.bool),
                lambda s: launch(tiles[s], queries[s]),
                sets, f"batched_l2_blocks [{B},{M},{d}]")
        rows[("batched_l2", path)] = dict(
            name="batched_l2", kernel=kernel, route="cuda",
            source="src/repro_torch/kernels/csrc/batched_l2.cu",
            replaces="src/repro/kernels/l2dist/l2dist.py:60", path=path,
            shape=f"rows[{B},{M},{d}]", max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=library_ms, timed_sets=sets, timed_mb=footprint / 1e6,
            call_us=call[0], plain_call_us=call[1], **blocks)
        del tiles, queries
    torch.cuda.empty_cache()
    return rows


def serve_phase(torch, n: int, card: str):
    from repro_torch.core import BuildParams, SearchParams, build_emqg
    from repro_torch.core import probing_search
    from repro_torch.core.build_approx import _bfs_reachable
    from repro_torch.core.distances import brute_force_knn
    from repro_torch.data import clustered_vectors
    from repro_torch.serve import AnnServer

    d = 128
    base = clustered_vectors(n, d, 48, seed=0)
    queries = clustered_vectors(512, d, 48, seed=1)
    counts = {}

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx = build_emqg(base, BuildParams(**BUILD_PARAMS),
                     generator=torch.Generator().manual_seed(0),
                     verbose=True, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    counts["build"] = kernel_counts()
    deg = idx.graph.degrees().float()
    cut = int((~_bfs_reachable(idx.graph.neighbors, idx.graph.medoid)).sum())
    print(f"[serve] built δ-EMQG n={n} d={d} in {build_s:.1f} s, mean degree "
          f"{float(deg.mean()):.2f}, {cut} nodes unreachable from the medoid, "
          f"launches {json.dumps(counts['build'])} ({card})")
    check(counts["build"]["gather_l2_tiled"] > 0,
          "the build's searches never launched gather_l2_tiled")
    check(counts["build"]["batched_l2"] > 0,
          "the build's neighbor selection never launched batched_l2")

    srv = AnnServer(idx, SearchParams(**SERVE_PARAMS), max_batch=128,
                    buckets=(32, 128), device="cuda")
    reset_counts()
    srv.submit_many(queries)
    out = srv.drain()
    counts["drain"] = kernel_counts()
    check(counts["drain"]["gather_l2_tiled"] > 0,
          "AnnServer.drain never launched gather_l2_tiled")
    check(counts["drain"]["fused_estimate"] > 0,
          "AnnServer.drain never launched fused_estimate")
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
    recall = recall_at(ids, gt)
    s = srv.stats
    # one gather_l2_tiled launch per hop, plus one per batch for the start
    hops = counts["drain"]["gather_l2_tiled"] - s.n_batches
    ms_per_hop = s.total_search_s * 1e3 / max(hops, 1)
    print(f"[serve] n={n}: {s.n_requests} requests in {s.n_batches} batches; "
          f"recall@10={recall:.4f}; QPS={s.qps:.1f}; max latency "
          f"{s.max_latency_s * 1e3:.1f} ms; {hops} hops at {ms_per_hop:.3f} "
          f"ms a hop; ids equal to the plain path on {share:.4f} of "
          f"queries; launches in drain {json.dumps(counts['drain'])} "
          f"({card})")
    return idx, vq, dict(n=n, build_s=build_s, recall=recall, qps=s.qps,
                         max_latency_ms=s.max_latency_s * 1e3,
                         drain_s=s.total_search_s, hops=hops,
                         ms_per_hop=ms_per_hop), counts, out


def probe_exact_phase(torch, idx, vq, card: str, counts: dict) -> None:
    from repro_torch.core import SearchParams, probing_search, search

    q = vq[:128]
    p = SearchParams(**SERVE_PARAMS)
    plain = probing_search(idx, q, p, backend="jnp")
    reset_counts()
    kern = probing_search(idx, q, p, use_kernel=True)
    torch.cuda.synchronize()
    counts["probe"] = kernel_counts()
    check(counts["probe"]["bitdot"] > 0,
          "probing_search(use_kernel=True) never launched bitdot")
    share = agree(kern.ids, plain.ids)
    check(share >= MIN_AGREE,
          f"use_kernel=True ids match the plain path on {share:.4f}")
    print(f"[probe] bitdot launches {counts['probe']['bitdot']}; ids equal "
          f"to the plain path on {share:.4f} of 128 queries ({card})")

    ref = search(idx.graph, q, p, backend="jnp")
    for backend, name in (("kernel", "gather_l2"),
                          ("kernel_tiled", "gather_l2_tiled")):
        reset_counts()
        res = search(idx.graph, q, p, backend=backend)
        torch.cuda.synchronize()
        counts[f"exact_{backend}"] = kernel_counts()
        check(counts[f"exact_{backend}"][name] > 0,
              f"search(backend={backend!r}) never launched {name}")
        if backend == "kernel":
            behind = {k: counts["exact_kernel"][k] for k in
                      ("gather_l2_row1", "gather_l2_ragged1",
                       "gather_l2_blocks")}
            check(behind == {"gather_l2_row1": counts["exact_kernel"][name],
                             "gather_l2_ragged1": 0, "gather_l2_blocks": 0},
                  f"search(backend='kernel') launched {behind} behind "
                  f"{counts['exact_kernel'][name]} gather_l2 calls")
        share = agree(res.ids, ref.ids)
        check(share >= MIN_AGREE,
              f"search backend={backend} ids match jnp on {share:.4f}")
        print(f"[exact] backend={backend}: {name} launches "
              f"{counts[f'exact_{backend}'][name]}; ids equal to jnp on "
              f"{share:.4f} of 128 queries ({card})")


def ags_certify_filtered_phase(torch, idx, vq, card: str,
                               counts: dict) -> None:
    """AGS, the Theorem-4 certificate and filtered search on the served
    index, 128 queries each, the kernels against the plain path."""
    from repro_torch.core import SearchParams, ags_search, search
    from repro_torch.core import theorem4_delta_prime
    from repro_torch.core.filtered import filtered_search

    q = vq[:128]
    p = SearchParams(**SERVE_PARAMS)
    plain = ags_search(idx, q, p, backend="jnp")
    reset_counts()
    res = ags_search(idx, q, p)
    torch.cuda.synchronize()
    counts["ags"] = kernel_counts()
    check(counts["ags"]["fused_estimate"] > 0,
          "ags_search never launched fused_estimate")
    share = agree(res.ids, plain.ids)
    check(share >= MIN_AGREE, f"AGS ids match the plain path on {share:.4f}")
    print(f"[ags] launches {json.dumps(counts['ags'])}; ids equal to the "
          f"plain path on {share:.4f} of 128 queries ({card})")

    cert = {}
    for backend in ("jnp", "auto"):
        reset_counts()
        _, ids, dists = search(idx.graph, q, p, with_candidates=True,
                               backend=backend)
        cert[backend] = theorem4_delta_prime(idx.graph, q, ids, dists, k=10,
                                             delta=0.05, backend=backend)
        torch.cuda.synchronize()
        counts[f"certify_{backend}"] = kernel_counts()
    check(counts["certify_auto"]["gather_l2_tiled"] > 0
          and not any(counts["certify_jnp"].values()),
          "the certificate's kernels and plain paths ran the wrong code")
    found, dp = cert["auto"]
    share = float((found == cert["jnp"][0]).float().mean())
    check(share >= MIN_AGREE, f"certificate found matches the plain path on "
          f"{share:.4f} of queries")
    both = found & cert["jnp"][0]
    check(torch.allclose(dp[both], cert["jnp"][1][both], rtol=1e-4, atol=0),
          "δ′ of the kernels and the plain path disagree")
    print(f"[certify] Theorem 4 at δ = 0.05: found on {float(found.float().mean()):.4f} "
          f"of 128 queries, mean δ′ {float(dp[found].mean()):.4f}; found equal "
          f"to the plain path on {share:.4f} ({card})")

    mask = torch.as_tensor(
        np.random.default_rng(3).random(idx.graph.n) < 0.1, device="cuda")
    plain = filtered_search(idx.graph, q, mask, k=10, alpha=1.2,
                            l_max=256, backend="jnp")
    reset_counts()
    res = filtered_search(idx.graph, q, mask, k=10, alpha=1.2, l_max=256)
    torch.cuda.synchronize()
    counts["filtered"] = kernel_counts()
    got = res.ids[res.ids >= 0].long()
    check(got.numel() > 0 and bool(mask[got].all()),
          "filtered search returned an id that fails the mask")
    share = agree(res.ids, plain.ids)
    check(share >= MIN_AGREE,
          f"filtered ids match the plain path on {share:.4f}")
    print(f"[filtered] 10% mask: {got.numel()} ids returned, all pass; ids "
          f"equal to the plain path on {share:.4f} of 128 queries; launches "
          f"{json.dumps(counts['filtered'])} ({card})")


def exact_build_phase(torch, card: str, counts: dict) -> None:
    """Algorithm 2 on the card, then Theorem 1: a W = 1 greedy search from
    the medoid for every corpus point returns that point at distance 0."""
    import warnings

    from repro_torch.core import build_exact, greedy_search
    from repro_torch.data import clustered_vectors

    base = torch.as_tensor(clustered_vectors(EXACT_N, 128, 48, seed=4),
                           device="cuda")
    reset_counts()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        g = build_exact(base, delta=0.05, device="cuda")
        torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    counts["exact_build"] = kernel_counts()
    check(counts["exact_build"]["batched_l2"] > 0,
          "build_exact never launched batched_l2")
    res = greedy_search(g, base, k=1, l=1, max_hops=2048)
    hit = res.ids[:, 0].long() == torch.arange(EXACT_N, device="cuda")
    zero = res.dists[:, 0] == 0
    deg = g.degrees().float()
    print(f"[exact-build] n={EXACT_N} d=128 δ=0.05: {build_s:.1f} s, degree "
          f"mean {float(deg.mean()):.2f} max {int(deg.max())} (cap "
          f"{g.max_degree}); {[str(w.message) for w in caught]}; Theorem 1: "
          f"{int((hit & zero).sum())}/{EXACT_N} points found at distance 0; "
          f"launches {json.dumps(counts['exact_build'])} ({card})")
    check(bool((hit & zero).all()), "Theorem 1 fails on the exact build")


def baselines_phase(torch, card: str) -> None:
    """Each of the five baseline builders at BASELINE_N, d = 128."""
    from repro_torch.core import error_bounded_search
    from repro_torch.core.baselines import BUILDERS
    from repro_torch.core.build_approx import _bfs_reachable
    from repro_torch.core.distances import brute_force_knn
    from repro_torch.data import clustered_vectors

    base = torch.as_tensor(clustered_vectors(BASELINE_N, 128, 48, seed=5),
                           device="cuda")
    queries = torch.as_tensor(clustered_vectors(256, 128, 48, seed=6),
                              device="cuda")
    _, gt = brute_force_knn(queries, base, 10)
    for name, builder in BUILDERS.items():
        t0 = time.perf_counter()
        g = builder(base, device="cuda")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        M = 32                       # every builder's default degree
        deg = g.degrees()
        check(g.max_degree == M and int(deg.max()) <= M,
              f"{name}: degree above {M}")
        cut = int((~_bfs_reachable(g.neighbors, g.medoid)).sum())
        reach = 1.0 - cut / BASELINE_N
        check(reach >= MIN_REACH.get(name, MIN_REACH_REPAIRED),
              f"{name}: only {reach:.4f} of nodes reachable from the medoid")
        res = error_bounded_search(g, queries, k=10, alpha=1.2, l_max=256)
        print(f"[baselines] {name}: n={BASELINE_N} built in {build_s:.1f} s, "
              f"mean degree {float(deg.float().mean()):.2f}, {cut} nodes "
              f"unreachable from the medoid, recall@10 "
              f"{recall_at(res.ids, gt):.4f} ({card})")


def mips_phase(torch, card: str, counts: dict) -> None:
    """build_mips(quantized=True) and mips_search: d + 1 = 129 makes five
    code words and a ragged exact tier."""
    from repro_torch.core import BuildParams
    from repro_torch.core.mips import build_mips, mips_search
    from repro_torch.data import clustered_vectors

    items = clustered_vectors(MIPS_N, 128, 48, seed=7)
    queries = clustered_vectors(256, 128, 48, seed=8)
    reset_counts()
    t0 = time.perf_counter()
    mips = build_mips(items, BuildParams(**BUILD_PARAMS), quantized=True,
                      device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    counts["mips_build"] = kernel_counts()
    check(mips.index.codes.words == 5, "MIPS codes are not 5 words wide")
    plain = mips_search(mips, queries, k=10, backend="jnp")
    reset_counts()
    res = mips_search(mips, queries, k=10)
    torch.cuda.synchronize()
    counts["mips"] = kernel_counts()
    check(counts["mips"]["fused_estimate"] > 0,
          "mips_search never launched fused_estimate")
    # d + 1 = 129: the ragged-d register kernels, never the block kernels
    for path, ragged in (("mips_build", ("gather_l2_ragged", "batched_l2_ragged")),
                         ("mips", ("gather_l2_ragged",))):
        for kernel in ragged:
            check(counts[path][kernel] > 0, f"{path} never launched {kernel}")
        for kernel in ("gather_l2_blocks", "batched_l2_blocks"):
            check(counts[path][kernel] == 0,
                  f"{path} launched {kernel} {counts[path][kernel]} times")
    share = agree(res.ids, plain.ids)
    check(share >= MIN_AGREE, f"MIPS ids match the plain path on {share:.4f}")
    scores = torch.as_tensor(queries, device="cuda") @ \
        torch.as_tensor(items, device="cuda").T
    gt = torch.topk(scores, 10, dim=1).indices
    print(f"[mips] n={MIPS_N} d=128+1: built in {build_s:.1f} s; recall@10 "
          f"against brute-force inner product {recall_at(res.ids, gt):.4f}; "
          f"ids equal to the plain path on {share:.4f} of 256 queries; "
          f"launches {json.dumps(counts['mips'])}; the build's "
          f"{json.dumps(counts['mips_build'])} ({card})")


def flash_rows(torch, card: str, cfg, S: int) -> dict:
    """flash_attention at the prefill's shape against the plain blockwise
    attention (the full matrix would be 39 GB of scores), timed beside its
    plain version and SDPA; then, untimed, a windowed GQA shape and an S
    that is no multiple of the 64-row tile against the full-matrix
    version.  Each is held to ``ref.err_ratio``'s bf16 bound against the
    plain version in f32 on the same values; a control, the kernel with a
    key tile cut from the last row (window S - 64), must break it."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.flashattn import ops as flash_ops
    from repro_torch.kernels.flashattn import ref as flash_ref
    from repro_torch.models import common

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)

    def qkv(S, H, KV, hd):
        return [torch.randn((1, S, n, hd), generator=g, device=dev)
                .to(torch.bfloat16) for n in (H, KV, KV)]

    def held(q, k, v, window, want, what) -> float:
        out = flash_ops.flash_attention(q, k, v, window=window)
        err = float((out.float() - want).abs().max())
        ratio = flash_ref.err_ratio(out, want)
        note = ""
        if window is None:
            n = q.shape[1]
            control = flash_ref.err_ratio(
                flash_ops.flash_attention(q, k, v, window=n - 64), want)
            note = (f"; the control, a key tile cut from the last row, reads "
                    f"{control:.1f}")
            check(control > 1.0, f"the bf16 bound does not see a key tile "
                  f"cut from the last row ({what}): {control}")
        print(f"[lm] flash_attention {what}: max error {err:.3g}, "
              f"{ratio:.3f} of the bf16 bound{note}")
        check(bool(torch.isfinite(out).all()) and ratio <= 1.0,
              f"flash_attention {what} is {ratio} of the bf16 bound")
        return err

    for n, H, KV, window in ((1000, 8, 2, 100), (4097, 9, 3, None)):
        q, k, v = qkv(n, H, KV, 64)
        G = H // KV
        want = flash_ref.attention_ref(
            q.float(), k.float().repeat_interleave(G, 2),
            v.float().repeat_interleave(G, 2), window=window)
        held(q, k, v, window, want, f"S={n} H={H} KV={KV} window={window} "
             "against the full matrix")

    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, k, v = qkv(S, H, KV, hd)
    want = common.flash_attention(q.float(), k.float(), v.float(),
                                  backend="jnp")
    err = held(q, k, v, None, want, f"[1,{S},{H}/{KV},{hd}] against the "
               "plain blockwise version")
    del want
    out = flash_ops.flash_attention(q, k, v)
    ms = device_ms(torch, lambda: flash_ops.flash_attention(q, k, v), reps=5)
    plain_ms = device_ms(torch, lambda: common.flash_attention(
        q, k, v, backend="jnp"), reps=2)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))   # [B, H, S, hd] views
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                      SDPBackend.EFFICIENT_ATTENTION]):
        lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             enable_gqa=True)
        library_ms = device_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), reps=5)
    lib_err = float((lib.transpose(1, 2).float() - out.float()).abs().max())
    pairs = S * (S + 1) // 2               # (query, key) pairs under the mask
    flops = 4 * hd * pairs * H
    bound_ms, bound_by = bound(2 * (2 * S * H * hd + 2 * S * KV * hd),
                               flops, BF16_TC_FLOP_PER_S)
    row = dict(name="flash_attention", route="cuda",
               source="src/repro_torch/kernels/csrc/flash_attn_sm90.cu",
               replaces="src/repro/kernels/flashattn/flashattn.py:101",
               path="lm_prefill", shape=f"q[1,{S},{H},{hd}] kv[1,{S},{KV},"
               f"{hd}] bf16 causal", max_abs_err=err, ms=ms,
               plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
               library_ms=library_ms)
    print(f"[kernel] flash_attention {row['shape']} (lm_prefill): err "
          f"{err:.3g} ms {ms:.4f} plain_ms {plain_ms:.4f} bound_ms "
          f"{bound_ms:.4f} ({bound_by}) library_ms (sdpa) {library_ms:.4f} "
          f"(sdpa against the kernel: max diff {lib_err:.3g}); "
          f"{flops / ms / 1e9:.1f} TFLOP/s, {bound_ms / ms:.3f} of the "
          f"bound, {ms / library_ms:.2f}x SDPA ({card})")
    check(ms <= FLASH_MAX_SDPA_RATIO * library_ms, f"flash_attention takes "
          f"{ms} ms, over {FLASH_MAX_SDPA_RATIO}x SDPA's {library_ms} ms")
    print(f"[kernel] flash_attention bf16 hd={hd} instance: "
          f"{json.dumps(flash_ops.sm90_resources(hd))}; {sass_count()} "
          f"HGMMA instructions in its library; ptxas: {ptxas_report(hd)}")
    del q, k, v, out, lib
    torch.cuda.empty_cache()
    return {("flash_attention", "lm_prefill"): row}


def sass_count(op: str = "HGMMA") -> str:
    """How many ``op`` instructions the tensor-core flash library holds
    (``cuobjdump -sass``), or why that is not known."""
    import shutil

    from repro_torch.kernels import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return "unknown (no cuobjdump)"
    sass = subprocess.run([tool, "-sass", str(_build.library_path(
        "flash_attn_sm90"))], capture_output=True, text=True, timeout=120)
    if sass.returncode != 0:
        return f"unknown (cuobjdump exit {sass.returncode})"
    return str(sum(op in line for line in sass.stdout.splitlines()))


def ptxas_report(hd: int) -> str:
    """ptxas's lines on the bf16 kernel's instance for ``hd`` (registers,
    spills, serialised wgmma) from the library's build log."""
    from repro_torch.kernels import _build

    lines = _build.build_log("flash_attn_sm90").splitlines()
    tag = f"flash_fwd_sm90ILi{hd}E"
    keep = [ln.strip() for i, ln in enumerate(lines)
            if tag in ln or any(tag in p for p in lines[max(0, i - 2):i])]
    return " | ".join(keep) or "no report"


def _as_f32(tree):
    """A copy of a parameter tree with every tensor in float32."""
    if isinstance(tree, dict):
        return {k: _as_f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_f32(v) for v in tree]
    return tree.float()


def lm_phase(torch, card: str, counts: dict,
             out: Path) -> tuple[dict, dict]:
    """smollm-135m on the card: the kernel row, the 32k prefill and its
    profile, the kernel-vs-plain prefill and generate (see the module
    docstring)."""
    from repro_torch.configs import get_arch
    from repro_torch.data import lm_batch, make_markov_lm
    from repro_torch.kernels.flashattn import ops as flash_ops
    from repro_torch.models import transformer as tf
    from repro_torch.serve import generate

    spec = get_arch(LM_ARCH)
    cfg = spec.model_cfg
    S = spec.shapes["prefill_32k"].dims["seq"]     # its batch cut to 1
    rows = flash_rows(torch, card, cfg, S)
    dev = torch.device("cuda")
    params = tf.init(cfg, torch.Generator(device=dev).manual_seed(0),
                     device=dev)
    n_params = sum(t.numel() for t in (params["embed"], params["unembed"],
                                       params["ln_f"]))
    n_params += sum(t.numel() for p in params["layers"] for t in
                    [*(x for x in p.values() if torch.is_tensor(x)),
                     *p["ffn"].values()])
    check(n_params == cfg.param_count(), f"{n_params} parameters, "
          f"{cfg.param_count()} expected")
    lm = make_markov_lm(cfg.vocab, seed=0)

    toks = torch.from_numpy(lm_batch(lm, 1, LM_CHECK_SEQ, step=0)[0]).to(dev)
    kern = tf.prefill(cfg, params, toks)
    plain = tf.prefill(cfg, params, toks, backend="jnp")
    e2e_err = float((kern - plain).abs().max())
    f32 = tf.prefill(dataclasses.replace(cfg, dtype=torch.float32),
                     _as_f32(params), toks, backend="jnp")
    # controls: the kernel's prefill with every layer's attention cut on
    # purpose (window_period 2 windows every layer of a dense model, C.6)
    controls = {w: float((tf.prefill(dataclasses.replace(
        cfg, window=w, window_period=2), params, toks) - plain).abs().max())
        for w in LM_CONTROL_WINDOWS}
    print(f"[lm] prefill S={LM_CHECK_SEQ}: last-position logits with the "
          f"kernel against plain attention, max diff {e2e_err:.4g} (bound "
          f"{LM_LOGIT_TOL}; logits' max |x| {float(plain.abs().max()):.3f}); "
          f"against the f32 model: kernel {float((kern - f32).abs().max()):.4g}"
          f", plain {float((plain - f32).abs().max()):.4g}; controls, the "
          f"kernel with every layer windowed: " + ", ".join(
              f"window {w}: {d:.4g}" for w, d in controls.items()))
    check(e2e_err <= LM_LOGIT_TOL, f"prefill with the kernel and with plain "
          f"attention differ by {e2e_err} > {LM_LOGIT_TOL}")
    check(min(controls.values()) > LM_LOGIT_TOL, f"the logit bound "
          f"{LM_LOGIT_TOL} does not see attention cut to a window: {controls}")
    del kern, plain, f32

    toks = torch.from_numpy(lm_batch(lm, 1, S, step=1)[0]).to(dev)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    flash_ops.COPIES["flash_attention"] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = tf.prefill(cfg, params, toks)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    counts["lm_prefill"] = kernel_counts()
    check(counts["lm_prefill"]["flash_attention"] == cfg.n_layers,
          f"prefill launched flash_attention "
          f"{counts['lm_prefill']['flash_attention']} times, not "
          f"{cfg.n_layers}")
    check(flash_ops.COPIES["flash_attention"] == 0, f"prefill copied "
          f"{flash_ops.COPIES['flash_attention']} attention inputs for TMA")
    check(tuple(logits.shape) == (1, cfg.vocab)
          and bool(torch.isfinite(logits).all()),
          "prefill logits are not [1, V] and finite")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[lm] {cfg.name} prefill 1 × {S}: {prefill_s:.3f} s, "
          f"{S / prefill_s:.1f} tokens/s, flash_attention launches "
          f"{counts['lm_prefill']['flash_attention']}, input copies "
          f"{flash_ops.COPIES['flash_attention']}, peak memory "
          f"{peak_gb:.2f} GB ({card})")
    row, avgs = _profiled(torch, lambda: tf.prefill(cfg, params, toks),
                          "lm_prefill", out)
    kernel_us = {e.key: _device_us(torch, e) for e in avgs}
    total_us = sum(kernel_us.values())
    row.update(seq=S, card=card,
               flash_share=sum(us for k, us in kernel_us.items()
                               if "flash_fwd_sm90" in k) / total_us,
               gemm_share=sum(us for k, us in kernel_us.items()
                              if any(t in k.lower() for t in GEMM_TAGS))
               / total_us)
    print(f"[profile] {json.dumps(row)}")
    del logits

    B, P = LM_GEN["batch"], LM_GEN["prompt"]
    prompts = torch.from_numpy(lm_batch(lm, B, P, step=2)[0]).to(dev)
    pre = tf.prefill(cfg, params, prompts)

    def stepped(prompts, shift=0):
        """Last logits of stepping prompts through decode_step from a cache
        whose positions start at shift."""
        cache = tf.init_cache(cfg, B, LM_GEN["max_seq"], device=dev)
        cache["pos"] += shift
        for t in range(prompts.shape[1]):
            logits, cache = tf.decode_step(cfg, params, cache, prompts[:, t])
        return logits

    step_err = float((stepped(prompts) - pre).abs().max())
    # controls: the cache one position off (slot 0 left empty but read),
    # and the prompt's first token missing from the cache
    step_controls = {
        "pos off by one": float((stepped(prompts, 1) - pre).abs().max()),
        "first token dropped": float((stepped(prompts[:, 1:]) - pre)
                                     .abs().max())}
    print(f"[lm] decode_step over {B} prompts of {P} against prefill: max "
          f"diff {step_err:.4g} (bound {LM_LOGIT_TOL}); controls: " +
          ", ".join(f"{c}: {d:.4g}" for c, d in step_controls.items()))
    check(step_err <= LM_LOGIT_TOL, f"decode_step over the prompt and "
          f"prefill differ by {step_err} > {LM_LOGIT_TOL}")
    check(min(step_controls.values()) > LM_LOGIT_TOL, f"the logit bound "
          f"{LM_LOGIT_TOL} does not see a broken decode cache: "
          f"{step_controls}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = generate(cfg, params, prompts, max_new=LM_GEN["max_new"],
                   max_seq=LM_GEN["max_seq"])
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    check(tuple(out.shape) == (B, P + LM_GEN["max_new"])
          and bool((out[:, :P] == prompts).all())
          and 0 <= int(out.min()) and int(out.max()) < cfg.vocab,
          "generate returned a wrong shape, a changed prompt or a token "
          "outside the vocabulary")
    # generate's first token is the argmax of decode_step's logits, which
    # are within the bound of prefill's: so prefill rates it within twice
    # the bound of its best, on every row
    first = pre.gather(1, out[:, P:P + 1].long())[:, 0]
    check(bool((first >= pre.max(-1).values - 2 * LM_LOGIT_TOL).all()),
          "greedy generate's first token is not among prefill's top "
          "logits")
    steps = P + LM_GEN["max_new"] - 1
    summary = dict(arch=cfg.name, params=n_params, prefill_seq=S,
                   prefill_s=prefill_s, prefill_tok_s=S / prefill_s,
                   prefill_peak_gb=peak_gb, e2e_logit_diff=e2e_err,
                   decode_vs_prefill_diff=step_err, gen_batch=B,
                   gen_prompt=P, gen_new=LM_GEN["max_new"], gen_s=gen_s,
                   decode_tok_s=B * steps / gen_s,
                   new_tok_s=B * LM_GEN["max_new"] / gen_s,
                   e2e_controls=controls, decode_controls=step_controls)
    print(f"[lm] generate {B} × ({P} + {LM_GEN['max_new']}) greedy: "
          f"{gen_s:.2f} s, {B * steps / gen_s:.1f} decode tokens/s "
          f"({steps} decode steps of {B} rows) ({card})")
    return rows, summary


def _device_us(torch, event) -> float:
    """Device time of a kernel or copy row; 0 for a host row (whose
    ``self_device_time_total`` repeats its kernels' time)."""
    if event.device_type != torch.autograd.DeviceType.CUDA:
        return 0.0
    return float(event.self_device_time_total)


def _profiled(torch, fn, phase: str, out: Path) -> tuple[dict, list]:
    """``fn()`` under torch.profiler: (wall and device ms, the device's busy
    share, kernel launches; the profiler's rows), with the operator tables
    written to ``out``."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
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
    out.mkdir(parents=True, exist_ok=True)
    (out / f"profile_{phase}.txt").write_text(
        avgs.table(sort_by="self_cpu_time_total", row_limit=40) + "\n"
        + avgs.table(sort_by="self_device_time_total", row_limit=25))
    check(device_us > 0, f"the profile of {phase} shows no device time")
    return dict(phase=phase, wall_ms=wall_s * 1e3, device_ms=device_us / 1e3,
                device_busy=device_us / 1e6 / wall_s,
                kernel_launches=launches), avgs


def profile_phase(torch, idx, vq, out: Path, card: str) -> None:
    """Where a hop's time goes: ``torch.profiler`` over one served batch of
    128 queries with ``max_hops = PROFILE_HOPS`` (the profiler's own
    processing of a whole batch's ~300k launches took minutes), and over
    one 1024-node candidate search of the build (the build's own search
    parameters), on the served index.  The device's busy share is its
    kernel and copy time over the wall time (one stream, so the intervals
    do not overlap); the profiler's own cost is in that wall time."""
    from repro_torch.core import BuildParams, SearchParams, search
    from repro_torch.kernels.l2dist import ops as l2ops
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
        hops0 = l2ops.LAUNCHES["gather_l2_tiled"]
        row, _ = _profiled(torch, fn, phase, out)
        # one gather_l2_tiled launch per hop, plus one for the start distance
        hops = l2ops.LAUNCHES["gather_l2_tiled"] - hops0 - 1
        row.update(hops=hops,
                   launches_per_hop=row["kernel_launches"] / max(hops, 1),
                   ms_per_hop=row["wall_ms"] / max(hops, 1),
                   n=idx.graph.n, card=card)
        print(f"[profile] {json.dumps(row)}")


def live_payload(op: str, arg, live) -> dict:
    """The numpy payload of one op of LIVE_OPS on the state ``live``."""
    from repro_torch.data import clustered_vectors

    if op == "insert":
        return {"vectors": clustered_vectors(LIVE_INSERT, 128, 48, seed=arg)}
    if op == "delete":
        tomb = live.tombstones.cpu().numpy().copy()
        tomb[live.graph.medoid] = True
        return {"ids": np.random.default_rng(arg).choice(
            np.where(~tomb)[0], LIVE_DELETE, replace=False)}
    if op == "delete_new":
        newest = np.arange(live.graph.n - LIVE_INSERT, live.graph.n)
        return {"ids": np.random.default_rng(arg).choice(
            newest, LIVE_INSERT // 2, replace=False)}
    return {}


def live_apply(journal, op: str, payload: dict) -> None:
    if op == "insert":
        journal.insert(payload["vectors"])
    elif op in ("delete", "delete_new"):
        journal.delete(payload["ids"])
    else:
        journal.consolidate()


def same_live(torch, a, b) -> bool:
    """Bitwise equality of two LiveIndex states."""
    return (torch.equal(a.graph.vectors, b.graph.vectors)
            and torch.equal(a.graph.neighbors, b.graph.neighbors)
            and torch.equal(a.tombstones, b.tombstones)
            and a.graph.medoid == b.graph.medoid)


def self_hits(torch, live, ids):
    """bool per node of ``ids``: ``search_live`` (k = 10) returns it for
    its own vector at distance 0 (one batch: the loop's cost is per hop)."""
    from repro_torch.core.updates import search_live

    ids = torch.as_tensor(ids, device="cuda")
    res = search_live(live, live.graph.vectors[ids.long()], 10)
    hit = (res.ids == ids[:, None].to(res.ids.dtype)) & (res.dists == 0)
    return hit.any(1).cpu().numpy()


def live_audit(torch, live, what: str, card: str) -> dict:
    """audit_live: no structural violation, and its unreachable count equal
    to the builder's BFS on the same arrays; its header printed."""
    from repro_torch.core.build_approx import _bfs_reachable
    from repro_torch.core.verify import audit_live

    t0 = time.perf_counter()
    rep = audit_live(live, sample=LIVE_AUDIT_SAMPLE)
    torch.cuda.synchronize()
    audit_s = time.perf_counter() - t0
    bad = [v for v in rep.violations if any(k in v for k in STRUCTURAL)]
    check(not bad, f"audit after {what}: {bad}")
    g = live.graph
    bfs = int((~live.tombstones
               & ~_bfs_reachable(g.neighbors, g.medoid)).sum())
    check(rep.metrics.get("n_unreachable_live") == bfs,
          f"audit after {what}: {rep.metrics.get('n_unreachable_live')} "
          f"unreachable, the builder's BFS {bfs}")
    print(f"[live] audit after {what}: {rep.summary().splitlines()[0]}; "
          f"unreachable live {bfs} (BFS agrees); {audit_s:.2f} s ({card})")
    return dict(unreachable=bfs, audit_s=audit_s)


def live_phase(torch, idx, vq, card: str, counts: dict) -> dict:
    """Insert / delete / consolidate on the served δ-EMQG through two
    journals: ``a`` uninterrupted (checked after every op), ``b`` the same
    stream with a crash mid-splice, a torn record and a bit-flipped
    checkpoint, each followed by ``recover``, which must give a's state at
    the same sequence number to the bit."""
    import shutil

    from repro_torch.core import BuildParams
    from repro_torch.core.updates import (JournaledLiveIndex, as_live,
                                          recover, search_live, wal_append)
    from repro_torch.obs import MetricsRegistry, snapshot
    from repro_torch.testing import (SimulatedCrash, crash_at, flip_bits,
                                     torn_wal_record)

    root = ROOT / "build" / "live"
    shutil.rmtree(root, ignore_errors=True)
    live0 = as_live(idx.graph, BuildParams(**BUILD_PARAMS))
    reg = MetricsRegistry()
    summary = dict(audit=[live_audit(torch, live0, "the build", card)])

    reset_counts()
    ja = JournaledLiveIndex.create(live0, str(root / "a"), metrics=reg,
                                   checkpoint_every_bytes=LIVE_CKPT_BYTES)
    states, payloads, op_s = {0: ja.live}, {}, []
    for seq, (op, arg) in enumerate(LIVE_OPS, start=1):
        payloads[seq] = live_payload(op, arg, ja.live)
        n_before = ja.live.graph.n
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        live_apply(ja, op, payloads[seq])
        torch.cuda.synchronize()
        op_s.append(time.perf_counter() - t0)
        check(ja.seq == seq, f"journal a at seq {ja.seq} after op {seq}")
        live = states[seq] = ja.live
        line = f"[live] op {seq} {op}: {op_s[-1]:.2f} s, n={live.graph.n}"
        if op == "insert":
            new = np.arange(n_before, n_before + LIVE_INSERT)
            tomb = live.tombstones[:n_before].cpu().numpy()
            old = np.random.default_rng(seq).choice(
                np.where(~tomb)[0], LIVE_INSERT, replace=False)
            hits = self_hits(torch, live, np.concatenate([new, old]))
            ins, pre = hits[:LIVE_INSERT].mean(), hits[LIVE_INSERT:].mean()
            check(ins >= pre - LIVE_FIND_SLACK,
                  f"op {seq}: inserted nodes found at distance 0 on {ins:.4f}, "
                  f"existing ones on {pre:.4f}")
            line += (f"; self-hit share inserted {ins:.4f}, existing "
                     f"{pre:.4f}")
        if op.startswith("delete"):
            res = search_live(live, vq, 10)
            got = res.ids[res.ids >= 0].long()
            check(got.numel() > 0 and not bool(live.tombstones[got].any()),
                  f"op {seq}: search_live served a tombstoned id")
            line += f"; {got.numel()} ids served, none tombstoned"
        print(line + f" ({card})")
        if seq in LIVE_AUDIT_AFTER:
            summary["audit"].append(live_audit(torch, live, f"op {seq} {op}",
                                               card))
    torch.cuda.synchronize()
    counts["live"] = kernel_counts()
    check(counts["live"]["gather_l2_tiled"] > 0
          and counts["live"]["batched_l2"] > 0,
          f"the live path launched {json.dumps(counts['live'])}")
    snap = snapshot(reg)["histograms"]
    save = snap["checkpoint_save_seconds"]
    step_dir = max((root / "a" / "ckpt").iterdir())
    ckpt_mb = sum(f.stat().st_size for f in step_dir.iterdir()) / 1e6
    check(snapshot(reg)["counters"].get("wal_auto_checkpoint_total", 0) >= 1,
          "no automatic checkpoint in journal a")
    # journal a's stage times (core.updates' live_stage_seconds), read
    # before journal b adds its own
    stages = {}
    for op, names in LIVE_STAGES.items():
        hists = {st: reg.histogram("live_stage_seconds",
                                   {"op": op, "stage": st}) for st in names}
        runs = sum(o == op for o, _ in LIVE_OPS)
        check(all(h.count == runs for h in hists.values()),
              f"live_stage_seconds of {op}: "
              f"{ {st: h.count for st, h in hists.items()} } observations, "
              f"expected {runs} each")
        stages[op] = {st: h.mean for st, h in hists.items()}
    summary["stages_mean_s"] = stages
    print("[live] stages, mean s an op (journal a): " + "; ".join(
        f"{op} " + ", ".join(f"{st} {v:.3f}" for st, v in st_s.items())
        for op, st_s in stages.items()) + f" ({card})")

    # journal b: the same stream, three faults, each recovered; its
    # checkpoints are taken by hand (after ops 1, 4, 5 and 6), so that each
    # recovery replays only the records the fault left to it
    jb = JournaledLiveIndex.create(live0, str(root / "b"), metrics=reg)
    recovered = []

    def recovered_as_a(info_want: dict, what: str):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        j, info = recover(str(root / "b"), metrics=reg, device="cuda")
        torch.cuda.synchronize()
        rec_s = time.perf_counter() - t0
        for k, v in info_want.items():
            check(info[k] == v, f"recover after {what}: {k} {info[k]}, "
                  f"expected {v}")
        check(same_live(torch, j.live, states[j.seq]),
              f"recover after {what}: state at seq {j.seq} differs from "
              "the uninterrupted run's")
        recovered.append(dict(after=what, s=rec_s, seq=j.seq, **{
            k: info[k] for k in ("checkpoint_step", "replayed", "torn_seq")}))
        print(f"[live] recover after {what}: {rec_s:.2f} s, checkpoint "
              f"{info['checkpoint_step']}, {info['replayed']} records "
              f"replayed, torn {info['torn_seq']}, seq {j.seq}: bitwise "
              f"equal to journal a ({card})")
        return j

    for seq, (op, _) in enumerate(LIVE_OPS, start=1):
        if seq == 2:
            jb.fault_hook = crash_at("mid_splice")
            try:
                live_apply(jb, op, payloads[seq])
                fail("the mid-splice crash did not fire")
            except SimulatedCrash:
                pass
            del jb                       # only the disk survives
            jb = recovered_as_a(dict(checkpoint_step=1, replayed=1,
                                     torn_seq=None), "a crash mid-splice")
            continue
        if seq == 5:
            # a record appended after the consolidate, torn on disk (as a
            # crash in a later append leaves it): replay stops before it
            wal_append(jb.wal_dir, seq, op, payloads[seq])
            torn_wal_record(jb.wal_dir, seq)
            del jb
            jb = recovered_as_a(dict(checkpoint_step=4, replayed=0,
                                     torn_seq=5), "a torn record")
        live_apply(jb, op, payloads[seq])
        if seq in (1, 4, 5):
            jb.checkpoint()
    check(same_live(torch, jb.live, states[len(LIVE_OPS)]),
          "journal b's final state differs from journal a's")
    jb.checkpoint()                  # the newest, then damaged: walk back
    flip_bits(str(root / "b" / "ckpt" / f"step_{jb.seq:09d}" / "arrays.npz"),
              n_bits=16, seed=3)
    del jb
    jb = recovered_as_a(dict(checkpoint_step=5, replayed=1, torn_seq=None),
                        f"bit flips in checkpoint {len(LIVE_OPS)}")
    snap = snapshot(reg)["histograms"]
    summary.update(
        op_s=op_s, ckpt_mb=ckpt_mb, ckpt_save_s=save["sum"] / save["count"],
        recover=recovered,
        wal_append_p50_s=snap["wal_append_seconds"]["p50"],
        wal_fsync_p50_s=snap["wal_fsync_seconds"]["p50"])
    print(f"[live] checkpoint {ckpt_mb:.1f} MB, save {summary['ckpt_save_s']:.2f} "
          f"s (mean of {save['count']}); WAL append p50 "
          f"{summary['wal_append_p50_s'] * 1e3:.2f} ms, fsync p50 "
          f"{summary['wal_fsync_p50_s'] * 1e3:.2f} ms; launches "
          f"{json.dumps(counts['live'])} ({card})")
    del states, ja, jb
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return summary


def resilient_phase(torch, idx, vq, served: list, serve: dict, card: str,
                    counts: dict) -> dict:
    """ResilientAnnServer on the served δ-EMQG: rung 0 equal to the serve
    phase's ``AnnServer.drain`` of the same queries (``served``, with the
    same server settings; ``serve`` has its QPS), with no retry, fallback
    or breaker move; overload down the ladder and back; per-request
    validation; injected kernel faults contained (on FAULT_QUERIES
    queries: a lock-step batch costs what its slowest query's hops cost),
    on the card with no plain tier behind the kernels."""
    from repro_torch.core import SearchParams
    from repro_torch.core.distances import brute_force_knn
    from repro_torch.data import clustered_vectors
    from repro_torch.obs import MetricsRegistry, snapshot
    from repro_torch.serve import ResilienceConfig, ResilientAnnServer
    from repro_torch.testing import FaultPlan, inject_search_faults

    params = SearchParams(**SERVE_PARAMS)
    queries = vq.cpu().numpy()
    kw = dict(max_batch=128, buckets=(32, 128), device="cuda")

    reg = MetricsRegistry()
    srv = ResilientAnnServer(
        idx, params, config=ResilienceConfig(degrade_depth=len(queries)),
        metrics=reg, **kw)
    reset_counts()
    srv.submit_many(queries)
    got = srv.drain()
    torch.cuda.synchronize()
    counts["resilient"] = kernel_counts()
    s = srv.stats
    moves = {k: v for k, v in snapshot(reg)["counters"].items()
             if k.startswith("serve_breaker_transitions_total")}
    check(all(r.ok and r.rung == 0 and r.tier == "beam/auto" for r in got),
          "rung 0: a response was not served at rung 0 on beam/auto")
    check(len(got) == len(served) and all(
        np.array_equal(r.ids, w[0]) and np.array_equal(r.dists, w[1])
        for r, w in zip(got, served)),
          "rung 0: ids or distances differ from AnnServer's")
    check(s.n_retried == s.n_fallback == s.n_failed == 0 and not moves,
          f"un-faulted run: retried {s.n_retried}, fallback {s.n_fallback}, "
          f"failed {s.n_failed}, breaker moves {moves}")
    check(counts["resilient"]["fused_estimate"] > 0
          and counts["resilient"]["gather_l2_tiled"] > 0,
          f"the resilient path launched {json.dumps(counts['resilient'])}")
    out = dict(qps=s.qps, max_latency_ms=s.max_latency_s * 1e3,
               annserver_qps=serve["qps"],
               annserver_max_latency_ms=serve["max_latency_ms"])
    print(f"[resilient] rung 0: {s.n_requests} requests equal to AnnServer's "
          f"(ids and distances), 0 retries, 0 fallbacks, 0 breaker moves; "
          f"QPS {s.qps:.1f} (AnnServer in the serve phase "
          f"{serve['qps']:.1f}), max latency {out['max_latency_ms']:.1f} ms "
          f"(AnnServer {serve['max_latency_ms']:.1f}); launches "
          f"{json.dumps(counts['resilient'])} ({card})")

    # overload: 2048 at once walks the ladder down, light traffic back up
    burst = clustered_vectors(2048, 128, 48, seed=14)
    _, gt = brute_force_knn(burst, idx.graph.vectors, 10)
    gt = gt.cpu().numpy()
    srv = ResilientAnnServer(idx, params, config=ResilienceConfig(
        degrade_depth=64, recover_depth=8, n_rungs=4), **kw)
    srv.submit_many(burst)
    rs = srv.drain()
    degraded = srv.stats.n_degraded
    check(all(r.ok for r in rs) and degraded > 0
          and any(r.rung > 0 for r in rs), "overload never left rung 0")
    per_rung = {}
    for r, g in zip(rs, gt):
        per_rung.setdefault(r.rung, []).append(
            len(set(r.ids.tolist()) & set(g.tolist())) / 10)
    peak = srv.rung
    for _ in range(peak + 1):        # a queue under recover_depth: one up
        srv.submit_many(burst[:4])
        srv.drain()
    check(srv.rung == 0, f"the ladder stayed at rung {srv.rung}")
    out["recall_by_rung"] = {r: float(np.mean(v)) for r, v in
                             sorted(per_rung.items())}
    out["served_by_rung"] = {r: len(v) for r, v in sorted(per_rung.items())}
    print(f"[resilient] overload 2048 at once: {degraded} served "
          f"degraded, peak rung {peak}, back to 0 under light traffic; "
          f"recall@10 by rung {json.dumps(out['recall_by_rung'])} over "
          f"{json.dumps(out['served_by_rung'])} responses ({card})")

    # validation: 4 NaN and 2 wrong-dimension queries among 128
    srv = ResilientAnnServer(idx, params, config=ResilienceConfig(), **kw)
    bad = {5: np.full(128, np.nan, np.float32), 17: np.full(128, np.nan,
                                                            np.float32),
           40: np.full(128, np.nan, np.float32), 99: np.full(128, np.nan,
                                                             np.float32),
           60: np.zeros(127, np.float32), 120: np.zeros(129, np.float32)}
    for i in range(128):
        srv.submit(bad.get(i, queries[i]))
    rs = srv.drain()
    rejected = [r.seq for r in rs if r.status == "rejected"]
    check(sorted(rejected) == sorted(bad) and
          sum(r.ok for r in rs) == 128 - len(bad),
          f"validation rejected {rejected}")
    print(f"[resilient] validation: rejected exactly {sorted(rejected)}, "
          f"{128 - len(bad)} served ({card})")

    # injected faults on the search seam.  On the card the kernel tier is
    # the breaker's only tier: a fault there is retried, then fails its
    # batch, and the plain version never answers for the kernels
    q = queries[:FAULT_QUERIES]
    fast = dict(backoff_s=0.0, degrade_depth=4096)
    srv = ResilientAnnServer(idx, params, config=ResilienceConfig(
        breaker_threshold=2, **fast), **kw)
    tiers = [t.name for t in srv.breaker.tiers]
    with inject_search_faults(srv, FaultPlan(
            fail_first=10**6, match_backend="auto")) as inj:
        srv.submit_many(q)
        rs = srv.drain()
    check(tiers == ["beam/auto"]
          and all(r.status == "failed" and "KernelFault" in r.error
                  for r in rs)
          and {b for b, _ in inj.tier_log} == {"auto"}
          and srv.stats.n_fallback == 0 and srv.stats.n_failed == len(q),
          f"a persistent fault on beam/auto (tiers {tiers}, calls "
          f"{inj.tier_log}, fallbacks {srv.stats.n_fallback}) did not fail "
          "every response on the kernel tier alone")
    print(f"[resilient] persistent fault on beam/auto, the card's only tier: "
          f"{inj.n_failed} faults ({srv.stats.n_retried} retries), "
          f"{len(rs)} responses failed, none crashed, 0 fallbacks ({card})")

    srv = ResilientAnnServer(idx, params, config=ResilienceConfig(**fast),
                             **kw)
    with inject_search_faults(srv, FaultPlan(fail_first=1)) as inj:
        srv.submit_many(q)
        rs = srv.drain()
    check(all(r.ok and r.tier == "beam/auto" for r in rs)
          and srv.stats.n_retried == 1 and srv.stats.n_fallback == 0,
          "a transient fault was not retried on the same tier")
    print(f"[resilient] transient fault: retried once on beam/auto, "
          f"{len(rs)} served ({card})")
    return out


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
    seconds = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        seconds[name] = time.perf_counter() - t0
        print(f"[time] {name} {seconds[name]:.1f} s ({card})")
        return out

    rows = timed("kernels", kernel_phase, torch, card)
    if args.n < TARGET_N:
        print(f"[serve] n = {args.n:,}, cut from the {TARGET_N:,} target "
              "(SIFT1M's shape) to fit the run's time limit")
    idx, vq, serve, counts, served = timed("serve", serve_phase, torch,
                                           args.n, card)
    timed("probe_exact", probe_exact_phase, torch, idx, vq, card, counts)
    timed("ags_certify_filtered", ags_certify_filtered_phase, torch, idx, vq,
          card, counts)
    timed("profile", profile_phase, torch, idx, vq,
          ROOT / "build" / "profile", card)
    live = timed("live", live_phase, torch, idx, vq, card, counts)
    resilient = timed("resilient", resilient_phase, torch, idx, vq, served,
                      serve, card, counts)
    del idx, vq, served
    torch.cuda.empty_cache()
    timed("exact_build", exact_build_phase, torch, card, counts)
    timed("baselines", baselines_phase, torch, card)
    timed("mips", mips_phase, torch, card, counts)
    lm_rows, lm = timed("lm", lm_phase, torch, card, counts,
                        ROOT / "build" / "profile")
    rows.update(lm_rows)

    for (name, path), r in rows.items():
        # each kernel behind an entry point ran on the path of its shape
        if path in counts:
            check(counts[path][r.get("kernel", name)] > 0,
                  f"{r.get('kernel', name)} never launched on its path {path}")
    kernels = []
    for name, path in REPORTED:
        r = dict(rows[(name, path)])
        r["launches"] = counts[path][r.get("kernel", name)]
        check(r["launches"] > 0, f"{name} never launched on its path {path}")
        kernels.append(r)
    print(f"[paths] launch counts by path: {json.dumps(counts)}")
    print(f"[lm-summary] {json.dumps(lm)} card={card}")
    print(f"[live-summary] {json.dumps(live)} card={card}")
    print(f"[resilient-summary] {json.dumps(resilient)} card={card}")
    print(f"[serve-summary] {json.dumps(serve)} card={card} "
          f"wall={time.perf_counter() - t_start:.1f}s "
          f"phases={json.dumps(seconds)}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
