#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # serve phase at n = 500,000, d = 128
    python3 chip_smoke.py --n 1000000   # the SIFT1M shape, the target

The serve phase's n is cut from the SIFT1M target of 1,000,000 to
500,000: at 1M the build alone took 740.6 s on an H100 80GB HBM3 at
700 W and the whole run 808 s, over half of the 1200 s a smoke run may
take (at the build block of 1,024; the builds here take blocks of 16,384
rows, ``BUILD_PARAMS``).  The kernel phase always uses a 1M base (at d = 65 the same 512
MB: 1,969,230 rows).  The exact build (n = 4,000), the five baseline
builders (n = 20,000 each), the MIPS build (n = 50,000) and MIND's index
(20,000 item rows, d = 64) are smaller still: Algorithm 2 is O(n²) (the
paper calls it intractable past ~10⁵) and five more builders and more
δ-EMQG builds at 500k would not fit the limit.

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
               drain, [16384, 24] in the build's searches, [1024, 24] in
               the live phase's inserts and, over a base 1M × 129, in the
               MIPS build's, [128, 24] in the exact
               searches; over a base 1,969,230 × 65 (the same bytes), ids
               [16384, 24] in the recsys phase's MIND build and [64, 1] in
               its retrieval; codes [128, 24, 4] in the probe phase; the
               estimate of ids [128, 24] over a 1M-row code table, W = 4 in
               the drain and W = 5 in MIPS, and of ids [64, 24], W = 3 at
               d = 65 in MIND's retrieval; rows [16384, 25, 128] in the
               build's neighbor selection, [1024, 24, 128] in the live
               phase's inserts, [16384, 25, 129] in the MIPS
               build's, [16384, 25, 65] in MIND's and [524, 128, 128] in
               the exact build's; and W =
               4's [128, 96] and the JAX package's
               benchmark shape [64, 64, 128], on no path; and at sift1m's
               M = 64: ids [16384, 64] in its build's searches, rows
               [16384, 64, 128] in its refinement's selector and [16384,
               65, 128] in its degree alignment's (the largest the
               alignment's batch, the nodes short of M, can be), the
               estimate of ids [256, 64] and [4096, 64], W = 4, in its two
               serve shapes), then timed with
               CUDA events over input sets that hold three times the card's
               L2 (``torch.cdist`` timed beside ``batched_l2`` as its
               library yardstick; the plain version over the first
               ``PLAIN_SETS`` of them, which may sit in the L2); ``gather_l2_tiled``, ``gather_l2`` (one
               row a warp) and ``batched_l2`` each pick one of three kernels
               by d and alignment, and the kernel picked at a path's shape
               must launch on that path; where that is a ragged-d register
               kernel (MIPS's d + 1 = 129, MIND's 65) or one of
               ``gather_l2``'s, the
               one-row-a-warp block kernel is forced at the same shape, held
               against the plain version, timed beside it, and must give
               the same floats to the bit; ``bitdot`` and
               ``fused_estimate`` are also held to the bit to plain versions
               that sum and round in the kernels' order; ptxas must report
               no shared memory, no barrier and no spills for them and for
               the L2 register kernels; ``merge_topc`` (the search loops'
               merge of a sorted top-C buffer, in place) bit for bit against
               its plain version at the probing loop's pass, [40000, 513]
               with K 1 and K 64, and at the build's searches, [32768,
               1001] with K 64, ``MERGE_ACTIVE`` of the rows taking new
               entries, each timed merge on an untouched copy of its
               buffer;
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
               with max_hops = 128 and over one 16,384-node candidate
               search of the build, on the same index, device activity
               alone; one JSON line each (device busy share, kernel
               launches and launches per hop, ms per hop), and the operator
               tables written to ``build/profile/`` under the checkout;
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
9. sharded  — ``build_replicated``: 4 shards × 2 replicas of one δ-EMQG a
               shard (n = 50,000, d = 128, the serve cell's parameters;
               path ``sharded_build``) and a ``ShardVectorStore`` under
               ``build/sharded/``; ``ShardedResilientAnnServer`` over 128
               queries (seed 15; path ``sharded``): both merges equal
               ``host_reference_merge`` (ids, distances to rtol 1e-4),
               every id < n and once a row, the ids those of the plain
               path on ``MIN_AGREE``; shard 1's primary killed: coverage
               1.0 and the same ids; both replicas of shard 2: coverage
               0.75, ``max_missed`` 10, none of its ids, the host merge
               over the live slots, no breaker move; a persistent fault on
               the ring tier: ``all_gather`` answers, one fallback; then
               the CLI's three stages of 128 with ``auto_repair``, the
               kills after the first and two injected rebuild faults
               (shard 1's primary, shard 2's): shard 2's replica rebuilt
               bitwise the original slot and rejected by the reference's
               audit gate for the nodes the build left cut off (ROADMAP
               C.8), nothing installed, coverage held at 0.75, each
               attempt's seconds printed; the whole self-heal on the reference's audit-clean
               chaos cell (512 × 8): the hole repaired first, the fault
               backed off and retried, coverage back to 1.0 with no
               ``revive_shard``, each repaired slot bitwise the original,
               the healthy ids again (path ``shard_repair``: every
               sweep's launches); and the SPMD search, 2 ranks on the card
               in 2 processes with gloo between, equal to the single
               controller on every rank (its processes start right after
               the build and run beside the rest of the phase).  The single
               controller searches its live slots in one lock-step loop
               over their rows; ``host_reference_merge`` searches them one
               after another, so its equality checks the lock-step too;
10. exact   — ``build_exact`` (Algorithm 2) at n = 4,000, then Theorem 1:
   build      a greedy W = 1 search from the medoid for every corpus point
               returns that point at distance 0; then the (1/δ) bound at
               beam width 4: 128 off-corpus queries through ``search``,
               ``faithful_prune``, ``probing_search`` and ``ags_search`` on
               ``from_graph`` of that build, with the kernels, every rank
               within 1/δ of the exact k-NN's (``repro_torch.testing``'s
               numpy oracle), the served distances the exact ones;
11. baselines — each of ``baselines.BUILDERS`` at n = 20,000: degrees at
               most M, ≥ 99% of nodes reachable from the medoid (the
               reference's repair can leave a few cut off; ``knn`` has no
               repair), recall@10 of ``error_bounded_search`` printed;
12. mips     — ``build_mips(quantized=True)`` at n = 50,000 (its launches
               counted as the path ``mips_build``: at d + 1 = 129 the
               ragged-d register kernels ``gather_l2_ragged`` and
               ``batched_l2_ragged``, and never the block kernels)
               and ``mips_search`` for 256 queries (``gather_l2_ragged`` in
               its exact tier): recall@10 against brute-force inner
               product, ids against the plain path;
12b. sift1m — the paper's own configuration from the port's registry
               (``configs/sift1m.py``: M 64, L 1000, t 64, I 3,
               degree-aligned; l_max 512, α 1.2, max_hops 4096) with n cut
               to 16,384 of its 1,000,000 and ``block`` raised to 16,384
               (both printed): a one-shard δ-EMQG built on the card by
               ``build_sharded`` (paths ``sift1m_build``, the refinement,
               and ``sift1m_align``, the degree alignment), its build
               seconds per phase, the share of its searches cut at 1,024
               hops, the nodes aligned, degrees and unreachable nodes;
               ``serve_online`` (256) and ``serve_batch`` (4,096), each one
               call of ``launch.steps.ann_serve`` (paths
               ``sift1m_serve_online``, ``sift1m_serve_batch``): seconds,
               QPS, hops, recall@10, model FLOP/s, served distances the
               exact ones, serve_online's ids those of the plain path; and
               the exact ``search`` on the same graph with the same
               parameters (the graph's recall without the RaBitQ
               estimate);
12c. d960   — GIST1M's width: sift1m's build and search at d = 960 over
               a corpus of the benchmark's synth-d960 law (48 clusters
               near 21-dimensional subspaces), n 16,384, block 8,192 (paths
               ``d960_build``, ``d960_align``: batched_l2 and the build's
               gathers all on the block kernels), one ``ann_serve`` call of
               40,000 queries (``d960_serve_batch``: one launch a pass of
               fused_estimate's 4-chunk instance, W = 30, counted by
               ``bitdot.ops.CHUNK_LAUNCHES``; the exact tier on
               ``gather_l2_blocks``), recall@10 and the build's memory
               peak;
13. recsys  — FM, DCN-v2, DIEN and MIND at their published widths in f32
               (weights from a seeded generator, one arch's tables on the
               card at a time: 3.60, 3.50, 0.30 and 2.15 GB): each served
               at ``serve_p99`` (512) and ``serve_bulk`` (262,144) through
               the serve cell's function (MIND: its user interests), ms,
               samples/s, model FLOP/s, peak memory; ``retrieval_cand`` (one
               user against 10⁶ candidates, top 100) timed, sorted with
               ties in ascending id, its scores equal to the forward
               recomputed for the returned ids; serve_p99 and a retrieval
               over 20,000 candidates equal to the same port functions on
               the CPU with the parameters copied there; all within
               ``RECSYS_TOL``, which each arch's control (``recsys_control``)
               must break; one profiled DIEN serve_p99 forward (a
               ``[profile]`` line); MIND's retrieval through the δ-EMQG MIPS
               index as ``benchmarks/retrieval.py`` runs it: ``build_mips``
               over its first 20,000 item rows (d + 1 = 65, three code
               words; path ``recsys_build``), 16 users' interests as 64
               queries through ``mips_search`` (path ``recsys_retrieval``),
               ids against the plain path, the served inner products
               against the exact ones, the ragged-d kernels and
               ``fused_estimate`` launched and never the block kernels;
               recall@100 against exact ``mind_retrieval`` and the distance
               budget printed; ``[recsys]`` lines, a ``[recsys-summary]``
               line;
14. recsys_train — FM, DCN-v2, DIEN and MIND trained at published widths
               in f32 at ``train_batch`` (65,536; ``plan_recsys_accum``
               prints a microbatch cut where the card does not hold the
               batch: none on an 80 GB card), one arch on the card
               at a time: the loss and every gradient leaf on a batch of
               512 against the port on the CPU with the parameters copied
               there (``RECSYS_GRAD_TOL``; each arch's control,
               ``recsys_train_control``, must break it);
               ``RECSYS_TRAIN_STEPS`` steps of ``make_train_step`` under
               ``_recsys_train_cell``'s ``OptConfig``, the loss finite,
               seconds a step, samples/s, model TFLOP/s, peak memory;
               DIEN's steps, timed too, under
               ``torch.use_deterministic_algorithms``, a
               checkpoint after step 3, restored, step 4 again: loss and
               every state tensor bitwise; ``[recsys-train]`` lines and a
               ``[recsys-train-summary]`` line;
15. gnn     — gat-cora (arXiv:1710.10903) trained at its four cells in
               f32 (weights from a seeded generator, ``_gnn_cell``'s
               ``OptConfig``): full_graph_sm (``sbm_graph`` with cora's
               2,708 nodes, 10,556 edges, 1,433 features) 8 full-batch
               steps, the loss falling; molecule (``molecule_batch`` of
               128 graphs, mean readout) 8 steps; minibatch_lg: a
               reddit-shaped graph (232,965 nodes, 114,615,892 edges, 602
               features), ``CSRGraph.from_edges`` on the card,
               ``fanout_sample``
               (15, 10) from 1,024 seed nodes padded to 180,224, nothing
               cut, 2 steps, the host's seconds apart; ogb_products
               (2,449,029 nodes, 61,859,140 edges) full-batch in the edge
               chunks ``plan_edge_chunk`` sizes from the card's memory, 3
               steps, the loss and gradients at the chunk against half of
               it (``GNN_CHUNK_TOL``), 1,000 nodes' layer-0 output
               against a float64 recomputation (``GNN_F64_TOL``); card =
               CPU at the three small cells (``GNN_CPU_TOL``, the last 1%
               of the edges dropped as the control); step seconds,
               edges/s, model TFLOP/s, peak memory; ``[gnn]`` lines and a
               ``[gnn-summary]`` line;
16. lm      — smollm-135m at full width in bf16, weights from a seeded
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
               broken on purpose must break the logit bound;
17. train   — smollm-135m trained at its published widths in bf16
               (``train_4k``'s sequence of 4,096; its batch of 256 cut to
               8 and its accumulation of 4 to 2): the backward kernels
               (``flash_attn_bwd_sm90.cu``, on the tensor cores from the
               forward's lse) against ``attention_bwd_ref`` in f32 at q
               [4, 4096, 9, 64], dq, dk and dv each within
               ``ref.grad_err_ratio``'s bound, a query tile cut and a
               window one key tile short breaking it, timed beside its
               plain version and SDPA's backward (at most
               ``FLASH_BWD_MAX_SDPA_RATIO`` times its time), their
               registers, spills, shared memory and HGMMA count, and the
               forward kernel's row at that shape; ``loss_fn``'s gradients
               with the kernels
               against the plain attention's on one microbatch (the
               largest per-leaf relative error within ``TRAIN_GRAD_TOL``,
               every layer windowed breaking it); ``TRAIN_STEPS`` steps of
               ``make_train_step`` (AdamW, f32 moments), the loss falling,
               seconds a step, tokens/s, model FLOPs as a share of the
               bf16 peak, peak memory, exactly one forward and its remat
               and one backward launch a layer and microbatch; a
               checkpoint at ``TRAIN_RESUME_AT``, a restore and the rest
               of the run, losses and state equal to the uninterrupted
               run's bit for bit, its last step profiled (busy share, the
               flash forward's, backward's and GEMMs' shares); all under
               ``torch.use_deterministic_algorithms``; ``[train]`` and
               ``[train-summary]`` lines;
18. moe     — moonshot-v1-16b-a3b at its published widths, its 48 layers
               cut to 16 (``MOE_LAYERS``, to win back the train phase's
               time), in bf16 (9.5 B parameters, 19 GB, from a seeded
               generator):
               first, before any weight, the flash row at hd = 128 (q/kv
               [1, 32768, 16, 128], and the windowed GQA and ragged shapes
               at hd = 128) as in the lm phase, reported at the path
               ``moe_prefill``; ``transformer.prefill`` with the kernel
               against the plain attention at S = 4,096 (last-position
               logits within ``MOE_LOGIT_TOL``, every layer windowed on
               purpose must break it; no f32-model reading: 113 GB);
               the prefill of one 32,768-token prompt (``prefill_32k`` with
               its batch cut from 32 to 1), one kernel launch a layer, no input
               copied, the mean dropped share, and a ``[profile]`` line
               (busy share; flash, GEMM and dispatch shares);
               ``decode_step`` over 8 prompts of 32 tokens (cut from 128)
               against a prefill at a capacity that drops nothing, with
               the two cache controls; greedy ``generate`` for 8 × (128 +
               32), its first token among the drop-free prefill's top
               logits; a ``[moe-summary]`` line;
19. examples — the four port examples (``examples/torch_*.py``) in this
               process through their ``main(argv)``, at their own sizes:
               the quickstart, vector serving (and 4 shards on the card),
               the 46M-parameter LM for 40 steps (cut from 300) with a
               checkpoint every 20, then resumed to 60, and MIND trained and
               retrieved through the δ-EMQG index; each finishes and prints its
               result lines (``[examples]`` lines).

Every kernel's launch count is set to 0 just before the path that runs it
and read just after; a kernel that path never launched fails the run.  The
``kernels`` line reports each kernel at the shape of the path whose launch
count it prints (``gather_l2_tiled`` at seven paths, ``batched_l2`` at
seven, ``fused_estimate`` at four, ``flash_attention`` at three:
``lm_prefill``, ``moe_prefill`` and ``train``, and
``flash_attention_bwd`` at ``train``; ``kernel`` names the kernel behind
the entry point, whose launches
those are; a ragged-d row and ``gather_l2``'s also carry ``blocks_ms``, the
block kernel's time at its shape).  Each phase prints its seconds.  The
line before the last is the card; the one before it the ``kernels`` JSON;
the last line is the device JSON.  It needs one card and exits non-zero without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_FLOP_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
BF16_TC_FLOP_PER_S = 989e12    # H100 SXM bf16 on the tensor cores, dense
SERVE_PARAMS = dict(k=10, l0=10, l_max=256, alpha=1.2, adaptive=True,
                    max_hops=2048)
# the serve CLI's BuildParams, but for the block: raised from its 1,024 to
# cut the build's host hops (each block's searches read the graph frozen at
# the start of its iteration, so the block does not change the graph:
# tests/test_torch_configs.py); the live phase keeps LIVE_INSERT
BUILD_PARAMS = dict(max_degree=24, beam_width=64, t=32, iters=2,
                    block=16_384, align_degree=True)
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
SIFT_ARCH = "sift1m"           # the paper's own configuration (configs/sift1m.py)
# n cut from the config's 1,000,000 to fit the run's time: at 32,768 the
# sift1m and examples phases with their kernel rows took 140 s of the 120 s
# they may add to the run (PERF.md §5)
SIFT_N = 16_384
SIFT_BLOCK = 16_384            # BuildParams.block raised from 512: fewer host hops
SIFT_SEEDS = (9, 10)           # corpus, queries
# GIST1M's width (the benchmark's synth-d960.batch cell): sift1m's build and
# search at d = 960 on a corpus of the cell's law (48 clusters near
# 21-dimensional subspaces), n cut to D960_N, the cell's block (the largest
# power of two whose build fits the card at d = 960) and its 40,000-query
# call; the paths d960_build, d960_align and d960_serve_batch
D960_DIM = 960
D960_N = 16_384
D960_BLOCK = 8_192
D960_BATCH = 40_000
D960_LAW = dict(clusters=48, rank=21, center_std=0.12, noise=0.05)
D960_SEED = 31
BOUND_QUERIES = 128            # off-corpus queries of the exact build's W = 4 bound
BOUND_ENGINES = ("beam", "faithful", "probing", "ags")
# the four port examples, each in-process through its main(argv); the two
# trainers cut in steps (train_lm: 300 → 40, then resumed to 60)
EXAMPLE_RUNS = (("quickstart", []), ("vector_serve", []),
                ("train_lm", ["--steps", "40", "--ckpt-every", "20"]),
                ("train_lm", ["--steps", "60", "--ckpt-every", "20"]),
                ("recsys_retrieval", []))
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
MOE_ARCH = "moonshot-v1-16b-a3b"
MOE_LAYERS = 16                # cut from 48 to win back the train phase's time
MOE_DECODE_PROMPT = 32         # the decode = prefill check: cut from 128
# The MoE model's logits bound (kernel vs plain prefill at S = 4,096,
# decode vs a prefill that drops nothing).  Through its layers a bf16
# rounding in attention can flip a near-tied expert of a token (a sixth of
# its FFN output) or move a capacity drop, so the sound readings sit above
# smollm's: on an H100 at 48 layers they read 0.352 and 0.535, the subtlest
# control (every layer's window 64 keys short of the last row's reach) 1.19
# and the decode controls 3.75 and 6.05; at 16 layers 0.201 and 0.384,
# 1.188, 2.375 and 5.008.  The bound sits near the geometric mean of 0.535
# and 1.19.
MOE_LOGIT_TOL = 0.8
# kernel names of the MoE dispatch and combine (sorts, searchsorted,
# scatters and gathers) in a profile of the prefill
DISPATCH_TAGS = ("sort", "scatter", "gather", "searchsorted")
# The bf16 flash kernel at the prefill's shape may take at most this many
# times SDPA's time in the same run (the tensor-core redesign's target)
FLASH_MAX_SDPA_RATIO = 4.0
# and its backward at the train step's shape as many times SDPA's backward
FLASH_BWD_MAX_SDPA_RATIO = 4.0
# kernel names of the dense products (cuBLAS's GEMM / GEMV kernels) in a
# profile of the prefill
GEMM_TAGS = ("gemm", "gemv", "nvjet", "xmma")
# the train phase: smollm-135m at published widths, train_4k's sequence;
# its batch of 256 cut to 8 and its accumulation of 4 cut to 2 (microbatches
# of 4) to fit the phase in about a minute
TRAIN_ARCH = LM_ARCH
TRAIN_BATCH = 8
TRAIN_ACCUM = 2
TRAIN_STEPS = 8
TRAIN_RESUME_AT = 7            # checkpoint here, "crash", restore, finish
TRAIN_OPT = dict(lr=1e-3, warmup_steps=2)   # else the reference's OptConfig
# the bound on the largest per-leaf relative gradient error, ‖kernel −
# plain‖ / ‖plain‖, of loss_fn on one microbatch with the kernels' attention
# against the plain blockwise attention; set between the sound reading and
# the subtlest control's (see PERF.md §2)
TRAIN_GRAD_TOL = 0.042
# controls: every layer windowed on purpose (window_period 2 windows every
# layer of a dense model, C.6)
TRAIN_CONTROL_WINDOWS = (4096 // 2, 4096 - 64)
# the bf16 backward's kernels (flash_attn_bwd_sm90.cu): D, dK / dV, dQ
BWD_KERNELS = ("bwd_dsum_sm90", "bwd_dkdv_sm90", "bwd_dq_sm90")

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
# the sharded phase: S shards × R replicas of one δ-EMQG a shard, the serve
# cell's BuildParams and SearchParams; the CLI's three stages of 128 queries
SHARDED_N = 50_000             # cut from 200,000 to fit the phase in ≈ 200 s
SHARDED_S = 4
SHARDED_R = 2
SHARDED_STAGE = 128
SPMD_RANKS = 2                 # the SPMD transport: 2 ranks on the one card
# the recsys phase: the four recsys archs at their published widths in f32
# (random weights from a seeded generator), one arch's tables on the card
# at a time
RECSYS_ARCHS = ("fm", "dcn-v2", "dien", "mind")
RECSYS_K = 100                 # retrieval_cand's top k, the reference cell's
RECSYS_CPU_CAND = 20_000       # candidates the card = CPU retrieval scores
# MIND through the δ-EMQG index, as benchmarks/retrieval.py runs it: its
# N_ITEMS default (the cut keeps a second δ-EMQG build within the limit),
# its 16 users and its mips_search parameters
RECSYS_INDEX_N = 20_000
RECSYS_USERS = 16
RECSYS_SEARCH = dict(k=100, alpha=1.2, l_max=256)
# the bound on max |card − CPU| / max |CPU| of each arch's serve_p99
# output, of the retrieval's scores on the card against the CPU's, and of
# the 10⁶-candidate scores against the forward recomputed for the
# returned ids (f32, TF32 off: sums in another order); set between the
# sound readings and the controls of recsys_control, which must break it
# (PERF.md §2).  On an H100 the sound readings were 4.8e-8 to 1.88e-6
# (DCN-v2's 10⁶-row scores against 100 rows recomputed, the highest) and
# the controls 5.79e-5 (MIND at two routing iterations, its recomputed
# scores: random item rows of norm ≈ 0.08 make the third iteration's
# update small) to 0.542; the bound sits near the geometric mean of
# 1.88e-6 and 5.79e-5.
RECSYS_TOL = 1e-5
# the recsys_train phase: train_batch's steps (the reference cell's
# OptConfig), the card = CPU batch, DIEN's checkpoint step, and the bound
# on the loss's and each gradient leaf's ‖card − CPU‖ / ‖CPU‖ (f32, TF32
# off: sums in another order), between the sound readings and the
# controls of recsys_train_control (PERF.md §2).  On an H100 the sound
# readings were 8.6e-8 (FM) to 1.45e-4 (DCN-v2's embedding table: the
# dense features' large terms cancel in its gradient), the controls
# 8.77e-4 (MIND at two routing iterations) to 13; the bound sits near the
# geometric mean of 1.45e-4 and 8.77e-4
RECSYS_TRAIN_STEPS = 4
RECSYS_CPU_BATCH = 512
RECSYS_RESUME_AT = 3
RECSYS_GRAD_TOL = 3.5e-4
# the gnn phase: steps at each cell; the bound on card = CPU (logits,
# loss, each gradient leaf's ‖Δ‖ / ‖CPU‖) with its control (the last 1%
# of the real edges dropped), on the planned edge chunk against half of it
# and on layer 0 against float64 (PERF.md §2).  On an H100 card = CPU read
# at most 8.6e-7 and the controls 0.086-0.20 (the bound near their
# geometric mean); chunk against half 3.8e-6 (atomics add the edges in
# another order; a mid-size graph's attention vectors, whose gradients
# nearly cancel, read 1.45e-4 of their own norm at 4,096-edge chunks);
# float64 2.8e-7
GNN_STEPS = {"full_graph_sm": 8, "molecule": 8, "minibatch_lg": 2,
             "ogb_products": 3}
GNN_CPU_TOL = 3e-4
GNN_CONTROL_SHARE = 0.01
GNN_CHUNK_TOL = 1e-4
GNN_F64_NODES = 1000
GNN_F64_TOL = 1e-5


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


def device_ms(torch, fn, reps: int = 20, sets: int = 0) -> float:
    """Mean device time of one ``fn()`` call: ``fn`` is captured once into a
    CUDA graph and replayed ``reps`` times between two events, so the host's
    per-call cost is out of the number.  With ``sets``, ``fn(s)`` runs on
    input set s, the graph holds every set and the time is a set's.  One
    eager warm-up call on a side stream comes first (lazy initialisation
    stays out of the capture), on set 0 alone: at the small shapes a pass
    over the sets is thousands of launches, seconds of host time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    calls = [lambda s=s: fn(s) for s in range(sets)] or [fn]
    with torch.cuda.stream(side):
        calls[0]()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for call in calls:
            call()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps / max(sets, 1)


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
    ("gather_l2_tiled", BUILD_PARAMS["block"], 24, 128, "build"),  # [block, W·M]
    # the live inserts' searches, in blocks of LIVE_INSERT rows
    ("gather_l2_tiled", LIVE_INSERT, 24, 128, "live"),
    ("gather_l2_tiled", 128, 24, 128, "exact_kernel_tiled"),
    ("gather_l2_tiled", 128, 96, 128, "W=4, no path here"),
    ("gather_l2", 128, 24, 128, "exact_kernel"),
    ("gather_l2", 128, 96, 128, "W=4, no path here"),
    ("gather_l2_tiled", BUILD_PARAMS["block"], 24, 129, "mips_build"),  # d + 1
    # MIND's d + 1 = 65 through the index: the build's searches and the
    # retrieval's exact tier (64 interest queries, beam width 1)
    ("gather_l2_tiled", BUILD_PARAMS["block"], 24, 65, "recsys_build"),
    ("gather_l2_tiled", 64, 1, 65, "recsys_retrieval"),
    # sift1m's build searches at M = 64 over its block (beam width 1)
    ("gather_l2_tiled", SIFT_BLOCK, 64, 128, "sift1m_build"),
    # d = 960 past the register kernels: the probing loop's exact tier over
    # the cell's call and the build's searches over its block
    ("gather_l2_tiled", D960_BATCH, 1, D960_DIM, "d960_serve_batch"),
    ("gather_l2_tiled", D960_BLOCK, 64, D960_DIM, "d960_build"),
)
# (B, K = W·M, path) of the bitdot launch: the expand branch's estimates
BITDOT_CASES = ((128, 24, "probe"), (128, 96, "W=4, no path here"))
# (B, K = W·M, code words, d, path) of the fused_estimate launch: the
# expand branch's estimates at d = 128, MIPS's augmented d + 1 = 129, and
# MIND's d + 1 = 65 (three code words) for its 64 interest queries
ESTIMATE_CASES = ((128, 24, 4, 128, "drain"), (128, 24, 5, 129, "mips"),
                  (64, 24, 3, 65, "recsys_retrieval"),
                  # sift1m's two serve shapes at M = 64
                  (256, 64, 4, 128, "sift1m_serve_online"),
                  (4096, 64, 4, 128, "sift1m_serve_batch"),
                  # W = 30 (three full chunks and a last of 6) over the
                  # d = 960 cell's call
                  (D960_BATCH, 64, 30, D960_DIM, "d960_serve_batch"))
ESTIMATE_TABLES = 8            # distinct 1M-row code tables the timing cycles
# input sets the plain versions are timed over (the kernels over every
# set): the plain time is a column, no yardstick, and at the small shapes
# a capture of every set was thousands of Python calls (the d = 65
# estimate row's 13.5 s, most of it the plain version's)
PLAIN_SETS = 64
# (B, C, Ks, path) of the merge_topc rows: the probing loop's pass at
# l_max 512 (its two merges: the exact tier's K = W = 1 and the approximate
# tier's K = W·M = 64) over the benchmark's 40,000-query batch, and the
# build's searches at L 1,000 over its 32,768-row block
MERGE_CASES = ((40_000, 513, (1, 64), "sift1m_serve_batch"),
               (32_768, 1001, (64,), "sift1m_build"))
# share of a merge's rows that take new entries: the probing loop's rows
# still searching in the benchmark's cell (PERF.md §5); the others' new
# entries are all +inf, as a finished row's are
MERGE_ACTIVE = 0.166
MERGE_SETS = 2                 # buffers merged in a timed graph (185 MB each)
# the kernels line: (kernel, path) of each row, which reports the kernel at
# that path's shape and its launches there
REPORTED = (("gather_l2_tiled", "drain"), ("gather_l2_tiled", "build"),
            ("gather_l2_tiled", "live"),
            ("gather_l2_tiled", "mips_build"), ("gather_l2", "exact_kernel"),
            ("bitdot", "probe"), ("fused_estimate", "drain"),
            ("batched_l2", "build"), ("batched_l2", "live"),
            ("batched_l2", "exact_build"),
            ("batched_l2", "mips_build"), ("gather_l2_tiled", "recsys_build"),
            ("gather_l2_tiled", "recsys_retrieval"),
            ("batched_l2", "recsys_build"),
            ("fused_estimate", "recsys_retrieval"),
            ("gather_l2_tiled", "sift1m_build"),
            ("batched_l2", "sift1m_build"), ("batched_l2", "sift1m_align"),
            ("fused_estimate", "sift1m_serve_online"),
            ("fused_estimate", "sift1m_serve_batch"),
            ("merge_topc", "sift1m_serve_batch"), ("merge_topc", "sift1m_build"),
            ("gather_l2_tiled", "d960_serve_batch"),
            ("gather_l2_tiled", "d960_build"),
            ("fused_estimate", "d960_serve_batch"),
            ("batched_l2", "d960_build"), ("batched_l2", "d960_align"),
            ("flash_attention", "lm_prefill"),
            ("flash_attention", "moe_prefill"), ("flash_attention", "train"),
            ("flash_attention_bwd", "train"))


def batched_cases() -> tuple:
    """(B, M, d, path) of the batched_l2 launch: the selector's kept set in
    the build (max_keep = M + 1 in the degree alignment) at d = 128, at
    MIPS's ragged d + 1 = 129 and at MIND's d + 1 = 65 (the recsys phase's
    index), in the live phase's insert (max_keep = M),
    the exact build's [block, max_degree] at
    EXACT_N (``build_exact``'s own defaults), sift1m's [block, M] and
    [block, M + 1] at M = 64, and the JAX package's benchmark shape."""
    from repro_torch.configs import get_arch
    from repro_torch.core.build_exact import _default_block, _default_max_degree

    kept = (BUILD_PARAMS["block"], BUILD_PARAMS["max_degree"] + 1)
    # insert's selection keeps M of its LIVE_INSERT new rows
    live = (LIVE_INSERT, BUILD_PARAMS["max_degree"], 128, "live")
    M = get_arch(SIFT_ARCH).model_cfg["build"].max_degree
    return ((*kept, 128, "build"), live, (*kept, 129, "mips_build"),
            (*kept, 65, "recsys_build"),
            (_default_block(EXACT_N, 128), _default_max_degree(EXACT_N), 128,
             "exact_build"),
            # sift1m's selector: M kept in the refinement, M + 1 in the
            # degree alignment's search for t (the same build's launches)
            (SIFT_BLOCK, M, 128, "sift1m_build"),
            (SIFT_BLOCK, M + 1, 128, "sift1m_align"),
            # the same at d = 960 over its block, on the block kernel
            (D960_BLOCK, M, D960_DIM, "d960_build"),
            (D960_BLOCK, M + 1, D960_DIM, "d960_align"),
            (64, 64, 128, "reference benchmark, no path"))


def _launch_counters() -> tuple:
    from repro_torch.kernels.bitdot import ops as bitdot_ops
    from repro_torch.kernels.flashattn import ops as flash_ops
    from repro_torch.kernels.l2dist import ops as l2ops
    from repro_torch.kernels.topc import ops as topc_ops

    return (l2ops.LAUNCHES, l2ops.KERNEL_LAUNCHES, bitdot_ops.LAUNCHES,
            flash_ops.LAUNCHES, topc_ops.LAUNCHES)


def kernel_counts() -> dict:
    """Every entry point's and kernel's launch count, by name, and
    fused_estimate's by its instance's chunks of 8 code words
    (``fused_estimate_chunks<c>``)."""
    from repro_torch.kernels.bitdot import ops as bitdot_ops

    out = {k: v for counts in _launch_counters() for k, v in counts.items()}
    out.update({f"fused_estimate_chunks{c}": v
                for c, v in sorted(bitdot_ops.CHUNK_LAUNCHES.items())})
    return out


def reset_counts() -> None:
    """Set every kernel's launch count to 0 (just before a path runs)."""
    from repro_torch.kernels.bitdot import ops as bitdot_ops

    for counts in _launch_counters():
        for name in counts:
            counts[name] = 0
    bitdot_ops.CHUNK_LAUNCHES.clear()


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


def base_rows(n: int, d: int) -> int:
    """Rows of the gather rows' base at width d: n, or at d < 128 as many
    as fill the same bytes as n × 128 (MIND's d + 1 = 65: 1,969,230), so
    that the distinct rows the timed sets read pass twice the L2 as at
    d = 128."""
    return n if d >= 128 else n * 128 // d


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
        t_row = time.perf_counter()
        if d not in bases:
            bases.clear()                # one 0.5 GB base at a time
            torch.cuda.empty_cache()
            bases[d] = torch.randn((base_rows(n, d), d), generator=g,
                                   device=dev)
        base = bases[d]
        sets = sets_for(torch, B * M * 4 * d)
        ids = torch.randint(0, base.shape[0], (sets, B, M), generator=g,
                            device=dev, dtype=torch.int32)
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

        uniq = unique_per_set(torch, ids)            # rows a launch reads
        footprint = 4 * d * int(torch.unique(ids[ids >= 0]).numel())
        check_misses_l2(torch, f"{name} [{B},{M}]", footprint)
        ms = device_ms(torch, lambda s: fn(base, ids[s], queries), sets=sets)
        plain_ms = device_ms(torch, lambda s: l2ref.gather_l2_ref(
            base, ids[s], queries), sets=min(sets, PLAIN_SETS))
        call = (host_us(torch, lambda: fn(base, ids[0], queries)),
                host_us(torch, lambda: l2ref.gather_l2_ref(base, ids[0],
                                                           queries)))
        valid = int((ids >= 0).sum()) / sets
        nbytes = 4 * (B * M + uniq * d + B * d + B * M)
        bound_ms, bound_by = bound(nbytes, 3 * valid * d)
        kernel = (l2ops.tiled_kernel if name == "gather_l2_tiled"
                  else l2ops.one_row_kernel)(base, queries)
        blocks = {}
        if kernel not in ("gather_l2_rows", "gather_l2_blocks"):
            launch = blocks_kernel(torch, "gather_l2")
            blocks = blocks_beside(
                torch, out, expect, ok,
                lambda s: launch(base, ids[s], queries),
                sets, f"gather_l2_blocks [{B},{M}] d={d}")
        rows[(name, path)] = dict(
            name=name, kernel=kernel, route="cuda",
            source="src/repro_torch/kernels/csrc/gather_l2.cu",
            replaces=replaces[name], path=path,
            shape=f"ids[{B},{M}] base[{base.shape[0]},{d}]", max_abs_err=err,
            ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None, timed_sets=sets,
            plain_sets=min(sets, PLAIN_SETS), timed_mb=footprint / 1e6,
            call_us=call[0], plain_call_us=call[1],
            row_s=time.perf_counter() - t_row, **blocks)
        del ids
    del base, bases
    torch.cuda.empty_cache()

    register_kernel_resources()
    for B, K, path in BITDOT_CASES:
        t_row = time.perf_counter()
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
        ms = device_ms(torch, lambda s: bitdot_ops.bitdot(codes[s], q_unit),
                       sets=sets)
        plain_ms = device_ms(torch, lambda s: bitdot_ref.bitdot_ref(
            codes[s], q_unit), sets=min(sets, PLAIN_SETS))
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
            plain_sets=min(sets, PLAIN_SETS), timed_mb=footprint / 1e6,
            call_us=call[0], plain_call_us=call[1],
            row_s=time.perf_counter() - t_row)
        del codes
    torch.cuda.empty_cache()
    rows.update(estimate_rows(torch, g, n))
    rows.update(batched_l2_rows(torch, g))
    rows.update(merge_rows(torch, g))
    for r in rows.values():
        lib = r["library_ms"]
        print(f"[kernel] {r['name']} {r['shape']} ({r['path']}; "
              f"{r.get('kernel', r['name'])}): err {r['max_abs_err']:.3g} ms "
              f"{r['ms']:.5f} plain_ms {r['plain_ms']:.5f} bound_ms "
              f"{r['bound_ms']:.5f} ({r['bound_by']}), "
              f"{r['bound_ms'] / r['ms']:.3f} of the bound; library_ms "
              f"{'none' if lib is None else f'{lib:.5f}'}; host µs a call "
              f"{r['call_us']:.1f} (plain {r['plain_call_us']:.1f}); "
              f"{r['timed_sets']} sets ({r['plain_sets']} for the plain "
              f"version), {r['timed_mb']:.1f} MB, the row "
              f"{r['row_s']:.1f} s"
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
    ms = device_ms(torch, launch, sets=sets)
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
        t_row = time.perf_counter()
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
        ms = device_ms(torch, lambda s: bitdot_ops.fused_estimate(*args(s)),
                       sets=sets)
        plain_ms = device_ms(torch, lambda s: bitdot_ref.fused_estimate_ref(
            *args(s)), reps=5, sets=min(sets, PLAIN_SETS))
        call = (host_us(torch, lambda: bitdot_ops.fused_estimate(*args(0))),
                host_us(torch, lambda: bitdot_ref.fused_estimate_ref(*args(0))))
        rows[("fused_estimate", path)] = dict(
            name="fused_estimate", route="cuda",
            source="src/repro_torch/kernels/csrc/fused_estimate.cu",
            replaces="src/repro/kernels/bitdot/bitdot.py:78", path=path,
            shape=f"ids[{B},{K}] codes[{n},{W}] d={d}", max_abs_err=err,
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None, timed_sets=sets,
            plain_sets=min(sets, PLAIN_SETS), timed_mb=footprint / 1e6,
            call_us=call[0], plain_call_us=call[1],
            row_s=time.perf_counter() - t_row)
        del tables, ids, args
    torch.cuda.empty_cache()
    return rows


def batched_inputs(torch, g, sets: int, B: int, M: int, d: int, path: str):
    """``sets`` input sets of batched_l2 at a path's shape: tiles f32[sets,
    B, M, d] and query lines [B, d] (``queries[s]``).  On ``mips_build``
    and ``recsys_build`` (both augmented MIPS builds) a
    query line is a column of the candidate tile [B, L, d], L = beam_width,
    read in place at stride L·d as ``core/geometry.py::select_neighbors``
    passes it; set s takes column s % L, so the lines start at each 4-byte
    offset from 16-byte alignment, as the selector's loop over the columns
    reads them.  The other
    paths' lines are contiguous: at d = 128 the selector's stride keeps
    every load 16-byte aligned, so the same kernel runs."""
    dev = torch.device("cuda")
    tiles = torch.randn((sets, B, M, d), generator=g, device=dev)
    if path not in ("mips_build", "recsys_build"):
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
        t_row = time.perf_counter()
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
        ms = device_ms(torch, lambda s: l2ops.batched_l2(tiles[s], queries[s]),
                       sets=sets)
        plain_ms = device_ms(torch, lambda s: l2ref.batched_l2_ref(
            tiles[s], queries[s]), sets=min(sets, PLAIN_SETS))
        library_ms = device_ms(torch, lambda s: torch.cdist(
            tiles[s], queries[s][:, None, :]), sets=sets)
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
            library_ms=library_ms, timed_sets=sets,
            plain_sets=min(sets, PLAIN_SETS), timed_mb=footprint / 1e6,
            call_us=call[0], plain_call_us=call[1],
            row_s=time.perf_counter() - t_row, **blocks)
        del tiles, queries
    torch.cuda.empty_cache()
    return rows


def merge_inputs(torch, g, B: int, C: int, K: int):
    """One merge's inputs at a path's shape, as the search loops hold them:
    a buffer ascending in d2, its first 64 to C entries finite and the rest
    +inf pads, ids and flags random; new entries [B, K] in
    the ``MERGE_ACTIVE`` share of the rows, a third of them +inf (ids the
    dedup dropped), all +inf in the other rows."""
    dev = torch.device("cuda")
    d2 = torch.rand((B, C), generator=g, device=dev)
    fill = torch.randint(64, C + 1, (B, 1), generator=g, device=dev)
    d2 = torch.where(torch.arange(C, device=dev) < fill, d2, float("inf"))
    d2 = torch.sort(d2, dim=1, stable=True).values
    ids = torch.randint(0, 2**30, (B, C), generator=g, device=dev,
                        dtype=torch.int32)
    vis = torch.rand((B, C), generator=g, device=dev) < 0.5
    active = torch.rand((B, 1), generator=g, device=dev) < MERGE_ACTIVE
    d2_b = torch.rand((B, K), generator=g, device=dev)
    d2_b[(torch.rand((B, K), generator=g, device=dev) < 1 / 3) | ~active] = \
        float("inf")
    ids_b = torch.randint(0, 2**30, (B, K), generator=g, device=dev,
                          dtype=torch.int32)
    return ids, d2, vis, ids_b, d2_b, torch.zeros_like(ids_b,
                                                       dtype=torch.bool)


def merge_bytes(torch, inputs) -> float:
    """The bytes a merge must move: every row's K new keys and its buffer's
    last key read; in a row that takes new entries, each of the C − p0
    places from its first changed position p0 on written, and what fills
    it (a buffer entry or a new one) read: id, d2 and flag, 9 bytes each."""
    d2, d2_b = inputs[1], inputs[4]
    B, C = d2.shape
    K = d2_b.shape[1]
    least = d2_b.min(1, keepdim=True).values
    active = least[:, 0] < d2[:, -1]
    p0 = torch.searchsorted(d2, least, right=True)[:, 0]
    return float(B * (4 * K + 4) + 18 * int(((C - p0) * active).sum()))


def merge_rows(torch, g) -> dict:
    """merge_topc at ``MERGE_CASES``' shapes, a row a path: the pass's merges
    (one per K) held to the plain version to the bit, the buffer updated in
    place, then timed with CUDA events over a graph of ``MERGE_SETS``
    passes, each on a fresh copy of its untouched buffers (the copies stay
    out of the time); the plain version (which allocates its output) over
    the same sets."""
    from repro_torch.kernels.topc import ops as topc_ops
    from repro_torch.kernels.topc import ref as topc_ref

    rows = {}
    for B, C, Ks, path in MERGE_CASES:
        t_row = time.perf_counter()
        src = [[merge_inputs(torch, g, B, C, K) for K in Ks]
               for _ in range(MERGE_SETS)]
        work = [[tuple(t.clone() for t in m) for m in pas] for pas in src]
        for pas, wpas in zip(src, work):
            for m, w in zip(pas, wpas):
                want = topc_ref.merge_topc_ref(*m, C)
                got = topc_ops.merge_topc(*w, C)
                check(all(a is b for a, b in zip(got, w[:3])),
                      f"merge_topc [{B},{C}] did not return its buffer")
                check(torch.equal(got[0], want[0])
                      and torch.equal(got[1].view(torch.int32),
                                      want[1].view(torch.int32))
                      and torch.equal(got[2], want[2]),
                      f"merge_topc [{B},{C}] K={m[3].shape[1]} differs from "
                      "its plain version")

        def restore():
            for pas, wpas in zip(src, work):
                for m, w in zip(pas, wpas):
                    for a, b in zip(w[:3], m[:3]):
                        a.copy_(b)

        def merge_all():
            for wpas in work:
                for w in wpas:
                    topc_ops.merge_topc(*w, C)

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        restore()
        with torch.cuda.stream(side):
            merge_all()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            merge_all()
        times = []
        for _ in range(5):
            restore()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / MERGE_SETS)
        ms = statistics.median(times)
        plain_ms = device_ms(torch, lambda s: [
            topc_ref.merge_topc_ref(*m, C) for m in src[s]], reps=5,
            sets=MERGE_SETS)
        restore()
        call = (host_us(torch, lambda: [topc_ops.merge_topc(*w, C)
                                        for w in work[0]], calls=100),
                host_us(torch, lambda: [topc_ref.merge_topc_ref(*m, C)
                                        for m in src[0]], calls=20))
        nbytes = sum(merge_bytes(torch, m) for m in src[0])
        bound_ms, bound_by = bound(nbytes, 0)
        footprint = sum(t.numel() * t.element_size() for pas in src
                        for m in pas for t in m)
        rows[("merge_topc", path)] = dict(
            name="merge_topc", route="cuda",
            source="src/repro_torch/kernels/csrc/merge_topc.cu",
            replaces="none: lax.top_k over the concatenation, "
                     "src/repro/core/search.py:125", path=path,
            shape=f"buffer[{B},{C}] K={'+'.join(map(str, Ks))}",
            max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=None, timed_sets=MERGE_SETS,
            plain_sets=MERGE_SETS, timed_mb=footprint / 1e6,
            call_us=call[0], plain_call_us=call[1],
            row_s=time.perf_counter() - t_row)
        del src, work, graph
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
    # the plain path's distances launch nothing; the buffer's merge is the
    # kernel on the card whatever the backend (the plain merge's bits)
    check(counts["certify_auto"]["gather_l2_tiled"] > 0
          and not any(v for k, v in counts["certify_jnp"].items()
                      if k != "merge_topc"),
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
    the medoid for every corpus point returns that point at distance 0;
    then the (1/δ) bound at W = 4 (``delta_bound_w4``)."""
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
    delta_bound_w4(torch, g, base, card, counts)


def delta_bound_w4(torch, g, base, card: str, counts: dict) -> None:
    """What ``tests/test_torch_search.py::test_delta_bound_w4`` checks on
    the CPU, on the card: ``BOUND_QUERIES`` off-corpus queries through
    each of ``BOUND_ENGINES`` at beam width 4 with the kernels, on
    ``from_graph`` of the exact build (δ = 0.05): valid, distinct,
    ascending ids, served distances the exact ones (rtol 1e-4), and every
    rank within (1/δ) of the exact k-NN's (``repro_torch.testing``'s
    oracle, plain numpy in float64)."""
    from repro_torch.core import (SearchParams, ags_search, from_graph,
                                  probing_search, search)
    from repro_torch.data import clustered_vectors
    from repro_torch.testing import check_delta_bound, exact_knn

    idx = from_graph(g)
    q_h = clustered_vectors(BOUND_QUERIES, 128, 48, seed=11)
    q = torch.as_tensor(q_h, device="cuda")
    base_h = base.cpu().numpy()
    p = SearchParams(k=10, l0=10, l_max=64, alpha=1.2, adaptive=True,
                     max_hops=1024, beam_width=4)
    oracle_d = exact_knn(base_h, q_h, p.k)[0]
    runs = {"beam": lambda: search(g, q, p),
            "faithful": lambda: search(g, q, p, faithful_prune=True),
            "probing": lambda: probing_search(idx, q, p),
            "ags": lambda: ags_search(idx, q, p)}
    worst = {}
    for engine in BOUND_ENGINES:
        reset_counts()
        res = runs[engine]()
        torch.cuda.synchronize()
        counts[f"bound_{engine}"] = kernel_counts()
        check(counts[f"bound_{engine}"]["gather_l2_tiled"] > 0,
              f"the W = 4 {engine} search never launched gather_l2_tiled")
        ids, dists = res.ids.cpu().numpy(), res.dists.cpu().numpy()
        check(bool(((ids >= 0) & (ids < base_h.shape[0])).all())
              and all(len(set(r.tolist())) == len(r) for r in ids)
              and bool((np.diff(dists, axis=1) >= -1e-5).all()),
              f"W = 4 {engine}: ids invalid, repeated or out of order")
        true = np.linalg.norm(base_h[ids] - q_h[:, None, :], axis=-1)
        check(np.allclose(dists, true, rtol=1e-4, atol=1e-4),
              f"W = 4 {engine}: served distances are not the exact ones")
        bad = check_delta_bound(dists, oracle_d, g.delta)
        check(bad is None, f"W = 4 {engine}: {bad}")
        worst[engine] = float((dists / np.maximum(oracle_d, 1e-12)).max())
    print(f"[bound] W = 4 on the exact build (δ = {g.delta}): every rank of "
          f"{BOUND_QUERIES} off-corpus queries within 1/δ = "
          f"{1 / g.delta:.0f}× the exact k-NN's for {', '.join(BOUND_ENGINES)}"
          f"; largest ratio per engine {json.dumps(worst)} ({card})")


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


def phase_launches():
    """A metrics registry that also keeps the launch counts as each build
    phase ends (``build_progress`` events), in ``.launches[phase]``."""
    from repro_torch.obs import MetricsRegistry

    class PhaseLaunches(MetricsRegistry):
        def __init__(self):
            super().__init__()
            self.launches = {}

        def event(self, name, **fields):
            if name == "build_progress":
                self.launches[fields["phase"]] = kernel_counts()
            return super().event(name, **fields)

    return PhaseLaunches()


def wide_points(torch, law: dict, n: int, seed: int):
    """n float32 points on the card of ``law`` (``wide_law``): each near
    its cluster's subspace, plus isotropic noise."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    c = torch.randint(0, law["centres"].shape[0], (n,), generator=g,
                      device="cuda")
    z = torch.randn((n, D960_LAW["rank"]), generator=g, device="cuda")
    x = law["centres"][c] + D960_LAW["noise"] * torch.randn(
        (n, D960_DIM), generator=g, device="cuda")
    for j in range(D960_LAW["rank"]):
        x += z[:, j:j + 1] * law["bases"][:, :, j][c]
    return x


def wide_law(torch, seed: int) -> dict:
    """The d = 960 cell's corpus law: ``D960_LAW["clusters"]`` centres
    N(0, center_std²) and bases [C, 960, rank] N(0, 1/960)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    C, r = D960_LAW["clusters"], D960_LAW["rank"]
    return {"centres": D960_LAW["center_std"] * torch.randn(
                (C, D960_DIM), generator=g, device="cuda"),
            "bases": torch.randn((C, D960_DIM, r), generator=g,
                                 device="cuda") / D960_DIM ** 0.5}


def d960_phase(torch, card: str, counts: dict) -> dict:
    """GIST1M's width on the card (the benchmark's ``synth-d960.batch``
    cell at a smaller n): sift1m's build and search parameters from the
    registry at d = 960, n = ``D960_N``, block ``D960_BLOCK``, over a
    corpus of the cell's law, then one ``launch.steps.ann_serve`` call of
    ``D960_BATCH`` queries.  Launch counts on the paths ``d960_build``
    (the refinement), ``d960_align`` (the degree alignment) and
    ``d960_serve_batch``: every exact distance on the block kernels, every
    estimate on fused_estimate's 4-chunk instance (W = 30), one a pass;
    served distances against the exact ones; recall@10 against the exact
    top 10."""
    import types

    from repro_torch.configs import get_arch
    from repro_torch.core.distances import brute_force_knn
    from repro_torch.core.distributed import build_sharded
    from repro_torch.kernels.bitdot import ops as bitdot_ops
    from repro_torch.launch.steps import ann_serve

    mc = get_arch(SIFT_ARCH).model_cfg
    bp = dataclasses.replace(mc["build"], block=D960_BLOCK)
    sp = mc["search"]
    law = wide_law(torch, D960_SEED)
    base = wide_points(torch, law, D960_N, D960_SEED + 1)
    queries = wide_points(torch, law, D960_BATCH, D960_SEED + 2)
    reg = phase_launches()
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sidx = build_sharded(base.cpu().numpy(), 1, bp, quantized=True,
                         device="cuda", metrics=reg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    total = kernel_counts()
    refined = reg.launches[f"refine_iter{bp.iters - 1}"]
    counts["d960_build"] = refined
    counts["d960_align"] = {k: v - refined.get(k, 0) for k, v in total.items()}
    for path in ("d960_build", "d960_align"):
        check(counts[path]["batched_l2_blocks"] > 0
              and counts[path]["batched_l2"] == counts[path][
                  "batched_l2_blocks"],
              f"{path}: batched_l2 ran another kernel than the block one")
    check(counts["d960_build"]["gather_l2_blocks"] > 0
          and counts["d960_build"]["gather_l2_tiled"] == counts[
              "d960_build"]["gather_l2_blocks"],
          "d960_build: the searches ran another gather than the block one")
    phase_s = {e["phase"]: e["elapsed_s"] for e in reg.events
               if e["name"] == "build_progress"}
    print(f"[d960] built n={D960_N} d={D960_DIM} at block {bp.block} in "
          f"{build_s:.1f} s (phases "
          f"{json.dumps({k: round(v, 2) for k, v in phase_s.items()})}), "
          f"peak {peak / 1e9:.2f} GB; launches: refinement "
          f"{json.dumps(counts['d960_build'])}, alignment "
          f"{json.dumps(counts['d960_align'])} ({card})")

    arch = types.SimpleNamespace(id="d960", family="ann",
                                 model_cfg={"dim": D960_DIM, "search": sp})
    shape = types.SimpleNamespace(kind="ann_serve", name="serve_batch",
                                  dims={"batch": D960_BATCH})
    run = ann_serve(arch, shape, sidx)
    run(queries[:64])                                     # warm up
    stats = {}
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids, dists = run(queries, stats)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    path = "d960_serve_batch"
    counts[path] = c = kernel_counts()
    passes = c["fused_estimate"]
    check(passes == stats["iterations"] and passes > 0
          and c.get("fused_estimate_chunks4", 0) == passes
          and set(bitdot_ops.CHUNK_LAUNCHES) == {4},
          f"{path}: {passes} estimate launches, "
          f"{dict(bitdot_ops.CHUNK_LAUNCHES)} by chunks, "
          f"{stats['iterations']} passes: not one 4-chunk launch a pass")
    check(c["gather_l2_blocks"] > 0
          and c["gather_l2_tiled"] == c["gather_l2_blocks"],
          f"{path}: the exact tier ran another gather than the block one")
    vectors = sidx.slots[0].graph.vectors
    exact = torch.linalg.norm(vectors[ids.long()] - queries[:, None, :],
                              dim=-1)
    check(torch.allclose(dists, exact, rtol=1e-4, atol=1e-4),
          f"{path}: served distances are not the exact distances of the "
          "served ids")
    _, gt = brute_force_knn(queries, vectors, sp.k)
    hops = stats["n_hops"][0].float()
    out = dict(n=D960_N, block=bp.block, build_s=build_s, phase_s=phase_s,
               build_peak_bytes=peak, batch=D960_BATCH, s=secs,
               qps=D960_BATCH / secs, passes=passes,
               recall=recall_at(ids, gt), mean_hops=float(hops.mean()),
               launches=c)
    print(f"[d960] serve_batch: {D960_BATCH} queries in one call, "
          f"{secs:.3f} s, QPS {out['qps']:.1f}, {passes} passes, hops mean "
          f"{out['mean_hops']:.1f}, recall@10 {out['recall']:.4f}; launches "
          f"{json.dumps(c)} ({card})")
    return out


def sift1m_phase(torch, card: str, counts: dict) -> dict:
    """The paper's own configuration, ``configs/sift1m.py``, on the card:
    every build and search parameter from the port's registry (M 64, L
    1000, t 64, I 3, degree-aligned; l_max 512, α 1.2, max_hops 4096),
    with n cut to ``SIFT_N`` and ``BuildParams.block`` raised to
    ``SIFT_BLOCK`` (each block's searches read the graph frozen at the
    start of its iteration, so the block does not change the graph:
    ``tests/test_torch_configs.py``), both printed.  A one-shard index
    from ``build_sharded(base, 1, build, quantized=True)``: build seconds
    per phase, the share of the build's searches cut at ``max_hops``, the
    degrees, the nodes cut off (C.5), the launches of the refinement
    (path ``sift1m_build``) and of the degree alignment
    (``sift1m_align``: its batch is the nodes short of M, printed); then
    ``serve_online`` (256) and ``serve_batch`` (4,096) each as one call
    of ``launch.steps.ann_serve``: seconds, QPS, hops, recall@10, model
    FLOP/s; served distances against the exact ones, ``serve_online``'s
    ids against the plain path (``backend="jnp"``); and the exact-distance
    ``search`` on the same graph with the same ``SearchParams``, whose
    recall is the graph's alone (the served recall is the graph's with
    the RaBitQ estimate)."""
    from repro_torch.configs import get_arch
    from repro_torch.core import search
    from repro_torch.core.build_approx import _bfs_reachable
    from repro_torch.core.distances import brute_force_knn
    from repro_torch.core.distributed import build_sharded, make_sharded_search
    from repro_torch.data import clustered_vectors
    from repro_torch.launch.steps import _ann_model_flops, ann_serve

    arch = get_arch(SIFT_ARCH)
    mc = arch.model_cfg
    bp = dataclasses.replace(mc["build"], block=SIFT_BLOCK)
    sp = mc["search"]
    n, d = SIFT_N, mc["dim"]
    print(f"[sift1m] cuts: n {n:,} of the {mc['n']:,} target, block "
          f"{mc['build'].block} → {bp.block}; from the registry: M "
          f"{bp.max_degree}, L {bp.beam_width}, t {bp.t}, I {bp.iters}, "
          f"align_degree {bp.align_degree}, build max_hops {bp.max_hops}; "
          f"search k {sp.k}, l_max {sp.l_max}, α {sp.alpha}, max_hops "
          f"{sp.max_hops}; data clustered_vectors({n}, {d}, 48) ({card})")
    base = clustered_vectors(n, d, 48, seed=SIFT_SEEDS[0])
    B_max = max(s.dims["batch"] for s in arch.shapes.values())
    queries = torch.as_tensor(clustered_vectors(B_max, d, 48,
                                                seed=SIFT_SEEDS[1]),
                              device="cuda")
    reg = phase_launches()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sidx = build_sharded(base, 1, bp, quantized=True, device="cuda",
                         metrics=reg)
    idx = sidx.slots[0]
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    total = kernel_counts()
    # the refinement's launches end with its last iteration's event; the
    # rest are the degree alignment's (the RaBitQ fit launches none)
    refined = reg.launches[f"refine_iter{bp.iters - 1}"]
    counts["sift1m_build"] = refined
    counts["sift1m_align"] = {k: v - refined[k] for k, v in total.items()}
    for kernel in ("gather_l2_tiled", "batched_l2"):
        check(counts["sift1m_build"][kernel] > 0,
              f"the sift1m refinement never launched {kernel}")
    check(counts["sift1m_align"]["batched_l2"] > 0,
          "the sift1m degree alignment never launched batched_l2")
    events = [e for e in reg.events if e["name"] == "build_progress"]
    phase_s = {e["phase"]: e["elapsed_s"] for e in events}
    capped = sum(e.get("capped", 0) for e in events)
    capped_share = capped / (n * bp.iters)
    short = next(e["short"] for e in events if e["phase"] == "align_degree")
    deg = idx.graph.degrees()
    cut = int((~_bfs_reachable(idx.graph.neighbors, idx.graph.medoid)).sum())
    reach = 1.0 - cut / n
    out = dict(n=n, target_n=mc["n"], block=bp.block, build_s=build_s,
               phase_s=phase_s, capped=capped, capped_share=capped_share,
               aligned_nodes=short,
               align_shape=f"rows[{short},{bp.max_degree + 1},{d}] and "
                           f"[{short},{bp.max_degree},{d}]",
               mean_degree=float(deg.float().mean()),
               min_degree=int(deg.min()),
               degree_m_share=float((deg == bp.max_degree).float().mean()),
               unreachable=cut, launches_build=counts["sift1m_build"],
               launches_align=counts["sift1m_align"])
    print(f"[sift1m] built n={n} in {build_s:.1f} s (phases "
          f"{json.dumps({k: round(v, 2) for k, v in phase_s.items()})}); "
          f"{capped} of {n * bp.iters} build searches ({capped_share:.4f}) "
          f"cut at {bp.max_hops} hops; {short} nodes short of M aligned "
          f"(the alignment's batch: {out['align_shape']}); degree mean "
          f"{out['mean_degree']:.2f} min {out['min_degree']}, "
          f"{out['degree_m_share']:.4f} at M; {cut} "
          f"nodes unreachable from the medoid (C.5); launches: refinement "
          f"{json.dumps(counts['sift1m_build'])}, alignment "
          f"{json.dumps(counts['sift1m_align'])} ({card})")
    check(reach >= MIN_REACH_REPAIRED,
          f"sift1m: only {reach:.4f} of nodes reachable from the medoid")

    served = {}
    for name in ("serve_online", "serve_batch"):
        shape = arch.shapes[name]
        B = shape.dims["batch"]
        q = queries[:B]
        run = ann_serve(arch, shape, sidx)
        stats = {}
        path = f"sift1m_{name}"
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids, dists = run(q, stats)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts[path] = kernel_counts()
        for kernel in ("gather_l2_tiled", "fused_estimate"):
            check(counts[path][kernel] > 0, f"{path} never launched {kernel}")
        # the probing loop merges twice a pass: its exact and its
        # approximate tier
        merges = counts[path]["merge_topc"]
        check(merges == 2 * stats["iterations"],
              f"{path}: {merges} merge_topc launches, not twice the "
              f"{stats['iterations']} passes")
        print(f"[sift1m] {name}: merge_topc launches {merges}, 2 × "
              f"iterations {2 * stats['iterations']} ({card})")
        check(tuple(ids.shape) == (B, sp.k) and bool((ids >= 0).all())
              and bool(torch.isfinite(dists).all()),
              f"{path}: results are not {B} × {sp.k} valid ids and finite "
              "distances")
        exact = torch.linalg.norm(idx.graph.vectors[ids.long()]
                                  - q[:, None, :], dim=-1)
        check(torch.allclose(dists, exact, rtol=1e-4, atol=1e-4),
              f"{path}: served distances are not the exact distances of "
              "the served ids")
        _, gt = brute_force_knn(q, idx.graph.vectors, sp.k)
        hops = stats["n_hops"][0].float()
        flops = _ann_model_flops(arch, shape, sidx)
        # the graph alone: exact distances on every hop, the same params
        graph_res = search(idx.graph, q, sp)
        served[name] = dict(batch=B, s=secs, qps=B / secs,
                            recall=recall_at(ids, gt),
                            graph_recall=recall_at(graph_res.ids, gt),
                            graph_mean_hops=float(
                                graph_res.n_hops.float().mean()),
                            mean_hops=float(hops.mean()),
                            max_hops=int(hops.max()),
                            model_tflops=flops / secs / 1e12,
                            launches=counts[path])
        if name == "serve_online":
            plain = make_sharded_search(merge="all_gather", quantized=True,
                                        backend="jnp")(sidx, q, sp)
            served[name]["plain_agree"] = agree(plain[0], ids)
            check(served[name]["plain_agree"] >= MIN_AGREE,
                  f"{path}: ids match the plain path on "
                  f"{served[name]['plain_agree']:.4f} of queries")
        r = served[name]
        print(f"[sift1m] {name}: {B} queries in one call, {secs:.3f} s, QPS "
              f"{r['qps']:.1f}, hops mean {r['mean_hops']:.1f} max "
              f"{r['max_hops']}, recall@10 {r['recall']:.4f} (the exact "
              f"search on the same graph: {r['graph_recall']:.4f}, hops "
              f"mean {r['graph_mean_hops']:.1f}), model "
              f"{r['model_tflops']:.4g} TFLOP/s (B·l_max·2·d = {flops:.4g})"
              + (f", ids equal to the plain path on {r['plain_agree']:.4f}"
                 if "plain_agree" in r else "")
              + f"; launches {json.dumps(counts[path])} ({card})")
    out.update(served)
    return out


def synced_ms(torch, fn, reps: int = 5):
    """(median host-clock ms of ``reps`` synchronised ``fn()`` calls after
    one warm-up, the last call's output)."""
    out = fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), out


def rel_err(got, want) -> float:
    """max |got − want| / max |want| (on want's device)."""
    got = got.to(want.device)
    return float((got - want).abs().max() / want.abs().max())


def recsys_control(torch, arch_id: str):
    """The arch's serve function (cfg, params, batch) with one part broken
    on purpose, the control that must break ``RECSYS_TOL``: FM without its
    pairwise term, DCN-v2 without its last cross layer, DIEN with the
    AUGRU's attention at 1, MIND with one routing iteration fewer."""
    from repro_torch.launch import steps
    from repro_torch.models import recsys as rs

    serve = steps._RECSYS_SERVE[arch_id]
    if arch_id == "fm":
        def fm_without_pair(cfg, p, b):
            w = rs.field_lookup_flat(p["lin"], b["sparse_ids"], cfg.rows)
            return (p["bias"] + w[..., 0].sum(1)).float()
        return fm_without_pair
    if arch_id == "dcn-v2":
        return lambda cfg, p, b: serve(
            dataclasses.replace(cfg, n_cross=cfg.n_cross - 1), p, b)
    if arch_id == "mind":
        return lambda cfg, p, b: serve(
            dataclasses.replace(cfg, routing_iters=cfg.routing_iters - 1),
            p, b)

    def dien_attention_at_one(cfg, p, b):
        real = rs._target_attention
        rs._target_attention = lambda scores, mask: torch.ones_like(scores)
        try:
            return serve(cfg, p, b)
        finally:
            rs._target_attention = real
    return dien_attention_at_one


def recsys_recompute(torch, arch_id: str, fn, cfg, params, user, ids,
                     scores) -> float:
    """The relative error of retrieved scores against the arch's serve
    function ``fn`` (or its control) recomputed for the returned ids: dcn
    and dien score a batch of the user's features with each id as the
    candidate, mind the interests ``fn`` gives against each id's item
    row; fm's score is the logit less the user's own terms, one constant,
    so the spread of logit − score is the error.  Each relative to the
    recomputed values' largest magnitude."""
    k = ids.shape[0]
    if arch_id in ("fm", "dcn-v2"):
        rows = torch.cat([ids[:, None].to(user["sparse_ids"].dtype),
                          user["sparse_ids"][:, 1:].expand(k, -1)], 1)
        batch = {"sparse_ids": rows}
        if arch_id == "dcn-v2":
            batch["dense"] = user["dense"].expand(k, -1)
        logit = fn(cfg, params, batch)
        if arch_id == "dcn-v2":
            return rel_err(scores, logit)
        c = logit - scores
        return float((c - c.median()).abs().max() / logit.abs().max())
    if arch_id == "dien":
        batch = {key: user[key].expand(k, -1)
                 for key in ("hist_items", "hist_cats", "hist_mask")}
        batch.update(target_item=ids.to(torch.int32),
                     target_cat=(ids % cfg.n_cats).to(torch.int32))
        return rel_err(scores, fn(cfg, params, batch))
    caps = fn(cfg, params, user)[0]                          # [K, d]
    want = (caps @ params["item_emb"][ids.long()].T).amax(0)
    return rel_err(scores, want)


def recsys_serve(torch, arch, params, card: str) -> dict:
    """serve_p99 and serve_bulk: the serve cell's function on a batch of
    the synthetic logs; median host-clock ms of 5 synchronised calls,
    samples/s, model FLOP/s (``_recsys_model_flops``), peak memory."""
    from repro_torch.launch import steps

    cfg = arch.model_cfg
    fn = steps._RECSYS_SERVE[arch.id]
    out = {}
    for shape in ("serve_p99", "serve_bulk"):
        B = arch.shapes[shape].dims["batch"]
        batch = steps.recsys_batch(arch.id, cfg, B, step=0, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms, y = synced_ms(torch, lambda: fn(cfg, params, batch))
        want = ((B, cfg.n_interests, cfg.embed_dim) if arch.id == "mind"
                else (B,))
        check(tuple(y.shape) == want and bool(torch.isfinite(y).all()),
              f"{arch.id} {shape}: output {tuple(y.shape)} is not {want} "
              "finite values")
        flops = steps._recsys_model_flops(arch, B)
        out[shape] = dict(
            batch=B, ms=ms, samples_per_s=B / ms * 1e3,
            model_tflop_per_s=flops / ms / 1e9,
            peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        print(f"[recsys] {arch.id} {shape} (B={B}): {ms:.3f} ms "
              f"(median of 5, synchronised), "
              f"{out[shape]['samples_per_s']:.0f} samples/s, "
              f"{out[shape]['model_tflop_per_s']:.3f} model TFLOP/s, peak "
              f"{out[shape]['peak_gb']:.2f} GB ({card})")
        del batch, y
    return out


def recsys_checks(torch, arch, params, host, card: str) -> dict:
    """Card = CPU: serve_p99's output on the card against the same port
    function on the CPU with the parameters copied there; the retrieval
    over the first ``RECSYS_CPU_CAND`` candidates on both (ids as sets on
    ``MIN_AGREE``, sorted scores); then retrieval_cand (one user against
    10⁶ candidates, top ``RECSYS_K``) timed, its list sorted with ties in
    ascending id, and its scores against the forward recomputed for the
    returned ids.  Each error within ``RECSYS_TOL``; the arch's control
    must break it on serve_p99 and on the recomputed scores."""
    from repro_torch.launch import steps

    cfg, aid = arch.model_cfg, arch.id
    serve, control = steps._RECSYS_SERVE[aid], recsys_control(torch, aid)
    retrieve = steps._RECSYS_RETRIEVAL[aid]
    B = arch.shapes["serve_p99"].dims["batch"]
    batch = steps.recsys_batch(aid, cfg, B, step=0, device="cuda")
    host_batch = {k: v.cpu() for k, v in batch.items()}
    want = serve(cfg, host, host_batch)
    r = dict(serve_err=rel_err(serve(cfg, params, batch), want),
             serve_control=rel_err(control(cfg, params, batch), want))

    user = steps.recsys_batch(aid, cfg, 1, step=1, device="cuda")
    host_user = {k: v.cpu() for k, v in user.items()}
    cand = torch.arange(RECSYS_CPU_CAND, dtype=torch.int32, device="cuda")
    s_card, i_card = retrieve(cfg, params, user, cand, RECSYS_K)
    s_cpu, i_cpu = retrieve(cfg, host, host_user, cand.cpu(), RECSYS_K)
    r["cpu_ids_agree"] = len(set(i_card[0].tolist())
                             & set(i_cpu[0].tolist())) / RECSYS_K
    r["cpu_scores_err"] = rel_err(s_card, s_cpu)

    C = arch.shapes["retrieval_cand"].dims["n_candidates"]
    # the candidates are their positions, so fm's positions are its ids
    cand = torch.arange(C, dtype=torch.int32, device="cuda")
    ms, (scores, ids) = synced_ms(
        torch, lambda: retrieve(cfg, params, user, cand, RECSYS_K), reps=3)
    s, i = scores[0], ids[0]
    check(tuple(scores.shape) == tuple(ids.shape) == (1, RECSYS_K)
          and bool(torch.isfinite(s).all()),
          f"{aid} retrieval: not {RECSYS_K} finite scores")
    tie = s[1:] == s[:-1]
    check(bool((s[1:] <= s[:-1]).all()) and bool((i[1:] > i[:-1])[tie].all()),
          f"{aid} retrieval: the list is not sorted, ties in ascending id")
    r.update(retrieval_ms=ms, retrieval_ties=int(tie.sum()),
             recompute_err=recsys_recompute(torch, aid, serve, cfg, params,
                                            user, i, s),
             recompute_control=recsys_recompute(torch, aid, control, cfg,
                                                params, user, i, s))
    for key, bound_ok in (("serve_err", True), ("cpu_scores_err", True),
                          ("recompute_err", True), ("serve_control", False),
                          ("recompute_control", False)):
        check((r[key] <= RECSYS_TOL) == bound_ok,
              f"{aid} {key} {r[key]:.3g} against RECSYS_TOL {RECSYS_TOL} "
              f"({'must hold' if bound_ok else 'the control must break it'})")
    check(r["cpu_ids_agree"] >= MIN_AGREE,
          f"{aid} retrieval ids on the card and the CPU agree on "
          f"{r['cpu_ids_agree']:.3f}")
    print(f"[recsys] {aid} card = CPU: serve_p99 {r['serve_err']:.3g} "
          f"(control {r['serve_control']:.3g}), retrieval over "
          f"{RECSYS_CPU_CAND:,} ids agree {r['cpu_ids_agree']:.3f} scores "
          f"{r['cpu_scores_err']:.3g}; retrieval_cand {C:,} candidates top "
          f"{RECSYS_K}: {ms:.3f} ms (median of 3, synchronised), "
          f"{r['retrieval_ties']} ties, scores = forward recomputed "
          f"{r['recompute_err']:.3g} (control {r['recompute_control']:.3g}); "
          f"bound {RECSYS_TOL} ({card})")
    return r


def mind_index(torch, arch, params, card: str, counts: dict) -> dict:
    """MIND's retrieval through the δ-EMQG MIPS index, as the reference's
    integration benchmark runs it (``benchmarks/retrieval.py``) at MIND's
    full width: ``build_mips(quantized=True)`` over the first
    ``RECSYS_INDEX_N`` item rows (d + 1 = 65: three code words, the
    ragged-d kernels; path ``recsys_build``), the interests of
    ``RECSYS_USERS`` users as 64 queries through ``mips_search`` (path
    ``recsys_retrieval``), each user's results merged by the true
    max-over-interests dot product; recall@100 against exact
    ``mind_retrieval`` over the same items and the distance budget
    printed."""
    from repro_torch.core import BuildParams
    from repro_torch.core.mips import build_mips, ip_from_l2, mips_search
    from repro_torch.models import recsys as rs

    cfg, N, K = arch.model_cfg, RECSYS_INDEX_N, RECSYS_SEARCH["k"]
    items = params["item_emb"][:N]
    reset_counts()
    t0 = time.perf_counter()
    mips = build_mips(items.cpu().numpy(), BuildParams(**BUILD_PARAMS),
                      quantized=True, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    counts["recsys_build"] = kernel_counts()
    check(mips.index.codes.words == 3, "MIND's codes are not 3 words wide")

    rng = np.random.default_rng(0)
    hist = torch.from_numpy(rng.integers(0, N, (RECSYS_USERS, cfg.seq_len))
                            .astype(np.int32)).cuda()
    mask = torch.ones_like(hist, dtype=torch.bool)
    caps = rs.mind_user_interests(cfg, params, hist, mask)   # [U, Kc, d]
    flat_q = caps.reshape(-1, cfg.embed_dim).cpu().numpy()
    plain = mips_search(mips, flat_q, backend="jnp", **RECSYS_SEARCH)
    reset_counts()
    t0 = time.perf_counter()
    res = mips_search(mips, flat_q, **RECSYS_SEARCH)
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t0
    counts["recsys_retrieval"] = kernel_counts()
    for path, ragged in (("recsys_build",
                          ("gather_l2_ragged", "batched_l2_ragged")),
                         ("recsys_retrieval",
                          ("gather_l2_ragged", "fused_estimate"))):
        for kernel in ragged:
            check(counts[path][kernel] > 0, f"{path} never launched {kernel}")
        for kernel in ("gather_l2_blocks", "batched_l2_blocks"):
            check(counts[path][kernel] == 0,
                  f"{path} launched {kernel} {counts[path][kernel]} times")
    share = agree(res.ids, plain.ids)
    check(share >= MIN_AGREE,
          f"MIND's index ids match the plain path on {share:.4f}")
    ids = res.ids.long()
    check(bool((ids >= 0).all()), "the index returned fewer than k items")
    q = torch.from_numpy(flat_q).cuda()
    exact_ip = torch.einsum("bd,bkd->bk", q, items[ids])
    served_ip = torch.from_numpy(np.asarray(
        ip_from_l2(flat_q, res.dists, mips.radius), np.float32)).cuda()
    ip_err = float(((served_ip - exact_ip).abs()
                    / (q.norm(dim=1, keepdim=True) * mips.radius)).max())
    check(ip_err <= 1e-4, f"served inner products are off the exact ones "
          f"by {ip_err:.3g} of ‖q‖·R")

    _, want = rs.mind_retrieval(cfg, params, hist, mask,
                                torch.arange(N, dtype=torch.int32,
                                             device="cuda"), k=K)
    per_user = ids.view(RECSYS_USERS, cfg.n_interests * K)
    hits = 0
    for b in range(RECSYS_USERS):
        cand = torch.unique(per_user[b])
        s = (caps[b] @ items[cand].T).amax(0)
        got = cand[torch.sort(s, descending=True, stable=True).indices[:K]]
        hits += len(set(got.tolist()) & set(want[b].tolist()))
    out = dict(n_items=N, build_s=build_s, search_s=search_s,
               recall_at_100=hits / (RECSYS_USERS * K), ids_equal_plain=share,
               ip_err=ip_err,
               exact_comps=float(res.n_dist_comps.float().mean()),
               approx_comps=float(res.n_approx_comps.float().mean()),
               brute_force_comps=N * cfg.n_interests)
    print(f"[recsys] mind through the δ-EMQG index: {N:,} items "
          f"d={cfg.embed_dim}+1 "
          f"built in {build_s:.1f} s; {RECSYS_USERS} users × "
          f"{cfg.n_interests} interests searched in {search_s:.3f} s; "
          f"recall@{K} against exact mind_retrieval "
          f"{out['recall_at_100']:.4f}; "
          f"distance computations a query {out['exact_comps']:.1f} exact + "
          f"{out['approx_comps']:.1f} approximate against "
          f"{N:,} × {cfg.n_interests} = {out['brute_force_comps']:,} for "
          f"brute force a user; ids equal to the plain path on {share:.4f} "
          f"of {len(flat_q)} queries; served inner products within "
          f"{ip_err:.3g} of ‖q‖·R; launches "
          f"{json.dumps(counts['recsys_retrieval'])}; "
          f"the build's {json.dumps(counts['recsys_build'])} ({card})")
    return out


def recsys_phase(torch, card: str, counts: dict, out: Path) -> dict:
    """The four recsys archs at their published widths in f32, weights from
    a seeded generator, one arch's tables on the card at a time:
    ``recsys_serve``, ``recsys_checks``, for DIEN one profiled serve_p99
    forward, for MIND ``mind_index``."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import steps
    from repro_torch.optim.adamw import tree_leaves, tree_map

    summary = {}
    for aid in RECSYS_ARCHS:
        t_arch = time.perf_counter()
        arch = get_arch(aid)
        cfg = arch.model_cfg
        params = steps._RECSYS_INIT[aid](
            cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
        n_params = sum(t.numel() for t in tree_leaves(params))
        print(f"[recsys] {aid} ({arch.source}): {n_params:,} parameters, "
              f"{4 * n_params / 1e9:.2f} GB in f32 on the card ({card})")
        row = dict(params=n_params, **recsys_serve(torch, arch, params, card))
        host = tree_map(lambda t: t.cpu(), params)
        row.update(recsys_checks(torch, arch, params, host, card))
        del host
        if aid == "dien":
            B = arch.shapes["serve_p99"].dims["batch"]
            batch = steps.recsys_batch(aid, cfg, B, step=0, device="cuda")
            prof, _ = _profiled(
                torch, lambda: steps._RECSYS_SERVE[aid](cfg, params, batch),
                "recsys_dien_serve_p99", out, cpu=False)
            prof.update(arch=aid, batch=B, card=card)
            print(f"[profile] {json.dumps(prof)}")
            row["profile"] = prof
        if aid == "mind":
            row["index"] = mind_index(torch, arch, params, card, counts)
        del params
        torch.cuda.empty_cache()
        summary[aid] = dict(row, seconds=time.perf_counter() - t_arch)
    return summary


def _loss_and_grads(torch, loss, params, batch) -> tuple[float, list]:
    """(the loss, its gradient with respect to every leaf of ``params`` in
    tree order, zeros for a leaf the loss does not read)."""
    from repro_torch.optim.adamw import tree_leaves, tree_unflatten

    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    value, _ = loss(tree_unflatten(params, leaves), batch)
    grads = torch.autograd.grad(value, leaves, allow_unused=True)
    return float(value.detach()), [
        torch.zeros_like(p) if g is None else g.detach()
        for p, g in zip(leaves, grads)]


def _leaf_names(tree, prefix: str = "") -> list:
    """The "/"-joined paths of a tree's leaves, in ``tree_leaves``' order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in _leaf_names(v, f"{prefix}/{i}")]
    return [prefix.lstrip("/")]


def _against_host(torch, grads: list, host: list) -> tuple[float, int]:
    """(the largest per-leaf ‖card − CPU‖ / ‖CPU‖, its leaf's index), each
    CPU leaf copied to the card in turn and compared there."""
    errs = [_rel_errors([g], [h.to(g.device)])[0]
            for g, h in zip(grads, host)]
    return max(errs), int(np.argmax(errs))


def recsys_train_control(torch, arch_id: str):
    """The arch's loss of (cfg, params, batch) with ``recsys_control``'s
    part broken: FM without its pairwise term, DCN-v2 without its last
    cross layer, DIEN's attention at 1 (its BCE over those forwards), MIND
    at one routing iteration fewer."""
    from repro_torch.models import recsys as rs

    if arch_id == "mind":
        return lambda cfg, p, b: rs.mind_loss(
            dataclasses.replace(cfg, routing_iters=cfg.routing_iters - 1),
            p, b)
    forward = recsys_control(torch, arch_id)
    return lambda cfg, p, b: rs._bce(forward(cfg, p, b), b["label"])


def recsys_train_phase(torch, card: str) -> dict:
    """FM, DCN-v2, DIEN and MIND trained at published widths in f32 at
    ``train_batch`` (65,536; the microbatch cut ``plan_recsys_accum``
    prints), one arch on the card at a time: card = CPU on one batch of
    ``RECSYS_CPU_BATCH`` (the loss and every gradient leaf, each arch's
    control over the bound), ``RECSYS_TRAIN_STEPS`` steps of
    ``make_train_step`` under ``_recsys_train_cell``'s ``OptConfig``
    (the loss finite), seconds a step, samples/s, model TFLOP/s, peak
    memory; DIEN under ``torch.use_deterministic_algorithms`` with a
    checkpoint after step ``RECSYS_RESUME_AT``, restored, the last step
    run again: loss and state bitwise."""
    import shutil

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_arch
    from repro_torch.launch import steps
    from repro_torch.launch.train import plan_recsys_accum
    from repro_torch.optim import OptConfig
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.train import TrainState, make_train_step

    card_bytes = torch.cuda.get_device_properties(0).total_memory
    summary = {}
    for aid in RECSYS_ARCHS:
        t_arch = time.perf_counter()
        arch = get_arch(aid)
        cfg = arch.model_cfg
        B = arch.shapes["train_batch"].dims["batch"]
        accum = plan_recsys_accum(arch, card_bytes)
        params = steps._RECSYS_INIT[aid](
            cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
        n_params = sum(t.numel() for t in tree_leaves(params))
        print(f"[recsys-train] {aid}: {n_params:,} parameters, f32 state "
              f"{16 * n_params / 1e9:.2f} GB; train_batch {B:,} as {accum} "
              f"× {B // accum:,} samples ({card})")

        def loss(p, b, aid=aid, cfg=cfg):
            return steps._RECSYS_LOSS[aid](cfg, p, b)

        control = recsys_train_control(torch, aid)
        small = steps.recsys_batch(aid, cfg, RECSYS_CPU_BATCH, step=0,
                                   device="cuda")
        host = tree_map(lambda t: t.cpu(), params)
        h_loss, h_grads = _loss_and_grads(
            torch, loss, host, {k: v.cpu() for k, v in small.items()})
        del host
        k_loss, k_grads = _loss_and_grads(torch, loss, params, small)
        sound, worst = _against_host(torch, k_grads, h_grads)
        del k_grads
        _, x_grads = _loss_and_grads(
            torch, lambda p, b: control(cfg, p, b), params, small)
        ctrl, _ = _against_host(torch, x_grads, h_grads)
        del x_grads, h_grads
        loss_err = abs(k_loss - h_loss) / abs(h_loss)
        print(f"[recsys-train] {aid} card = CPU on a batch of "
              f"{RECSYS_CPU_BATCH}: loss {k_loss:.7f} vs {h_loss:.7f} "
              f"(relative {loss_err:.3g}); the largest per-leaf gradient "
              f"‖Δ‖/‖CPU‖ {sound:.3g} ({_leaf_names(params)[worst]}), "
              f"control {ctrl:.3g} (bound "
              f"{RECSYS_GRAD_TOL}) ({card})")
        check(loss_err <= RECSYS_GRAD_TOL and sound <= RECSYS_GRAD_TOL,
              f"{aid}: the card's loss or gradients differ from the CPU's: "
              f"{loss_err}, {sound} > {RECSYS_GRAD_TOL}")
        check(ctrl > RECSYS_GRAD_TOL, f"{aid}: the gradient bound "
              f"{RECSYS_GRAD_TOL} does not see its control ({ctrl})")

        opt = OptConfig(total_steps=100000)      # _recsys_train_cell's
        step_fn = make_train_step(loss, opt, accum_steps=accum)

        def batch_of(s, aid=aid, cfg=cfg, B=B, accum=accum):
            b = steps.recsys_batch(aid, cfg, B, step=s, device="cuda")
            return b if accum == 1 else {
                k: v.reshape(accum, B // accum, *v.shape[1:])
                for k, v in b.items()}

        batches = [batch_of(s) for s in range(RECSYS_TRAIN_STEPS)]
        state = TrainState.create(params, opt)
        del params
        resume = aid == "dien"
        ckpt_dir = ROOT / "build" / "recsys_train" / "ckpt"
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        mgr = CheckpointManager(str(ckpt_dir), every=RECSYS_RESUME_AT,
                                keep=1, async_save=False)
        torch.use_deterministic_algorithms(resume)
        try:
            losses, step_s = [], []
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            for s in range(RECSYS_TRAIN_STEPS):
                t0 = time.perf_counter()
                state, m = step_fn(state, batches[s])
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
                losses.append(float(m["loss"]))
                if resume:
                    mgr.maybe_save(s + 1, state)
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            if resume:
                t0 = time.perf_counter()
                step0, back = mgr.restore(state, device="cuda")
                restore_s = time.perf_counter() - t0
                check(step0 == RECSYS_RESUME_AT and int(back.step) == step0,
                      f"dien: restored step {step0}, state step "
                      f"{int(back.step)}")
                for s in range(RECSYS_RESUME_AT, RECSYS_TRAIN_STEPS):
                    back, m = step_fn(back, batches[s])
                same = all(torch.equal(a, b) for a, b in zip(
                    tree_leaves([state.params, state.opt_state, state.step]),
                    tree_leaves([back.params, back.opt_state, back.step])))
                check(float(m["loss"]) == losses[-1] and same,
                      f"dien resumed at step {RECSYS_RESUME_AT}: loss "
                      f"{float(m['loss'])} against {losses[-1]}, state "
                      f"bitwise {same}")
                del back
        finally:
            torch.use_deterministic_algorithms(False)
        check(all(np.isfinite(losses)), f"{aid}: a loss is not finite: "
              f"{losses}")
        secs = float(np.median(step_s[1:]))
        flops = 3 * steps._recsys_model_flops(arch, B)
        row = dict(params=n_params, batch=B, accum=accum, losses=losses,
                   first_step_s=step_s[0], step_s=secs,
                   samples_per_s=B / secs,
                   model_tflop_per_s=flops / secs / 1e12, peak_gb=peak_gb,
                   loss_rel_err=loss_err, grad_rel_err=sound,
                   grad_control=ctrl, deterministic=resume)
        if resume:
            row.update(resume_at=RECSYS_RESUME_AT, resumed_bitwise=True,
                       restore_s=restore_s)
        print(f"[recsys-train] {aid}: {RECSYS_TRAIN_STEPS} steps of {B:,} "
              f"({accum} × {B // accum:,}), loss "
              + " → ".join(f"{x:.5f}" for x in losses)
              + f"; {secs:.4f} s a step ("
              + ("under torch.use_deterministic_algorithms, which "
                 "launch.train does not set; " if resume else "")
              + f"median of steps 2-{RECSYS_TRAIN_STEPS}, synchronised; "
              f"first {step_s[0]:.3f}), "
              f"{B / secs:.0f} samples/s, {flops / secs / 1e12:.3f} model "
              f"TFLOP/s (3 × _recsys_model_flops), peak {peak_gb:.2f} GB"
              + (f"; resumed from its step-{RECSYS_RESUME_AT} checkpoint "
                 f"(restore {restore_s:.2f} s): the last step's loss and "
                 f"every state tensor bitwise the uninterrupted run's, "
                 f"deterministic algorithms on" if resume else "")
              + f" ({card})")
        del state, batches
        torch.cuda.empty_cache()
        summary[aid] = dict(row, seconds=time.perf_counter() - t_arch)
    return summary


def gat_layer0_f64(torch, p: dict, x, src, dst, nodes, cfg):
    """Layer 0's output at ``nodes`` recomputed in float64 from their own
    in-edges alone: the scores, a softmax over each node's in-edges, the
    messages, ELU and the bias."""
    H, slope = cfg.n_heads, cfg.negative_slope
    sel = torch.isin(dst, nodes)
    s_e, d_e = src[sel].long(), dst[sel].long()
    where = torch.full((x.shape[0],), -1, dtype=torch.long, device=x.device)
    where[nodes.long()] = torch.arange(nodes.numel(), device=x.device)
    pos = where[d_e]
    w = p["w"].double()
    hs = (x[s_e].double() @ w).reshape(s_e.numel(), H, -1)
    hd = (x[nodes.long()].double() @ w).reshape(nodes.numel(), H, -1)
    e = (torch.einsum("ehd,hd->eh", hs, p["a_src"].double())
         + torch.einsum("nhd,hd->nh", hd, p["a_dst"].double())[pos])
    e = torch.where(e >= 0, e, slope * e)
    top = torch.full((nodes.numel(), H), float("-inf"), dtype=torch.float64,
                     device=x.device).scatter_reduce(
        0, pos[:, None].expand(-1, H), e, "amax")
    z = torch.exp(e - top[pos])
    den = torch.zeros_like(top).index_add(0, pos, z)
    agg = torch.zeros_like(hd).index_add(0, pos, z[:, :, None] * hs)
    out = agg / torch.clamp_min(den[:, :, None], 1e-9)
    return (torch.nn.functional.elu(out).reshape(nodes.numel(), -1)
            + p["b"].double())


def gnn_cpu_check(torch, arch, shape_name: str, params, batch, card: str):
    """Card = CPU at a cell: the logits, loss and every gradient leaf of
    the port on the card against the port on the CPU with the parameters
    copied there; the control, the last ``GNN_CONTROL_SHARE`` of the real
    edges dropped on the card, must read over ``GNN_CPU_TOL``."""
    from repro_torch.launch import steps
    from repro_torch.models import gnn
    from repro_torch.optim.adamw import tree_map

    cfg = arch.model_cfg[shape_name]
    loss = steps.gnn_loss(cfg)
    host_b = {k: v.cpu() if isinstance(v, torch.Tensor) else v
              for k, v in batch.items()}
    host = tree_map(lambda t: t.cpu(), params)
    h_loss, h_grads = _loss_and_grads(torch, loss, host, host_b)
    k_loss, k_grads = _loss_and_grads(torch, loss, params, batch)
    with torch.no_grad():
        h_out = gnn.forward(cfg, host, host_b["x"], host_b["src"],
                            host_b["dst"])
        k_out = gnn.forward(cfg, params, batch["x"], batch["src"],
                            batch["dst"])
    out_err = rel_err(k_out.cpu(), h_out)
    sound, worst = _against_host(torch, k_grads, h_grads)
    real = torch.nonzero(batch["src"] >= 0)[:, 0]
    cut = real[-max(1, int(GNN_CONTROL_SHARE * real.numel())):]
    broken = dict(batch, src=batch["src"].index_fill(0, cut, -1),
                  dst=batch["dst"].index_fill(0, cut, -1))
    ctrl, _ = _against_host(torch, _loss_and_grads(torch, loss, params,
                                                   broken)[1], h_grads)
    loss_err = abs(k_loss - h_loss) / abs(h_loss)
    print(f"[gnn] {shape_name} card = CPU: logits {out_err:.3g}, loss "
          f"{k_loss:.7f} vs {h_loss:.7f} ({loss_err:.3g}), the largest "
          f"per-leaf gradient ‖Δ‖/‖CPU‖ {sound:.3g} "
          f"({_leaf_names(params)[worst]}); control ({cut.numel()} "
          f"of {real.numel()} edges dropped) {ctrl:.3g} (bound "
          f"{GNN_CPU_TOL}) ({card})")
    check(max(out_err, loss_err, sound) <= GNN_CPU_TOL,
          f"gnn {shape_name}: the card differs from the CPU: logits "
          f"{out_err}, loss {loss_err}, gradients {sound} > {GNN_CPU_TOL}")
    check(ctrl > GNN_CPU_TOL, f"gnn {shape_name}: the bound {GNN_CPU_TOL} "
          f"does not see its control ({ctrl})")
    return dict(logits_rel_err=out_err, loss_rel_err=loss_err,
                grad_rel_err=sound, grad_control=ctrl)


def gnn_phase(torch, card: str) -> dict:
    """gat-cora trained on the card at its four cells (weights from a
    seeded generator, f32, ``_gnn_cell``'s ``OptConfig``): full_graph_sm
    and molecule ``GNN_STEPS`` steps each (the loss finite, falling on
    the full graph), minibatch_lg on two sampled subgraphs of a
    reddit-shaped graph (nothing cut by the pads; the host's graph, CSR
    and sampler seconds apart from the steps'), ogb_products full-batch
    in edge chunks (``plan_edge_chunk``): the loss finite, the planned
    chunk against half of it, 1,000 nodes' layer-0 output against a
    float64 recomputation; card = CPU at the three small cells.  The
    large cells' graphs are made here, in ``data_s``: ``sbm_graph`` on
    the host, minibatch_lg's ``CSRGraph.from_edges`` on the card."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import steps
    from repro_torch.models import gnn
    from repro_torch.optim import OptConfig
    from repro_torch.train import TrainState, make_train_step

    arch = get_arch("gat-cora")
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    summary = {}
    for name in ("full_graph_sm", "molecule", "minibatch_lg", "ogb_products"):
        t_cell = time.perf_counter()
        cfg, shape = arch.model_cfg[name], arch.shapes[name]
        n_nodes, n_edges, _ = steps._gnn_sizes(shape)
        chunk = gnn.plan_edge_chunk(cfg, n_nodes, n_edges, card_bytes)
        params = gnn.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                          device="cuda")
        row = dict(nodes=n_nodes, edges=n_edges, edge_chunk=chunk)
        t0 = time.perf_counter()
        if shape.kind == "full_graph":
            full = steps.gnn_batch(arch, name, 0, device="cuda")
            check(full["src"].numel() == n_edges,
                  f"{name}: sbm_graph gave {full['src'].numel()} edges, "
                  f"not the cell's {n_edges}")
            batches = [full] * GNN_STEPS[name]
        else:
            batches = [steps.gnn_batch(arch, name, s, device="cuda")
                       for s in range(GNN_STEPS[name])]
        row["data_s"] = time.perf_counter() - t0
        if shape.kind == "minibatch":
            for b in batches:
                steps.check_untruncated(b, shape)
            row.update(graph_s=batches[0]["graph_s"],
                       csr_s=batches[0]["csr_s"],
                       sample_s=[b["sample_s"] for b in batches],
                       sub_nodes=[b["n_sub_nodes"] for b in batches],
                       sub_edges=[b["n_sub_edges"] for b in batches])
            print(f"[gnn] {name}: a reddit-shaped sbm_graph "
                  f"({shape.dims['n_nodes']:,} "
                  f"nodes, {shape.dims['n_edges']:,} edges, "
                  f"{shape.dims['d_feat']} features) {row['graph_s']:.2f} s "
                  f"on the host, CSRGraph.from_edges {row['csr_s']:.2f} s "
                  f"on the card, "
                  f"fanout {shape.dims['fanout']} from "
                  f"{shape.dims['batch_nodes']} seed nodes "
                  + ", ".join(f"{s:.2f}" for s in row["sample_s"])
                  + " s: subgraphs of "
                  + ", ".join(f"{a:,} nodes / {e:,} edges" for a, e in
                              zip(row["sub_nodes"], row["sub_edges"]))
                  + f", none cut by the pads ({shape.dims['pad_nodes']:,} / "
                  f"{shape.dims['pad_edges']:,}) ({card})")
        elif shape.kind == "full_graph":
            row["graph_s"] = full["graph_s"]
        if name != "ogb_products":
            row.update(gnn_cpu_check(torch, arch, name, params, batches[0],
                                     card))
        opt = OptConfig(total_steps=1000)             # _gnn_cell's
        loss = steps.gnn_loss(cfg, chunk)
        step_fn = make_train_step(loss, opt)
        if name == "ogb_products":
            row.update(ogb_checks(torch, cfg, params, full, chunk, card))
        state = TrainState.create(params, opt)
        del params
        losses, step_s = [], []
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        for b in batches:
            t0 = time.perf_counter()
            state, m = step_fn(state, b)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        check(all(np.isfinite(losses)), f"gnn {name}: a loss is not finite: "
              f"{losses}")
        if name == "full_graph_sm":
            check(losses[-1] < losses[0], f"gnn {name}: the loss did not "
                  f"fall: {losses}")
        secs = float(np.median(step_s[1:])) if len(step_s) > 1 else step_s[0]
        flops = steps._gnn_model_flops(arch, name)
        row.update(losses=losses, first_step_s=step_s[0], step_s=secs,
                   edges_per_s=n_edges / secs,
                   model_tflop_per_s=flops / secs / 1e12, peak_gb=peak_gb)
        print(f"[gnn] {name}: {n_nodes:,} nodes, {n_edges:,} edges, "
              + ("in one piece" if chunk is None else
                 f"in chunks of {chunk:,} edges (plan_edge_chunk)")
              + f"; {len(losses)} steps, loss "
              + " → ".join(f"{x:.5f}" for x in losses)
              + f"; {secs:.4f} s a step (median after the first, "
              f"synchronised; first {step_s[0]:.3f}), {n_edges / secs:.4g} "
              f"edges/s, {flops / secs / 1e12:.4f} model TFLOP/s "
              f"(_gnn_model_flops), peak {peak_gb:.2f} GB; data "
              f"{row['data_s']:.2f} s ({card})")
        del state, batches
        if shape.kind == "full_graph":
            del full
        torch.cuda.empty_cache()
        summary[name] = dict(row, seconds=time.perf_counter() - t_cell)
    steps.host_graph.cache_clear()
    return summary


def ogb_checks(torch, cfg, params, batch, chunk: int, card: str) -> dict:
    """ogb_products before its steps: the loss and gradients at the planned
    chunk against half of it (``GNN_CHUNK_TOL``), and layer 0's output at
    ``GNN_F64_NODES`` random nodes against ``gat_layer0_f64``
    (``GNN_F64_TOL`` of its largest magnitude)."""
    from repro_torch.launch import steps
    from repro_torch.models import gnn

    check(chunk is not None and chunk < batch["src"].numel(),
          f"ogb_products planned in one piece ({chunk})")
    t0 = time.perf_counter()
    a_loss, a_grads = _loss_and_grads(torch, steps.gnn_loss(cfg, chunk),
                                      params, batch)
    b_loss, b_grads = _loss_and_grads(torch, steps.gnn_loss(cfg, chunk // 2),
                                      params, batch)
    halves = max(_rel_errors(a_grads, b_grads))
    del a_grads, b_grads
    grads_s = time.perf_counter() - t0
    x, src, dst = batch["x"], batch["src"], batch["dst"]
    with torch.no_grad():
        out0 = gnn._gat_layer(params["layer0"], x, src, dst, src >= 0,
                              x.shape[0], cfg.n_heads, cfg.negative_slope,
                              mean_heads=False, edge_chunk=chunk)
    gen = torch.Generator(device="cuda").manual_seed(0)
    nodes = torch.randperm(x.shape[0], device="cuda", generator=gen)[
        :GNN_F64_NODES].to(torch.int32)
    want = gat_layer0_f64(torch, params["layer0"], x, src, dst, nodes, cfg)
    f64 = rel_err(out0[nodes.long()].double(), want)
    del out0
    loss_err = abs(a_loss - b_loss) / abs(b_loss)
    print(f"[gnn] ogb_products: chunks of {chunk:,} against {chunk // 2:,} "
          f"on the same parameters: loss {a_loss:.7f} vs {b_loss:.7f} "
          f"({loss_err:.3g}), the largest per-leaf gradient ‖Δ‖/‖·‖ "
          f"{halves:.3g} (bound {GNN_CHUNK_TOL}; {grads_s:.2f} s for both); "
          f"layer 0 at {GNN_F64_NODES} random nodes against a float64 "
          f"recomputation from their own in-edges: {f64:.3g} of its largest "
          f"magnitude (bound {GNN_F64_TOL}) ({card})")
    check(max(loss_err, halves) <= GNN_CHUNK_TOL,
          f"ogb_products: chunk {chunk} and {chunk // 2} differ: loss "
          f"{loss_err}, gradients {halves}")
    check(f64 <= GNN_F64_TOL, f"ogb_products: layer 0 differs from its "
          f"float64 recomputation by {f64}")
    return dict(chunk_half_loss_err=loss_err, chunk_half_grad_err=halves,
                layer0_f64_err=f64)


def flash_rows(torch, card: str, cfg, S: int, path: str = "lm_prefill",
               tag: str = "lm", batch: int = 1, extras: bool = True) -> dict:
    """flash_attention at the path's shape (``batch`` sequences of S,
    ``cfg``'s heads and head_dim) against the plain blockwise attention
    (the full matrix would be 39 GB of scores at smollm's prefill), timed
    beside its plain version and SDPA; then, with ``extras``, untimed, a
    windowed GQA shape and an S that is no multiple of the 64-row tile, at
    ``cfg``'s head_dim, against the full-matrix version, and the instance's
    compiled resources.  Each is held to ``ref.err_ratio``'s bf16 bound
    against the plain version in f32 on the same values; a control, the
    kernel with a key tile cut from the last row (window S - 64), must
    break it.  The row reports the kernel at ``path``."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.flashattn import ops as flash_ops
    from repro_torch.kernels.flashattn import ref as flash_ref
    from repro_torch.models import common

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)

    def qkv(S, H, KV, hd, B=1):
        return [torch.randn((B, S, n, hd), generator=g, device=dev)
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
        print(f"[{tag}] flash_attention {what}: max error {err:.3g}, "
              f"{ratio:.3f} of the bf16 bound{note}")
        check(bool(torch.isfinite(out).all()) and ratio <= 1.0,
              f"flash_attention {what} is {ratio} of the bf16 bound")
        return err

    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    for n, Hs, KVs, window in (((1000, 8, 2, 100), (4097, 9, 3, None))
                               if extras else ()):
        q, k, v = qkv(n, Hs, KVs, hd)
        G = Hs // KVs
        want = flash_ref.attention_ref(
            q.float(), k.float().repeat_interleave(G, 2),
            v.float().repeat_interleave(G, 2), window=window)
        held(q, k, v, window, want, f"S={n} H={Hs} KV={KVs} hd={hd} "
             f"window={window} against the full matrix")

    B = batch
    q, k, v = qkv(S, H, KV, hd, B)
    want = common.flash_attention(q.float(), k.float(), v.float(),
                                  backend="jnp")
    err = held(q, k, v, None, want, f"[{B},{S},{H}/{KV},{hd}] against the "
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
    flops = 4 * hd * pairs * H * B
    bound_ms, bound_by = bound(2 * B * (2 * S * H * hd + 2 * S * KV * hd),
                               flops, BF16_TC_FLOP_PER_S)
    row = dict(name="flash_attention", route="cuda",
               source="src/repro_torch/kernels/csrc/flash_attn_sm90.cu",
               replaces="src/repro/kernels/flashattn/flashattn.py:101",
               path=path, shape=f"q[{B},{S},{H},{hd}] kv[{B},{S},{KV},"
               f"{hd}] bf16 causal", max_abs_err=err, ms=ms,
               plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
               library_ms=library_ms)
    print(f"[kernel] flash_attention {row['shape']} ({path}): err "
          f"{err:.3g} ms {ms:.4f} plain_ms {plain_ms:.4f} bound_ms "
          f"{bound_ms:.4f} ({bound_by}) library_ms (sdpa) {library_ms:.4f} "
          f"(sdpa against the kernel: max diff {lib_err:.3g}); "
          f"{flops / ms / 1e9:.1f} TFLOP/s, {bound_ms / ms:.3f} of the "
          f"bound, {ms / library_ms:.2f}x SDPA ({card})")
    check(ms <= FLASH_MAX_SDPA_RATIO * library_ms, f"flash_attention takes "
          f"{ms} ms, over {FLASH_MAX_SDPA_RATIO}x SDPA's {library_ms} ms")
    if extras:
        print(f"[kernel] flash_attention bf16 hd={hd} instance: "
              f"{json.dumps(flash_ops.sm90_resources(hd))}; "
              f"{sass_count('flash_attn_sm90')} "
              f"HGMMA instructions in its library; ptxas: "
              f"{ptxas_report(hd)}")
    del q, k, v, out, lib
    torch.cuda.empty_cache()
    return {("flash_attention", path): row}


def sass_count(lib: str, op: str = "HGMMA") -> str:
    """How many ``op`` instructions the library built from ``csrc/<lib>.cu``
    holds (``cuobjdump -sass``), or why that is not known."""
    import shutil

    from repro_torch.kernels import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return "unknown (no cuobjdump)"
    sass = subprocess.run([tool, "-sass", str(_build.library_path(lib))],
                          capture_output=True, text=True, timeout=120)
    if sass.returncode != 0:
        return f"unknown (cuobjdump exit {sass.returncode})"
    return str(sum(op in line for line in sass.stdout.splitlines()))


def ptxas_report(hd: int, lib: str = "flash_attn_sm90",
                 kernels: tuple = ("flash_fwd_sm90",)) -> str:
    """ptxas's lines on the bf16 instances for ``hd`` of ``kernels`` in
    ``lib`` (registers, spills, serialised wgmma) from its build log."""
    from repro_torch.kernels import _build

    lines = _build.build_log(lib).splitlines()
    tags = [f"{k}ILi{hd}E" for k in kernels]
    keep = [ln.strip() for i, ln in enumerate(lines)
            if any(tag in ln or any(tag in p for p in lines[max(0, i - 2):i])
                   for tag in tags)]
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
    n_params = _n_params(params)
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
    profile_prefill(torch, lambda: tf.prefill(cfg, params, toks),
                    "lm_prefill", out, seq=S, card=card)
    del logits

    B, P = LM_GEN["batch"], LM_GEN["prompt"]
    prompts = torch.from_numpy(lm_batch(lm, B, P, step=2)[0]).to(dev)
    pre = tf.prefill(cfg, params, prompts)

    step_err, step_controls = decode_against_prefill(
        torch, cfg, params, prompts, pre, LM_LOGIT_TOL, "lm")
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


def _n_params(tree) -> int:
    """The parameters a tree of tensors holds."""
    if isinstance(tree, dict):
        return sum(_n_params(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_n_params(v) for v in tree)
    return tree.numel()


def decode_against_prefill(torch, cfg, params, prompts, pre, tol: float,
                           tag: str) -> tuple[float, dict]:
    """Step ``prompts`` [B, P] through ``decode_step`` and hold the last
    logits to ``pre`` (prefill's) within ``tol``; two controls, the cache
    one position off (slot 0 left empty but read) and the prompt's first
    token missing from the cache, must read over it.  → (the max
    difference, the controls')."""
    from repro_torch.models import transformer as tf

    B, P = prompts.shape

    def stepped(prompts, shift=0):
        cache = tf.init_cache(cfg, B, LM_GEN["max_seq"],
                              device=prompts.device)
        cache["pos"] += shift
        for t in range(prompts.shape[1]):
            logits, cache = tf.decode_step(cfg, params, cache, prompts[:, t])
        return logits

    step_err = float((stepped(prompts) - pre).abs().max())
    controls = {
        "pos off by one": float((stepped(prompts, 1) - pre).abs().max()),
        "first token dropped": float((stepped(prompts[:, 1:]) - pre)
                                     .abs().max())}
    print(f"[{tag}] decode_step over {B} prompts of {P} against prefill: "
          f"max diff {step_err:.4g} (bound {tol}); controls: " +
          ", ".join(f"{c}: {d:.4g}" for c, d in controls.items()))
    check(step_err <= tol, f"decode_step over the prompt and prefill "
          f"differ by {step_err} > {tol}")
    check(min(controls.values()) > tol, f"the logit bound {tol} does not "
          f"see a broken decode cache: {controls}")
    return step_err, controls


def profile_prefill(torch, fn, phase: str, out: Path,
                    **extra) -> dict:
    """``fn`` (a prefill) under torch.profiler: a ``[profile]`` line with
    the device's busy share and the flash kernel's, the GEMMs' and the MoE
    dispatch's (sorts, searchsorted, scatters and gathers) shares of
    device time."""
    row, avgs = _profiled(torch, fn, phase, out)
    kernel_us = {e.key: _device_us(torch, e) for e in avgs}
    total_us = sum(kernel_us.values())

    def share(match) -> float:
        return sum(us for k, us in kernel_us.items() if match(k)) / total_us

    row.update(**extra,
               flash_share=share(lambda k: "flash_fwd_sm90" in k),
               gemm_share=share(lambda k: any(t in k.lower()
                                              for t in GEMM_TAGS)),
               dispatch_share=share(lambda k: any(t in k.lower()
                                                  for t in DISPATCH_TAGS)))
    print(f"[profile] {json.dumps(row)}")
    return row


def event_ms(torch, fn, reps: int = 5) -> float:
    """Mean time of one eager ``fn()`` call between two CUDA events, after
    two warm-up calls (for work a CUDA graph cannot capture: autograd)."""
    fn()
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def flash_bwd_row(torch, card: str, cfg, S: int, B: int, path: str) -> dict:
    """The backward kernels at the train step's attention shape (``B``
    sequences of S, ``cfg``'s heads), from the forward kernel's output and
    lse, against ``attention_bwd_ref`` in f32 on the same bf16 values (dq,
    dk and dv each within ``grad_err_ratio``'s bound); two controls must
    break it: the last 64-row query tile cut from the backward (its dO
    zeroed) in each of dq, dk and dv, and a window one 64-key tile short in
    dq.  Timed beside its plain version and SDPA's backward through
    autograd (the library yardstick, never called by the port), and held
    to at most ``FLASH_BWD_MAX_SDPA_RATIO`` times the latter; its
    libraries' wgmma (SASS ``HGMMA``) count must not be 0."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.flashattn import ops as flash_ops
    from repro_torch.kernels.flashattn import ref as flash_ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, k, v, do = [torch.randn((B, S, n, hd), generator=g, device=dev)
                   .to(torch.bfloat16) for n in (H, KV, KV, H)]
    o, lse = flash_ops.flash_attention(q, k, v, return_lse=True)
    got = flash_ops.flash_attention_bwd(q, k, v, o, do, lse=lse)
    want = flash_ref.attention_bwd_ref(*(x.float() for x in (q, k, v, o, do)))
    ratios = [flash_ref.grad_err_ratio(a, w) for a, w in zip(got, want)]
    err = max(float((a.float() - w).abs().max()) for a, w in zip(got, want))
    cut = do.clone()
    cut[:, -64:] = 0
    tile_cut = [flash_ref.grad_err_ratio(a, w) for a, w in zip(
        flash_ops.flash_attention_bwd(q, k, v, o, cut, lse=lse), want)]
    short = flash_ref.grad_err_ratio(flash_ops.flash_attention_bwd(
        q, k, v, o, do, window=S - 64, lse=lse)[0], want[0])
    del want, got, cut
    names = ("dq", "dk", "dv")
    print(f"[train] flash_attention_bwd [{B},{S},{H}/{KV},{hd}] bf16 causal "
          f"against the plain backward in f32: max error {err:.3g}; "
          + ", ".join(f"{n} {r:.3f}" for n, r in zip(names, ratios))
          + " of the bound; controls, the last query tile cut: "
          + ", ".join(f"{n} {r:.1f}" for n, r in zip(names, tile_cut))
          + f"; a window one key tile short: dq {short:.1f}")
    check(max(ratios) <= 1.0, f"flash_attention_bwd is {ratios} of the bf16 "
          "gradient bound")
    check(min(tile_cut) > 1.0 and short > 1.0, f"the gradient bound does not "
          f"see a cut tile: {tile_cut}, {short}")
    ms = device_ms(torch, lambda: flash_ops.flash_attention_bwd(
        q, k, v, o, do, lse=lse), reps=5)
    plain_ms = device_ms(torch, lambda: flash_ref.attention_bwd_ref(
        q, k, v, o, do), reps=2)
    leaves = [x.detach().transpose(1, 2).requires_grad_(True)
              for x in (q, k, v)]
    dot = do.transpose(1, 2)
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                      SDPBackend.EFFICIENT_ATTENTION]):
        lib = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                             enable_gqa=True)
        library_ms = event_ms(torch, lambda: torch.autograd.grad(
            lib, leaves, dot, retain_graph=True))
    del lib, leaves
    pairs = S * (S + 1) // 2
    flops = 10 * hd * pairs * H * B        # 2.5x the forward's products
    # q k v o dO and the f32 lse read; dq dk dv written
    nbytes = 2 * B * S * (4 * H * hd + 4 * KV * hd) + 4 * B * H * S
    bound_ms, bound_by = bound(nbytes, flops, BF16_TC_FLOP_PER_S)
    row = dict(name="flash_attention_bwd", route="cuda",
               source="src/repro_torch/kernels/csrc/flash_attn_bwd_sm90.cu",
               replaces="src/repro/models/common.py:74",
               note="no Pallas backward: the JAX package trains through "
                    "jax.grad of its jnp blockwise attention",
               path=path, shape=f"q[{B},{S},{H},{hd}] kv[{B},{S},{KV},{hd}] "
               "bf16 causal", max_abs_err=err, ms=ms, plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
    print(f"[kernel] flash_attention_bwd {row['shape']} ({path}): err "
          f"{err:.3g} ms {ms:.4f} plain_ms {plain_ms:.4f} bound_ms "
          f"{bound_ms:.4f} ({bound_by}) library_ms (sdpa backward) "
          f"{library_ms:.4f}; {flops / ms / 1e9:.1f} TFLOP/s, "
          f"{bound_ms / ms:.4f} of the bound, {ms / library_ms:.2f}x SDPA's "
          f"backward ({card})")
    check(ms <= FLASH_BWD_MAX_SDPA_RATIO * library_ms, f"flash_attention_bwd "
          f"takes {ms} ms, over {FLASH_BWD_MAX_SDPA_RATIO}x SDPA's backward's "
          f"{library_ms} ms")
    hgmma = sass_count("flash_attn_bwd_sm90")
    print(f"[kernel] flash_attention_bwd bf16 hd={hd} instance: "
          f"{json.dumps(flash_ops.sm90_bwd_resources(hd))}; {hgmma} HGMMA "
          f"instructions in its library; ptxas: "
          + ptxas_report(hd, "flash_attn_bwd_sm90", BWD_KERNELS))
    check(hgmma != "0", "the backward's library holds no wgmma (HGMMA)")
    del q, k, v, o, do, lse
    torch.cuda.empty_cache()
    return {("flash_attention_bwd", path): row}


def _rel_errors(got: list, want: list) -> list:
    """‖a − b‖ / ‖b‖ in f32 of each pair of gradient leaves."""
    return [float((a.float() - b.float()).norm() / b.float().norm())
            for a, b in zip(got, want)]


def train_phase(torch, card: str, counts: dict,
                out: Path) -> tuple[dict, dict]:
    """smollm-135m trained on the card at published widths in bf16 (see the
    module docstring): the flash rows at the step's shape, the model's
    gradients against the plain attention's, TRAIN_STEPS steps of
    ``make_train_step`` with a checkpoint, a bitwise resume whose last step
    is profiled.  Under ``torch.use_deterministic_algorithms`` from the
    gradients on."""
    import shutil

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_arch
    from repro_torch.data import lm_batch, make_markov_lm
    from repro_torch.models import transformer as tf
    from repro_torch.optim import OptConfig
    from repro_torch.optim.adamw import tree_leaves, tree_unflatten
    from repro_torch.train import TrainState, make_train_step

    marks = {}
    t_mark = time.perf_counter()

    def mark(name):
        nonlocal t_mark
        now = time.perf_counter()
        marks[name] = now - t_mark
        t_mark = now

    spec = get_arch(TRAIN_ARCH)
    cfg, shape = spec.model_cfg, spec.shapes["train_4k"]
    S, micro = shape.dims["seq"], TRAIN_BATCH // TRAIN_ACCUM
    print(f"[train] {cfg.name} × train_4k: seq {S}, batch "
          f"{shape.dims['batch']} cut to {TRAIN_BATCH}, accumulation "
          f"{shape.accum_steps} cut to {TRAIN_ACCUM} (microbatches of {micro})")
    rows = flash_rows(torch, card, cfg, S, path="train", tag="train",
                      batch=micro, extras=False)
    mark("flash_row")
    rows.update(flash_bwd_row(torch, card, cfg, S, micro, "train"))
    mark("flash_bwd_row")
    dev = torch.device("cuda")
    params = tf.init(cfg, torch.Generator(device=dev).manual_seed(0),
                     device=dev)
    lm = make_markov_lm(cfg.vocab, seed=0)
    batches = []
    for s in range(TRAIN_STEPS):
        toks, tgts = lm_batch(lm, TRAIN_BATCH, S, s, seed=0)
        batches.append({k: torch.from_numpy(x).reshape(
            TRAIN_ACCUM, micro, S).to(dev) for k, x in (("tokens", toks),
                                                        ("targets", tgts))})
    mark("init_and_data")

    def loss_and_grads(c, backend):
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        loss, _ = tf.loss_fn(c, tree_unflatten(params, leaves),
                             batches[0]["tokens"][0],
                             batches[0]["targets"][0], backend=backend)
        return float(loss.detach()), torch.autograd.grad(loss, leaves)

    opt = OptConfig(**TRAIN_OPT)
    step_fn = make_train_step(
        lambda p, b: tf.loss_fn(cfg, p, b["tokens"], b["targets"]), opt,
        accum_steps=TRAIN_ACCUM)
    ckpt_dir = ROOT / "build" / "train" / "ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    mgr = CheckpointManager(str(ckpt_dir), every=TRAIN_RESUME_AT, keep=1)
    torch.use_deterministic_algorithms(True)
    try:
        # the whole model's gradients on one microbatch: the kernels'
        # attention (forward and backward kernels) against the plain
        # blockwise attention
        k_loss, k_grads = loss_and_grads(cfg, "auto")
        p_loss, p_grads = loss_and_grads(cfg, "jnp")
        rel = _rel_errors(k_grads, p_grads)
        del k_grads
        controls = {w: max(_rel_errors(loss_and_grads(
            dataclasses.replace(cfg, window=w, window_period=2), "auto")[1],
            p_grads)) for w in TRAIN_CONTROL_WINDOWS}
        del p_grads
        mark("gradients")

        state = TrainState.create(params, opt)
        losses, step_s = [], []
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        torch.cuda.synchronize()
        for s in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            state, m = step_fn(state, batches[s])
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
            mgr.maybe_save(s + 1, state)   # host copies now, written beside
        counts["train"] = kernel_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        mgr.wait()
        mark("steps")
        step0, resumed = mgr.restore(TrainState.create(params, opt),
                                     device=dev)
        mark("restore")
        check(step0 == TRAIN_RESUME_AT and int(resumed.step) == step0
              and int(resumed.opt_state["step"]) == step0,
              f"restored step {step0}, state step {int(resumed.step)}")
        resumed_losses = []
        for s in range(TRAIN_RESUME_AT, TRAIN_STEPS):
            def one(s=s):
                nonlocal resumed
                resumed, m = step_fn(resumed, batches[s])
                resumed_losses.append(float(m["loss"]))

            if s < TRAIN_STEPS - 1:
                one()
            else:                          # the last step, profiled
                prof = _profiled(torch, one, "train_step", out, cpu=False)
        same = all(torch.equal(a, b) for a, b in zip(
            tree_leaves([state.params, state.opt_state, state.step]),
            tree_leaves([resumed.params, resumed.opt_state, resumed.step])))
        del resumed
        mark("resume_and_profile")
    finally:
        torch.use_deterministic_algorithms(False)

    grad_err = max(rel)
    print(f"[train] loss_fn on one microbatch [{micro},{S}], the kernels "
          f"against plain attention: loss {k_loss:.6f} vs {p_loss:.6f}; the "
          f"largest per-leaf relative gradient error {grad_err:.4g} (median "
          f"{float(np.median(rel)):.4g}, bound {TRAIN_GRAD_TOL}); controls, "
          f"every layer windowed: " + ", ".join(
              f"window {w}: {e:.4g}" for w, e in controls.items()))
    check(abs(k_loss - p_loss) <= 1e-2 * abs(p_loss) and np.isfinite(k_loss),
          f"loss with the kernels {k_loss}, plain {p_loss}")
    check(grad_err <= TRAIN_GRAD_TOL, f"gradients with the kernels and with "
          f"plain attention differ by {grad_err} > {TRAIN_GRAD_TOL}")
    check(min(controls.values()) > TRAIN_GRAD_TOL, f"the gradient bound "
          f"{TRAIN_GRAD_TOL} does not see attention cut to a window: "
          f"{controls}")
    check(resumed_losses == losses[TRAIN_RESUME_AT:] and same,
          f"the resumed run differs: losses {resumed_losses} against "
          f"{losses[TRAIN_RESUME_AT:]}, state bitwise {same}")
    row, avgs = prof
    kernel_us = {e.key: _device_us(torch, e) for e in avgs}
    total_us = sum(kernel_us.values())

    def share(match) -> float:
        return sum(us for k, us in kernel_us.items() if match(k)) / total_us

    row.update(flash_fwd_share=share(lambda k: "flash_fwd_sm90" in k),
               flash_bwd_share=share(lambda k: any(t in k
                                                   for t in BWD_KERNELS)),
               gemm_share=share(lambda k: any(t in k.lower()
                                              for t in GEMM_TAGS)),
               card=card)
    print(f"[profile] {json.dumps(row)}")

    n_launch = counts["train"]
    per_step = TRAIN_ACCUM * cfg.n_layers
    check(n_launch["flash_attention_bwd"] == TRAIN_STEPS * per_step
          and n_launch["flash_attention"] == 2 * TRAIN_STEPS * per_step,
          f"{TRAIN_STEPS} steps launched flash_attention "
          f"{n_launch['flash_attention']} and flash_attention_bwd "
          f"{n_launch['flash_attention_bwd']} times, not {2 * per_step} and "
          f"{per_step} a step (a forward and its remat a layer, a backward)")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"the loss did not fall: {losses}")
    tokens = TRAIN_BATCH * S
    secs = float(np.mean(step_s[1:]))
    # model FLOPs: 6 N a token, and attention's products forward (4 hd a
    # causal pair a head) and backward (twice that)
    attn = 3 * 4 * cfg.hd * (S * (S + 1) // 2) * cfg.n_heads * cfg.n_layers
    flops = 6 * cfg.param_count() * tokens + attn * TRAIN_BATCH
    summary = dict(
        arch=cfg.name, params=cfg.param_count(), seq=S, batch=TRAIN_BATCH,
        accum=TRAIN_ACCUM, steps=TRAIN_STEPS, losses=losses,
        first_step_s=step_s[0], step_s=secs, tokens_per_s=tokens / secs,
        model_flops_per_step=flops, mfu=flops / secs / BF16_TC_FLOP_PER_S,
        peak_gb=peak_gb, loss_kernel=k_loss, loss_plain=p_loss,
        grad_rel_err=grad_err, grad_controls=controls,
        resume_at=TRAIN_RESUME_AT, resumed_bitwise=True,
        launches_per_step={k: n_launch[k] / TRAIN_STEPS
                           for k in ("flash_attention", "flash_attention_bwd")},
        seconds=marks, profile=row)
    print(f"[train] {TRAIN_STEPS} steps of {TRAIN_ACCUM} × [{micro},{S}]: "
          f"loss {losses[0]:.4f} → {losses[-1]:.4f}; {secs:.3f} s a step "
          f"(first {step_s[0]:.3f}), {tokens / secs:.1f} tokens/s, model "
          f"FLOPs {flops:.4g} a step, {summary['mfu']:.4f} of the bf16 peak; "
          f"peak memory {peak_gb:.2f} GB; resumed at step {TRAIN_RESUME_AT} "
          f"from its checkpoint: losses and state equal to the uninterrupted "
          f"run's, bitwise; seconds {json.dumps(marks)} ({card})")
    return rows, summary


def moe_phase(torch, card: str, counts: dict,
              out: Path) -> tuple[dict, dict]:
    """moonshot-v1-16b-a3b on the card at its published widths and 48
    layers, bf16, weights from a seeded generator: the flash row at hd =
    128, the kernel-vs-plain prefill at S = 4,096, the 32k prefill and its
    profile, decode against a prefill that drops nothing, and generate
    (see the module docstring)."""
    from repro_torch.configs import get_arch
    from repro_torch.data import lm_batch, make_markov_lm
    from repro_torch.kernels.flashattn import ops as flash_ops
    from repro_torch.models import transformer as tf
    from repro_torch.serve import generate

    torch.cuda.empty_cache()
    spec = get_arch(MOE_ARCH)
    cfg = dataclasses.replace(spec.model_cfg, n_layers=MOE_LAYERS)
    S = spec.shapes["prefill_32k"].dims["seq"]     # its batch cut to 1
    rows = flash_rows(torch, card, cfg, S, path="moe_prefill", tag="moe")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    params = tf.init(cfg, torch.Generator(device=dev).manual_seed(0),
                     device=dev)
    torch.cuda.synchronize()
    n_params = _n_params(params)
    print(f"[moe] {cfg.name} at {cfg.n_layers} of its "
          f"{spec.model_cfg.n_layers} layers: {n_params:,} parameters "
          f"({cfg.active_param_count():,} active a token), "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card, "
          f"init {time.perf_counter() - t0:.1f} s")
    check(n_params == cfg.param_count(), f"{n_params} parameters, "
          f"{cfg.param_count()} expected")
    lm = make_markov_lm(cfg.vocab, seed=0)

    toks = torch.from_numpy(lm_batch(lm, 1, LM_CHECK_SEQ, step=0)[0]).to(dev)
    kern, kern_aux = tf.prefill_aux(cfg, params, toks)
    plain, plain_aux = tf.prefill_aux(cfg, params, toks, backend="jnp")
    e2e_err = float((kern - plain).abs().max())
    # controls: every layer windowed (the head layer by its index 0, the
    # scanned ones by sub-layer 0 of a period of 1: C.6)
    controls = {w: float((tf.prefill(dataclasses.replace(
        cfg, window=w, window_period=2), params, toks) - plain).abs().max())
        for w in LM_CONTROL_WINDOWS}
    print(f"[moe] prefill S={LM_CHECK_SEQ}: last-position logits with the "
          f"kernel against plain attention, max diff {e2e_err:.4g} (bound "
          f"{MOE_LOGIT_TOL}; logits' max |x| {float(plain.abs().max()):.3f}"
          f"; dropped {float(kern_aux['frac_dropped']):.5f} and "
          f"{float(plain_aux['frac_dropped']):.5f}); controls, the kernel "
          f"with every layer windowed: " + ", ".join(
              f"window {w}: {d:.4g}" for w, d in controls.items()))
    check(e2e_err <= MOE_LOGIT_TOL, f"prefill with the kernel and with "
          f"plain attention differ by {e2e_err} > {MOE_LOGIT_TOL}")
    check(min(controls.values()) > MOE_LOGIT_TOL, f"the logit bound "
          f"{MOE_LOGIT_TOL} does not see attention cut to a window: "
          f"{controls}")
    del kern, plain

    toks = torch.from_numpy(lm_batch(lm, 1, S, step=1)[0]).to(dev)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    flash_ops.COPIES["flash_attention"] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, aux = tf.prefill_aux(cfg, params, toks)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    counts["moe_prefill"] = kernel_counts()
    check(counts["moe_prefill"]["flash_attention"] == cfg.n_layers,
          f"prefill launched flash_attention "
          f"{counts['moe_prefill']['flash_attention']} times, not "
          f"{cfg.n_layers}")
    check(flash_ops.COPIES["flash_attention"] == 0, f"prefill copied "
          f"{flash_ops.COPIES['flash_attention']} attention inputs for TMA")
    check(tuple(logits.shape) == (1, cfg.vocab)
          and bool(torch.isfinite(logits).all()),
          "prefill logits are not [1, V] and finite")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    dropped = float(aux["frac_dropped"])
    print(f"[moe] {cfg.name} prefill 1 × {S}: {prefill_s:.3f} s, "
          f"{S / prefill_s:.1f} tokens/s, flash_attention launches "
          f"{counts['moe_prefill']['flash_attention']}, input copies "
          f"{flash_ops.COPIES['flash_attention']}, peak memory "
          f"{peak_gb:.2f} GB, dropped share {dropped:.5f} (mean over "
          f"{cfg.n_moe_layers()} MoE layers) ({card})")
    profile_prefill(torch, lambda: tf.prefill(cfg, params, toks),
                    "moe_prefill", out, seq=S, card=card)
    del logits, toks

    # decode never drops (T = B); prefill at a capacity that drops nothing
    B = LM_GEN["batch"]
    no_drop = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    prompts = torch.from_numpy(
        lm_batch(lm, B, MOE_DECODE_PROMPT, step=2)[0]).to(dev)
    pre, pre_aux = tf.prefill_aux(no_drop, params, prompts)
    print(f"[moe] prefill of {B} × {MOE_DECODE_PROMPT} at capacity_factor "
          f"{no_drop.capacity_factor}: dropped share "
          f"{float(pre_aux['frac_dropped'])}")
    check(float(pre_aux["frac_dropped"]) == 0.0,
          "the decode check's prefill dropped entries")
    step_err, step_controls = decode_against_prefill(
        torch, cfg, params, prompts, pre, MOE_LOGIT_TOL, "moe")

    P = LM_GEN["prompt"]
    prompts = torch.from_numpy(lm_batch(lm, B, P, step=3)[0]).to(dev)
    pre = tf.prefill(no_drop, params, prompts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen = generate(cfg, params, prompts, max_new=LM_GEN["max_new"],
                   max_seq=LM_GEN["max_seq"])
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    check(tuple(gen.shape) == (B, P + LM_GEN["max_new"])
          and bool((gen[:, :P] == prompts).all())
          and 0 <= int(gen.min()) and int(gen.max()) < cfg.vocab,
          "generate returned a wrong shape, a changed prompt or a token "
          "outside the vocabulary")
    # the first token is decode_step's argmax, within the bound of the
    # drop-free prefill's logits: within twice the bound of its best
    first = pre.gather(1, gen[:, P:P + 1].long())[:, 0]
    check(bool((first >= pre.max(-1).values - 2 * MOE_LOGIT_TOL).all()),
          "greedy generate's first token is not among prefill's top "
          "logits")
    steps = P + LM_GEN["max_new"] - 1
    summary = dict(arch=cfg.name, params=n_params,
                   active_params=cfg.active_param_count(), prefill_seq=S,
                   prefill_s=prefill_s, prefill_tok_s=S / prefill_s,
                   prefill_peak_gb=peak_gb, prefill_dropped=dropped,
                   e2e_logit_diff=e2e_err, decode_vs_prefill_diff=step_err,
                   decode_prompt=MOE_DECODE_PROMPT, gen_batch=B,
                   gen_prompt=P, gen_new=LM_GEN["max_new"], gen_s=gen_s,
                   decode_tok_s=B * steps / gen_s,
                   new_tok_s=B * LM_GEN["max_new"] / gen_s,
                   e2e_controls=controls, decode_controls=step_controls)
    print(f"[moe] generate {B} × ({P} + {LM_GEN['max_new']}) greedy: "
          f"{gen_s:.2f} s, {B * steps / gen_s:.1f} decode tokens/s "
          f"({steps} decode steps of {B} rows) ({card})")
    del params
    torch.cuda.empty_cache()
    return rows, summary


def examples_phase(torch, card: str) -> dict:
    """The four port examples (``examples/torch_*.py``) on the card, each
    in this process through its ``main(argv)`` at its own sizes, in the
    order of ``EXAMPLE_RUNS``: the quickstart, vector serving (then 4
    shards on the one card), the 46M-parameter LM trained 40 steps with a
    checkpoint every 20 under ``build/examples/lm`` and resumed to 60,
    and MIND trained and retrieved through the δ-EMQG index.  Each must
    finish and print its result lines; its seconds and the numbers its
    ``main`` returns are printed on an ``[examples]`` line."""
    import importlib.util
    import math
    import shutil

    ckpt = ROOT / "build" / "examples" / "lm"
    shutil.rmtree(ckpt, ignore_errors=True)
    out = {}
    for name, argv in EXAMPLE_RUNS:
        argv = argv + (["--ckpt-dir", str(ckpt)] if name == "train_lm"
                       else [])
        spec = importlib.util.spec_from_file_location(
            f"torch_{name}", ROOT / "examples" / f"torch_{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        t0 = time.perf_counter()
        res = mod.main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        key = name if name not in out else f"{name}_resumed"
        out[key] = dict(s=secs, argv=argv, **res)
        print(f"[examples] {key} {' '.join(argv)}: {secs:.1f} s; "
              f"{json.dumps(res)} ({card})")
        torch.cuda.empty_cache()
    first, resumed = out["train_lm"], out["train_lm_resumed"]
    check(first["start"] == 0 and resumed["start"] == 40,
          f"train_lm resumed at step {resumed['start']}, not 40")
    losses = first["losses"] + resumed["losses"]
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"train_lm's losses are not finite and falling: {losses}")
    for key in ("quickstart", "vector_serve", "recsys_retrieval"):
        check(all(math.isfinite(v) for v in out[key].values()
                  if isinstance(v, float)),
              f"the {key} example's numbers are not finite: {out[key]}")
    return out


def _device_us(torch, event) -> float:
    """Device time of a kernel or copy row; 0 for a host row (whose
    ``self_device_time_total`` repeats its kernels' time)."""
    if event.device_type != torch.autograd.DeviceType.CUDA:
        return 0.0
    return float(event.self_device_time_total)


def _profiled(torch, fn, phase: str, out: Path,
              cpu: bool = True) -> tuple[dict, list]:
    """``fn()`` under torch.profiler: (wall and device ms, the device's busy
    share, kernel launches, the seconds the profiler took besides ``fn``;
    the profiler's rows), with the operator tables written to ``out``.  ``cpu=False`` records the device activity alone
    (with the runtime's launch calls), which the profiler processes in a
    fraction of the time where the host runs many operators."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if cpu:
        acts.insert(0, torch.profiler.ProfilerActivity.CPU)
    torch.cuda.synchronize()
    t_enter = time.perf_counter()
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
    if not launches:       # no runtime rows recorded: the kernels that ran
        launches = sum(e.count for e in avgs if _device_us(torch, e) > 0
                       and not e.key.startswith(("Memcpy", "Memset")))
    out.mkdir(parents=True, exist_ok=True)
    (out / f"profile_{phase}.txt").write_text(
        avgs.table(sort_by="self_cpu_time_total", row_limit=40) + "\n"
        + avgs.table(sort_by="self_device_time_total", row_limit=25))
    check(device_us > 0, f"the profile of {phase} shows no device time")
    return dict(phase=phase, wall_ms=wall_s * 1e3, device_ms=device_us / 1e3,
                device_busy=device_us / 1e6 / wall_s,
                kernel_launches=launches,
                profiler_s=time.perf_counter() - t_enter - wall_s), avgs


def profile_phase(torch, idx, vq, out: Path, card: str) -> None:
    """Where a hop's time goes: ``torch.profiler`` over one served batch of
    128 queries with ``max_hops = PROFILE_HOPS`` (the profiler's own
    processing of a whole batch's ~300k launches took minutes), and over
    one block's candidate search of the build (the build's own search
    parameters), on the served index, each with device activity alone
    (``cpu=False``: the runtime's launch calls are kept, the host's
    operators are not; with them the profiler's own processing took most
    of the phase and stood in the wall time).  The device's busy share is
    its kernel and copy time over the wall time (one stream, so the
    intervals do not overlap); what the profiler still costs is in that
    wall time."""
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
        row, _ = _profiled(torch, fn, phase, out, cpu=False)
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
    # the live ops work in blocks of LIVE_INSERT rows (the live row's shape)
    live0 = as_live(idx.graph, BuildParams(**{**BUILD_PARAMS,
                                              "block": LIVE_INSERT}))
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


def heal_cell(torch, card: str, counted, store_dir: Path) -> dict:
    """``ShardedResilientAnnServer`` with ``auto_repair`` on the reference's
    audit-clean cell (its chaos test: 512 × 8 Gaussian rows, 4 shards × 2
    replicas, M = 12, L = 24, t = 10, 3 iterations, δ = 0.5, seed 7,
    quantized): the hole repaired first, an injected rebuild fault backed
    off and retried, coverage back to 1.0 with no revive_shard call, each
    repaired slot bitwise the original, the ids after repair the healthy
    ones.  ``counted`` wraps the controller's sweep to count its
    launches; the vector store goes to ``store_dir``."""
    import shutil

    from repro_torch.core import BuildParams, SearchParams
    from repro_torch.core.distributed import build_replicated
    from repro_torch.core.repair import RepairConfig, ShardVectorStore
    from repro_torch.obs import MetricsRegistry, snapshot
    from repro_torch.serve import ShardedResilientAnnServer
    from repro_torch.testing import RepairFaultPlan, indexes_equal

    S, R = 4, 2
    X = np.random.default_rng(0).standard_normal((512, 8)).astype(np.float32)
    Q = np.random.default_rng(1).standard_normal((64, 8)).astype(np.float32)
    bp = BuildParams(max_degree=12, beam_width=24, t=10, iters=3, block=128,
                     delta=0.5, align_degree=True)
    sidx = build_replicated(X, S, R, bp, quantized=True, seed=7,
                            device="cuda")
    shutil.rmtree(store_dir, ignore_errors=True)
    store = ShardVectorStore.create(str(store_dir), X, S, bp, quantized=True,
                                    seed=7)
    skew = {"s": 0.0}
    reg = MetricsRegistry()
    srv = ShardedResilientAnnServer(
        sidx, SearchParams(k=5, l0=16, l_max=32, adaptive=False,
                           max_hops=256),
        quantized=True, n_replicas=R, max_batch=64, buckets=(64,),
        clock=lambda: time.monotonic() + skew["s"], metrics=reg,
        auto_repair=RepairConfig(budget_per_sweep=S * R, backoff_s=1.0),
        vector_store=store, repair_fault_hook=RepairFaultPlan(
            fail_rebuilds=1).hook(), device="cuda")
    srv.repair.sweep = counted(srv.repair.sweep)

    def serve():
        srv.submit_many(Q)
        rs = srv.drain()
        check(all(r.ok for r in rs), "a response of the heal cell failed")
        return np.stack([r.ids for r in rs]), [r.coverage for r in rs]

    healthy, _ = serve()
    for s_, r_ in ((1, 0), (2, 0), (2, 1)):
        srv.kill_shard(s_, r_)
    hole = srv.coverage
    ids, cov = serve()            # (2,0) faulted; (2,1) and (1,0) healed
    check(hole == 0.75 and set(cov) == {1.0} and srv.repair.n_failed == 1
          and not srv.registry._live[2, 0]
          and not srv.registry.participation()[2 * R],
          f"heal: coverage {hole} → {set(cov)}, failed "
          f"{srv.repair.n_failed}; the faulted slot joined the mask")
    skew["s"] += 2.0              # past the faulted slot's 1 s backoff
    ids, cov = serve()
    done = [e for e in snapshot(reg)["events"]
            if e["name"] == "repair_succeeded"]
    check(srv.repair.n_repaired == 3 and done[0]["shard"] == 2
          and srv.coverage == 1.0 and np.array_equal(ids, healthy),
          f"heal: {srv.repair.n_repaired} repaired, first "
          f"{done[0] if done else None}, ids equal "
          f"{np.array_equal(ids, healthy)}")
    for slot in (1 * R, 2 * R, 2 * R + 1):
        check(srv.index.slots[slot] is not sidx.slots[slot]
              and indexes_equal(srv.index.slots[slot], sidx.slots[slot]),
              f"heal: repaired slot {slot} is not the original, bitwise")
    secs = [e["duration_s"] for e in done]
    print(f"[sharded] heal cell, a correctness check at a toy size (512 × 8, "
          f"4 shards × 2), not a real repair time: the hole repaired first, "
          f"coverage 0.75 → 1.0 with no revive_shard call, 1 injected "
          f"rebuild fault backed off and retried, 3 slots rebuilt, audited, "
          f"spot-checked and installed bitwise equal to the original "
          f"({', '.join(f'{x:.2f}' for x in secs)} s), ids after repair "
          f"the healthy ones ({card})")
    return dict(heal_check_repair_s=secs)


def sharded_phase(torch, card: str, counts: dict) -> dict:
    """The sharded δ-EMQG (``core.distributed``), self-repair
    (``core.repair``) and ``ShardedResilientAnnServer`` on the card:
    SHARDED_S shards × SHARDED_R replicas, the serve cell's parameters,
    the queries in the CLI's three stages of SHARDED_STAGE."""
    import shutil

    from repro_torch.core import BuildParams, SearchParams
    from repro_torch.core.distances import brute_force_knn
    from repro_torch.core.distributed import (ShardedIndex, _stacked,
                                              build_replicated,
                                              host_reference_merge,
                                              make_sharded_search,
                                              spmd_search)
    from repro_torch.core.repair import RepairConfig, ShardVectorStore
    from repro_torch.data import clustered_vectors
    from repro_torch.obs import MetricsRegistry, snapshot
    from repro_torch.serve import ResilienceConfig, ShardedResilientAnnServer
    from repro_torch.testing import (FaultPlan, RepairFaultPlan,
                                     indexes_equal, inject_search_faults)

    S, R, n, k = SHARDED_S, SHARDED_R, SHARDED_N, SERVE_PARAMS["k"]
    per = -(-n // S)
    bp = BuildParams(**BUILD_PARAMS)
    params = SearchParams(**SERVE_PARAMS)
    base = clustered_vectors(n, 128, 48, seed=0)
    queries = clustered_vectors(3 * SHARDED_STAGE, 128, 48, seed=15)
    stages = np.split(queries, 3)
    _, gt = brute_force_knn(torch.as_tensor(queries, device="cuda"),
                            torch.as_tensor(base, device="cuda"), k)
    gt = gt.cpu()
    out = dict(n=n, shards=S, replicas=R)

    reset_counts()
    t0 = time.perf_counter()
    sidx = build_replicated(base, S, R, bp, quantized=True, seed=0,
                            device="cuda")
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    counts["sharded_build"] = kernel_counts()
    for kernel in ("gather_l2_tiled", "batched_l2"):
        check(counts["sharded_build"][kernel] > 0,
              f"the sharded build never launched {kernel}")
    store_dir = ROOT / "build" / "sharded" / "store"
    shutil.rmtree(store_dir, ignore_errors=True)
    t0 = time.perf_counter()
    ShardVectorStore.create(str(store_dir), base, S, bp, quantized=True,
                            seed=0)
    out["store_s"] = time.perf_counter() - t0
    print(f"[sharded] built {S} shards × {R} replicas of {per} rows in "
          f"{out['build_s']:.1f} s, vector store in {out['store_s']:.1f} s; "
          f"launches {json.dumps(counts['sharded_build'])} ({card})")

    # the SPMD transport: one process a slot on the card, gloo between; the
    # primaries of the first SPMD_RANKS shards as an index of their own.
    # Its processes start now, in a thread that waits on them, and run
    # beside the rest of the phase (their start was most of the check's
    # time); their results are compared at the end of the phase
    small = ShardedIndex(slots=sidx.slots[:SPMD_RANKS * R:R],
                         offsets=sidx.offsets[:SPMD_RANKS * R:R],
                         n_total=SPMD_RANKS * per,
                         sizes=sidx.sizes[:SPMD_RANKS * R:R])
    spmd = {}

    def run_spmd():
        t0 = time.perf_counter()
        try:
            spmd["ranks"] = spmd_search(small, stages[0], params,
                                        quantized=True, dist_backend="gloo",
                                        timeout_s=600)
        except Exception as e:              # re-raised in the main thread
            spmd["error"] = e
        spmd["s"] = time.perf_counter() - t0

    spmd_thread = threading.Thread(target=run_spmd, daemon=True)
    spmd_thread.start()

    def drive(srv, q):
        t0 = time.perf_counter()
        srv.submit_many(q)
        rs = srv.drain()
        torch.cuda.synchronize()
        check(all(r.ok for r in rs), f"a sharded response failed: "
              f"{[r.error for r in rs if not r.ok][:1]}")
        return rs, len(q) / (time.perf_counter() - t0)

    def ids_of(rs):
        return torch.as_tensor(np.stack([r.ids for r in rs])).long()

    def dists_of(rs):
        return torch.as_tensor(np.stack([r.dists for r in rs]))

    # The CLI's three stages of 128 through one server with auto_repair,
    # the failover check between the first two.  Every rebuild at this
    # size is the original slot to the bit and is rejected by the
    # reference's gate (verify.audit): each shard build leaves nodes cut
    # off from its medoid (ROADMAP C.5, C.8), so nothing is installed and
    # the mask never flips.  The two injected faults (shard 1's primary,
    # then shard 2's) are contained: no build runs.  So one rebuild of
    # shard 2 runs, its replica's; the backoff keeps each slot to one
    # attempt
    from repro_torch.core.build_approx import _bfs_reachable

    repair_counts: dict = {}
    attempts: list = []

    def counted(sweep):
        def run(now=None):
            before = kernel_counts()
            done = sweep(now)
            for name, v in kernel_counts().items():
                repair_counts[name] = repair_counts.get(name, 0) + v - \
                    before[name]
            attempts.extend(done)
            return done
        return run

    # a queue of 128 stays at rung 0 (the ladder's default depth is 64)
    rung0 = dict(degrade_depth=4096)
    kw = dict(quantized=True, n_replicas=R, max_batch=128, buckets=(32, 128),
              device="cuda")
    reg = MetricsRegistry()
    srv = ShardedResilientAnnServer(
        sidx, params, config=ResilienceConfig(**rung0), metrics=reg,
        auto_repair=RepairConfig(budget_per_sweep=S * R, backoff_s=3600.0,
                                 backoff_cap_s=3600.0),
        vector_store=str(store_dir),
        repair_fault_hook=RepairFaultPlan(fail_rebuilds=2).hook(), **kw)
    srv.repair.sweep = counted(srv.repair.sweep)
    tiers = [t.name for t in srv.breaker.tiers]
    check(tiers == ["sharded/all_gather", "sharded/ring"],
          f"the sharded breaker's tiers are {tiers}")
    reset_counts()
    rs1, qps1 = drive(srv, stages[0])
    counts["sharded"] = kernel_counts()
    healthy, healthy_d = ids_of(rs1), dists_of(rs1)
    check(all(r.coverage == 1.0 and r.max_missed == 0 and r.rung == 0
              and r.tier == "sharded/all_gather" for r in rs1),
          "a healthy response was degraded or off the all_gather tier")
    traj = [srv.coverage]
    # replica failover: shard 1's primary dies, its replica answers; the
    # sweep's one attempt at it meets the first injected fault
    srv.kill_shard(1, 0)
    rs, _ = drive(srv, stages[0])
    check(all(r.coverage == 1.0 and r.max_missed == 0 for r in rs)
          and srv.registry.n_failover == 1
          and torch.equal(ids_of(rs), healthy),
          "failover to shard 1's replica changed coverage or ids")
    check(srv.repair.n_failed == 1 and srv.repair.last_rebuild is None
          and not srv.registry.participation()[1 * R],
          "the faulted repair built or joined the mask")
    traj.append(srv.coverage)
    # a coverage hole: both replicas of shard 2; the sweep tries the hole
    # first: the primary meets the second injected fault, the replica is
    # rebuilt and refused by the gate
    srv.kill_shard(2, 0)
    srv.kill_shard(2, 1)
    traj.append(srv.coverage)
    rs2, qps2 = drive(srv, stages[1])
    traj.append(srv.coverage)
    rs3, qps3 = drive(srv, stages[2])
    traj.append(srv.coverage)
    for kernel in ("gather_l2_tiled", "fused_estimate"):
        check(counts["sharded"][kernel] > 0,
              f"the sharded search never launched {kernel}")
    check(int(healthy.max()) < n and all(
        len(set(v)) == len(v) for v in
        ([x for x in row if x >= 0] for row in healthy.tolist())),
          "a served id is out of range or twice in a row")
    live = srv.registry.participation()
    healthy_mask = np.zeros_like(live)
    healthy_mask[::R] = True
    # the memory a search takes over what is held: the lock-step loop of
    # the S live slots (their bitsets a slot wide) against the slots one
    # at a time; the stack it searches is a copy of the S·R slots, made on
    # the index's first search and kept
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ring_i, ring_d = make_sharded_search("ring", quantized=True)(
        sidx, stages[0], params, valid=healthy_mask)
    lock_mb = (torch.cuda.max_memory_allocated() - held) / 2**20
    torch.cuda.reset_peak_memory_stats()
    ref_i, ref_d = host_reference_merge(
        sidx, type(srv.registry)(S, R), stages[0], params, quantized=True)
    seq_mb = (torch.cuda.max_memory_allocated() - held) / 2**20
    graph, codes, _ = _stacked(sidx)
    stack_mb = sum(t.numel() * t.element_size() for t in (
        graph.vectors, graph.neighbors, codes.codes, codes.norms,
        codes.ip_xo)) / 2**20
    out.update(search_mib=dict(lockstep=lock_mb, one_at_a_time=seq_mb,
                               stack=stack_mb))
    print(f"[sharded] a batch of {SHARDED_STAGE} over the {S} live slots "
          f"takes {lock_mb:.1f} MiB over what is held in one lock-step "
          f"search, {seq_mb:.1f} MiB searched one slot at a time "
          f"(host_reference_merge); the stack it searches, a copy of the "
          f"{S * R} slots kept on the index, {stack_mb:.1f} MiB ({card})")
    for name, ids, d in (("all_gather", healthy, healthy_d),
                         ("ring", ring_i.cpu(), ring_d.cpu())):
        check(torch.equal(ids.long(), torch.as_tensor(ref_i).long())
              and torch.allclose(d, torch.as_tensor(ref_d), rtol=1e-4),
              f"the {name} merge differs from host_reference_merge")
    plain_i, _ = make_sharded_search("all_gather", quantized=True,
                                     backend="jnp")(sidx, stages[0], params,
                                                    valid=healthy_mask)
    share = agree(healthy, plain_i.cpu())
    check(share >= MIN_AGREE,
          f"sharded ids match the plain path on {share:.4f} of queries")
    hole = ids_of(rs2)
    ref_i, _ = host_reference_merge(sidx, srv.registry, stages[1], params,
                                    quantized=True)
    check(all(r.coverage == 0.75 and r.max_missed == k for r in rs2 + rs3),
          f"the hole reads coverage {rs2[0].coverage}, max_missed "
          f"{rs2[0].max_missed}")
    check(not bool(((hole >= 2 * per) & (hole < 3 * per)).any()),
          "an id of dead shard 2 was served")
    check(torch.equal(hole, torch.as_tensor(ref_i).long()),
          "the hole's ids differ from host_reference_merge over the live "
          "slots")
    check(srv.stats.n_fallback == 0 and srv.stats.n_retried == 0,
          "a shard death moved the breaker")
    events = [e for e in snapshot(reg)["events"]
              if e["name"] == "repair_failed"]
    errors = {(e["shard"], e["replica"]): e["error"] for e in events}
    cut = int((~_bfs_reachable(sidx.slots[2 * R].graph.neighbors,
                               sidx.slots[2 * R].graph.medoid)).sum())
    shard, replica, local = srv.repair.last_rebuild
    check(len(events) == 3 and [(o.shard, o.replica) for o in attempts]
          == [(1, 0), (2, 0), (2, 1)]
          and "RepairFault" in errors[(1, 0)]
          and "RepairFault" in errors[(2, 0)]
          and f"{cut} live nodes unreachable" in errors[(2, 1)] and cut > 0
          and (shard, replica) == (2, 1),
          f"repair attempts {errors}, last rebuild {(shard, replica)}, "
          f"{cut} nodes cut off")
    check(indexes_equal(local, sidx.slots[2 * R + 1]),
          "shard 2's rebuild is not the original slot, bitwise")
    check(srv.index is sidx and srv.repair.n_repaired == 0
          and traj == [1.0, 1.0, 0.75, 0.75, 0.75],
          f"a rejected rebuild changed serving: coverage {traj}")
    # each attempt's seconds on the clock of its sweep: an injected fault
    # stops after the shard's load, before its build; the rebuild is a
    # real repair's load, build and audit at this cell's shard size
    out.update(qps_stages=[qps1, qps2, qps3], coverage=traj,
               recall_healthy=recall_at(healthy, gt[:SHARDED_STAGE]),
               recall=recall_at(ids_of(rs1 + rs2 + rs3), gt), cut_off=cut,
               repair_attempt_s={f"{o.shard}.{o.replica}": o.duration_s
                                 for o in attempts})
    rebuild_s = attempts[-1].duration_s
    print(f"[sharded] healthy: {len(rs1)} queries at QPS {qps1:.1f}, "
          f"recall@10 {out['recall_healthy']:.4f} (all three stages "
          f"{out['recall']:.4f}); both merges equal host_reference_merge "
          f"(ids, dists to rtol 1e-4); ids equal to the plain path on "
          f"{share:.4f}; launches {json.dumps(counts['sharded'])} ({card})")
    print(f"[sharded] failover: shard 1's primary killed, coverage 1.0, ids "
          f"equal to the healthy run's, its repair met the injected fault "
          f"(contained, no build); hole: shard 2's replicas killed, coverage "
          f"0.75, max_missed {k}, no id of its rows, ids equal to "
          f"host_reference_merge over the live slots, 0 breaker moves; "
          f"shard 2's primary met the second injected fault, its replica's "
          f"rebuild is bitwise the original slot and rejected by the audit "
          f"gate ({cut} nodes cut off, C.5/C.8): nothing installed; coverage "
          f"{traj}; stage QPS {qps1:.1f}, {qps2:.1f} (with the rebuild), "
          f"{qps3:.1f} ({card})")
    print(f"[sharded] repair attempts at this cell ({per} rows a shard), "
          f"each on its sweep's clock: "
          + ", ".join(f"shard {o.shard} replica {o.replica} {o.duration_s:.3f} "
                      f"s" for o in attempts)
          + f"; the rebuild (load, build, audit, refused) {rebuild_s:.2f} s: "
          f"what one real repair attempt costs here ({card})")

    # a merge fault: the ring tier opens, all_gather answers the batch
    srv = ShardedResilientAnnServer(
        sidx, params, merge="ring",
        config=ResilienceConfig(backoff_s=0.0, **rung0), **kw)
    with inject_search_faults(srv, FaultPlan(
            fail_first=10**6, match_backend="ring")) as inj:
        rs, _ = drive(srv, stages[0][:FAULT_QUERIES])
    check(all(r.tier == "sharded/all_gather" for r in rs)
          and srv.stats.n_fallback == 1
          and torch.equal(ids_of(rs), healthy[:FAULT_QUERIES]),
          f"a ring fault: tiers {[r.tier for r in rs][:1]}, fallbacks "
          f"{srv.stats.n_fallback}")
    print(f"[sharded] ring merge faulted {inj.n_failed} times: the tier "
          f"opened, all_gather answered {len(rs)} queries with the healthy "
          f"ids, 1 fallback ({card})")

    # self-repair end to end where the reference's gate passes: the
    # reference's chaos test's cell (4 × 128 rows, d = 8, δ = 0.5)
    out.update(heal_cell(torch, card, counted, store_dir.parent / "heal"))
    counts["shard_repair"] = repair_counts
    for kernel in ("gather_l2_tiled", "batched_l2", "fused_estimate"):
        check(repair_counts.get(kernel, 0) > 0,
              f"the repair never launched {kernel}")

    t0 = time.perf_counter()
    spmd_thread.join()
    if "error" in spmd:
        raise spmd["error"]
    ranks = spmd["ranks"]
    out["spmd_s"], out["spmd_wait_s"] = spmd["s"], time.perf_counter() - t0
    for merge in ("all_gather", "ring"):
        ids, d = make_sharded_search(merge, quantized=True)(small, stages[0],
                                                            params)
        check(all(np.array_equal(r[merge][0], ids.cpu().numpy())
                  and np.array_equal(r[merge][1], d.cpu().numpy())
                  for r in ranks),
              f"the SPMD {merge} differs from the single controller's")
    print(f"[sharded] SPMD: {SPMD_RANKS} ranks on the card (gloo over host "
          f"copies), shards 0-{SPMD_RANKS - 1} ({SPMD_RANKS * per} rows), "
          f"both merges equal the single controller's ids and dists on every "
          f"rank; {out['spmd_s']:.1f} s with the processes' start, beside "
          f"the rest of the phase, which then waited {out['spmd_wait_s']:.1f} "
          f"s for it ({card})")
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
    # cuBLAS's workspace as deterministic algorithms need it (the train
    # phase runs under torch.use_deterministic_algorithms), set before any
    # cuBLAS handle exists
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    sharded = timed("sharded", sharded_phase, torch, card, counts)
    torch.cuda.empty_cache()
    timed("exact_build", exact_build_phase, torch, card, counts)
    timed("baselines", baselines_phase, torch, card)
    timed("mips", mips_phase, torch, card, counts)
    sift1m = timed("sift1m", sift1m_phase, torch, card, counts)
    # the alignment's batch is the nodes short of M: its row times the
    # largest it can be, the block
    rows[("batched_l2", "sift1m_align")]["path_shape"] = sift1m["align_shape"]
    print(f"[sift1m-summary] {json.dumps(sift1m)} card={card}")
    torch.cuda.empty_cache()
    d960 = timed("d960", d960_phase, torch, card, counts)
    print(f"[d960-summary] {json.dumps(d960)} card={card}")
    torch.cuda.empty_cache()
    recsys = timed("recsys", recsys_phase, torch, card, counts,
                   ROOT / "build" / "profile")
    torch.cuda.empty_cache()
    recsys_train = timed("recsys_train", recsys_train_phase, torch, card)
    print(f"[recsys-train-summary] {json.dumps(recsys_train)} card={card}")
    torch.cuda.empty_cache()
    gnn = timed("gnn", gnn_phase, torch, card)
    print(f"[gnn-summary] {json.dumps(gnn)} card={card}")
    torch.cuda.empty_cache()
    lm_rows, lm = timed("lm", lm_phase, torch, card, counts,
                        ROOT / "build" / "profile")
    rows.update(lm_rows)
    torch.cuda.empty_cache()
    train_rows, train = timed("train", train_phase, torch, card, counts,
                              ROOT / "build" / "profile")
    rows.update(train_rows)
    torch.cuda.empty_cache()
    moe_rows, moe = timed("moe", moe_phase, torch, card, counts,
                          ROOT / "build" / "profile")
    rows.update(moe_rows)
    torch.cuda.empty_cache()
    examples = timed("examples", examples_phase, torch, card)
    print(f"[examples-summary] {json.dumps(examples)} card={card}")

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
    print(f"[moe-summary] {json.dumps(moe)} card={card}")
    print(f"[train-summary] {json.dumps(train)} card={card}")
    print(f"[live-summary] {json.dumps(live)} card={card}")
    print(f"[resilient-summary] {json.dumps(resilient)} card={card}")
    print(f"[sharded-summary] {json.dumps(sharded)} card={card}")
    print(f"[recsys-summary] {json.dumps(recsys)} card={card}")
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
