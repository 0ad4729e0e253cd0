"""Sharded ANN index — the scale-out serving path.

Counterpart of ``repro.core.distributed``.  Dataset rows are partitioned
into S contiguous shards; each shard holds an independent δ-EMG / δ-EMQG
over its rows (local id space + global offset), every shard runs the same
lock-step batched search over its rows, and the per-shard top-k lists are
merged exactly:

* ``merge="all_gather"``: every shard's (k ids, k dists) side by side, one
  stable top-k — one collective, O(S·k·B) bytes per rank.
* ``merge="ring"``: S−1 steps, each merging the running k-list with the
  next shard's — O((S−1)·k·B) bytes, neighbour links only.

Exactness: top-k over a union of disjoint sets == merge of per-set top-k,
so sharding never loses recall (per-shard search quality is the only
approximation, as on one node).

Where the JAX package stacks the shards into one pytree with a leading
dim S and runs them under ``shard_map``, the port keeps a **tuple of
per-slot indexes** (``ShardedIndex.slots``): replacing a slot
(``repair.install_slot``) is a new tuple with one entry swapped.  The
mesh becomes two forms of the search that give the same merged answer:

* **Single controller** (``make_sharded_search``): one process searches
  every participating slot on its device and merges on the device — what
  the server and the card's smoke use.  The slots share one shape, so
  their searches run as one lock-step loop over S·B rows, as the
  reference's stacked ``shard_map`` runs them: the slots' rows side by
  side as one index, each query once a slot, each row starting at its
  slot's medoid (``_lockstep_search``).  A row's hops read only its own
  slot's rows, so each slot's list is the one its own search gives, bit
  for bit; the host loop takes as many hops as the slowest slot, not
  their sum.  The stack is a copy of the slots, made on an index's first
  search and kept on it (``_stacked``); each row's visited bitset covers
  its own slot's rows only.  The ring merge takes the order the
  reference's caller sees, rank 0's copy: its own list, then S−1, …, 1,
  each step a stable top-k of ``[acc, next]`` (on ties the earlier entry
  wins).
* **SPMD over ``torch.distributed``** (``spmd_sharded_search``): one rank
  per slot, ``all_gather`` or S−1 ``isend``/``irecv`` steps around the
  ring.  The caller picks the process group's backend; on a gloo group the
  ``[B, k]`` lists travel as host copies while each rank searches on its
  own device (how two ranks share one card: NCCL refuses two ranks on one
  device).  ``spawn_spmd`` starts the ranks.

The reference's ``query_axis`` (queries sharded over the mesh axes the
shards do not use) has meaning only across several cards and is not
ported (ROADMAP).

Fault tolerance is the reference's: ``run`` takes a per-slot validity
mask.  A dead slot's candidates are (id=-1, dist=inf) *before* the merge
(the single controller does not search it at all), so both merges exclude
it.  ``ShardHealthRegistry`` tracks per-replica liveness and derives the
mask: with replica groups (``build_replicated``, slot layout ``s·R + r``)
exactly one live replica per logical shard participates — a lost primary
fails over to its replica before coverage degrades.  When every replica of
a shard is gone, ``FaultTolerantShardedSearch`` still answers, and each
response carries ``coverage = live_shards/S`` and ``max_missed = min(k,
Σ_dead min(k, |shard|))``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import math
import queue as queue_mod
import socket
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from . import rabitq
from .build_approx import BuildParams, build_approx
from .emqg import build_emqg
from ..obs.tracing import Tracer, maybe_span
from .probing import _beam_probing_batch, probing_search, traced_kw
from .search import (_beam_search_batch, _true_dists, as_queries,
                     make_batch_dist_fn, resolve_backend, search)
from .types import (EMQGIndex, GraphIndex, RaBitQCodes, SearchParams,
                    stable_topk_smallest)


def _graph(index) -> GraphIndex:
    return index.graph if isinstance(index, EMQGIndex) else index


@dataclasses.dataclass(frozen=True)
class ShardedIndex:
    """Per-slot indexes + global id offsets.

    ``slots`` is a tuple of per-slot ``GraphIndex`` / ``EMQGIndex`` (all on
    one device, equal-sized: the last shard is padded by repeating its first
    row).  ``offsets[s]`` is the global id of local row 0 of slot ``s``.
    ``sizes[s]`` is the number of *real* (non-pad) rows of slot ``s``: local
    ids ``>= sizes[s]`` are pad copies of local row 0, and the merge masks
    them out exactly like dead-slot candidates (``id=-1, dist=inf``), so a
    pad never leaks a global id ``>= n_total`` or duplicates its source
    row's id.  ``sizes=None`` treats every row as real.
    """

    slots: tuple
    offsets: tuple
    n_total: int = 0
    sizes: Optional[tuple] = None

    @property
    def n_shards(self) -> int:
        """Physical slots (S·R with replicas)."""
        return len(self.offsets)

    @property
    def dim(self) -> int:
        return int(_graph(self.slots[0]).vectors.shape[-1])

    @property
    def delta(self) -> float:
        return float(getattr(_graph(self.slots[0]), "delta", 0.0))

    @property
    def device(self) -> torch.device:
        return self.slots[0].device


def stack_indices(indices: Sequence, offsets: Sequence[int], n_total: int,
                  sizes: Optional[Sequence[int]] = None) -> ShardedIndex:
    """``ShardedIndex`` over ``indices`` (one per slot).  Without ``sizes``
    each slot's real rows are what remains of ``n_total`` past its offset,
    clipped to the slot capacity (the contiguous partition)."""
    offsets = tuple(int(o) for o in offsets)
    if sizes is None:
        per = int(_graph(indices[0]).vectors.shape[0])
        sizes = [min(max(n_total - o, 0), per) for o in offsets]
    return ShardedIndex(slots=tuple(indices), offsets=offsets,
                        n_total=int(n_total),
                        sizes=tuple(int(s) for s in sizes))


def shard_rows(vectors: np.ndarray, shard: int, per: int) -> tuple[np.ndarray, int]:
    """Rows of contiguous shard ``shard`` (capacity ``per``), padded to
    ``per`` by wrapping the shard's first row (or global row 0 when the shard
    is past the end of the data).  Returns ``(rows, n_real)``.

    The canonical shard input: ``build_sharded`` and the repair path's
    from-source rebuild both call it, so a repaired shard is built from
    bit-identical input."""
    vectors = np.asarray(vectors, np.float32)
    rows = vectors[shard * per : (shard + 1) * per]
    n_real = int(rows.shape[0])
    if n_real < per:  # pad by wrapping
        pad = np.tile(rows[:1] if rows.size else vectors[:1],
                      (per - n_real, 1))
        rows = np.concatenate([rows, pad]) if rows.size else pad
    return rows, n_real


def build_shard(rows: np.ndarray, shard: int,
                params: Optional[BuildParams] = None,
                quantized: bool = False, seed: int = 0, device="cuda",
                metrics=None, tracer=None):
    """Build one shard's index exactly as ``build_sharded`` does (per-shard
    seed ``seed + shard``, which also seeds the RaBitQ rotation) — shared
    with ``core.repair`` so that a rebuilt shard is bit-identical to the
    original.  ``metrics`` receives the build's events and ``tracer`` its
    spans (``build_emqg`` / ``build_approx``; observation only)."""
    p = dataclasses.replace(params or BuildParams(), seed=seed + shard)
    if quantized:
        return build_emqg(rows, p, metrics=metrics, device=device,
                          tracer=tracer)
    return build_approx(rows, p, metrics=metrics, device=device,
                        tracer=tracer)


def build_sharded(vectors, n_shards: int, params: Optional[BuildParams] = None,
                  quantized: bool = False, seed: int = 0,
                  device="cuda", metrics=None, tracer=None) -> ShardedIndex:
    """Contiguous row partition; per-shard Algorithm-4 builds on ``device``
    (equal-sized, last shard padded by wrapping).  ``metrics`` receives
    every shard's build events and ``tracer`` a ``build`` span a shard
    (observation only)."""
    vectors = np.asarray(vectors, np.float32)
    n = vectors.shape[0]
    per = int(np.ceil(n / n_shards))
    shards, offsets, sizes = [], [], []
    for s in range(n_shards):
        rows, n_real = shard_rows(vectors, s, per)
        shards.append(build_shard(rows, s, params, quantized, seed, device,
                                  metrics, tracer))
        offsets.append(s * per)
        sizes.append(n_real)
    return stack_indices(shards, offsets, n, sizes=sizes)


def _clone(index):
    """A copy of ``index`` that owns its tensors."""
    fields = {}
    for f in dataclasses.fields(index):
        v = getattr(index, f.name)
        if isinstance(v, torch.Tensor):
            v = v.clone()
        elif dataclasses.is_dataclass(v):
            v = _clone(v)
        fields[f.name] = v
    return dataclasses.replace(index, **fields)


def build_replicated(vectors, n_shards: int, n_replicas: int = 2,
                     params: Optional[BuildParams] = None,
                     quantized: bool = False, seed: int = 0,
                     device="cuda") -> ShardedIndex:
    """``build_sharded`` with each shard repeated R times — physical slot
    layout ``s·R + r`` (replicas of a shard are adjacent; each replica owns
    a copy of its shard's tensors)."""
    base = build_sharded(vectors, n_shards, params, quantized, seed, device)
    if n_replicas == 1:
        return base

    def rep(xs):
        return tuple(x for x in xs for _ in range(n_replicas))

    slots = tuple(s if r == 0 else _clone(s)
                  for s in base.slots for r in range(n_replicas))
    return ShardedIndex(slots=slots, offsets=rep(base.offsets),
                        n_total=base.n_total,
                        sizes=None if base.sizes is None else rep(base.sizes))


# ---------------------------------------------------------------------------
# Search and the exact merges.
# ---------------------------------------------------------------------------

def _local_search(index, queries, params: SearchParams, quantized: bool,
                  backend: str = "auto"):
    if quantized:
        return probing_search(index, queries, params, backend=backend)
    return search(index, queries, params, backend=backend)


def _stacked(sidx: ShardedIndex):
    """Every slot of ``sidx`` side by side as one index, for the lock-step
    search: ``(graph, codes, bases)``, the slots' vectors, neighbour lists
    (shifted by each slot's first row, ``bases[slot]``) and, for δ-EMQG
    slots, their codes.  Made on the first search of ``sidx`` and kept on
    it: a ``ShardedIndex`` does not change (``repair.install_slot`` makes
    a new one), so the copy is made once, not once a batch."""
    st = sidx.__dict__.get("_stack")
    if st is not None:
        return st
    graphs = [_graph(x) for x in sidx.slots]
    bases = np.cumsum([0] + [g.n for g in graphs[:-1]]).tolist()
    graph = dataclasses.replace(
        graphs[0], vectors=torch.cat([g.vectors for g in graphs]),
        neighbors=torch.cat([torch.where(g.neighbors >= 0, g.neighbors + b,
                                         g.neighbors)
                             for g, b in zip(graphs, bases)]), medoid=0)
    codes = None
    if isinstance(sidx.slots[0], EMQGIndex):
        c0 = sidx.slots[0].codes
        codes = RaBitQCodes(
            codes=torch.cat([x.codes.codes for x in sidx.slots]),
            norms=torch.cat([x.codes.norms for x in sidx.slots]),
            ip_xo=torch.cat([x.codes.ip_xo for x in sidx.slots]),
            rotation=c0.rotation, center=c0.center, dim=c0.dim)
    st = (graph, codes, bases)
    object.__setattr__(sidx, "_stack", st)   # not a field: never compared
    return st


def _lockstep_search(sidx: ShardedIndex, live: list, q: torch.Tensor,
                     params: SearchParams, quantized: bool,
                     backend: str = "auto", stats: Optional[dict] = None,
                     tracer: Optional[Tracer] = None) -> list:
    """The ``live`` slots' searches of the queries ``q`` [B, d] as one
    lock-step search over S·B rows of ``_stacked(sidx)``: the queries
    once a live slot, each row starting at its slot's medoid, with its
    slot's RaBitQ query context, and a visited bitset that covers its
    slot's rows alone (``seen_base``), so the bitsets take S·B rows of
    one slot's width.  Returns each live slot's (local ids, dists)
    [B, k], equal to its own ``_local_search``'s: every step of the
    engine is per row, and a row's ids stay in its slot's rows.  A
    ``stats`` dict receives ``n_hops``, each live slot's hop counts [B]
    in ``live``'s order, and ``iterations``, the loop's passes with a row
    still searching (a host count: the loop calls its per-pass distance
    once a pass, the estimate of δ-EMQG or, after the start's, the exact
    distance of δ-EMG).  A ``tracer`` receives the probing loop's spans
    (``_beam_probing_batch``)."""
    graph, codes, bases = _stacked(sidx)
    slots = [sidx.slots[s] for s in live]
    width = max(_graph(x).n for x in slots)
    B, k = q.shape[0], params.k
    qs = q.repeat(len(live), 1)
    passes = 0

    def counted(fn):
        def call(*args):
            nonlocal passes
            passes += 1
            return fn(*args)
        return call

    def per_row(values):
        return torch.tensor(values, dtype=torch.int32,
                            device=q.device).repeat_interleave(B)

    base = per_row([bases[s] for s in live])
    start = base + per_row([_graph(x).medoid for x in slots])
    exact = make_batch_dist_fn(graph.vectors, backend)
    if quantized:
        ctxs = [rabitq.prepare_query(x.codes, q) for x in slots]
        ctx = rabitq.QueryCtx(
            q=qs, q_unit=torch.cat([c.q_unit for c in ctxs]),
            sum_q=torch.cat([c.sum_q for c in ctxs]),
            norm_q=torch.cat([c.norm_q for c in ctxs]),
            sqrt_d=ctxs[0].sqrt_d)
        estimate = (rabitq.estimate_sqdist_plain
                    if resolve_backend(backend, q.device) == "jnp"
                    else rabitq.estimate_sqdist)
        st = _beam_probing_batch(graph.neighbors, width, exact,
                                 counted(lambda ids: estimate(codes, ctx,
                                                              ids)), qs,
                                 start, params, seen_base=base,
                                 **traced_kw(tracer))
        ids, d2 = st.ce_ids[:, :k], st.ce_d2[:, :k]
    else:
        st = _beam_search_batch(graph, qs, start, params, counted(exact),
                                seen_base=base, seen_n=width)
        passes -= 1                             # the start's distance
        ids, d2 = st.cand_ids[:, :k], st.cand_d2[:, :k]
    dists = _true_dists(d2)
    if stats is not None:
        stats["n_hops"] = list(st.n_hops.split(B))
        stats["iterations"] = passes
    return [(torch.where(i >= 0, i - bases[s], i), d)
            for i, d, s in zip(ids.split(B), dists.split(B), live)]


def _masked(ids: torch.Tensor, dists: torch.Tensor, offset: int,
            size: Optional[int]):
    """Global ids and distances of one slot's list: pad rows (local id ≥
    ``size``) and invalid entries become (-1, inf)."""
    keep = ids >= 0
    if size is not None:
        keep = keep & (ids < size)
    gids = torch.where(keep, ids + offset, torch.full_like(ids, -1))
    return gids, torch.where(keep, dists, torch.full_like(dists, math.inf))


def _dead(B: int, k: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.full((B, k), -1, dtype=torch.int32, device=device),
            torch.full((B, k), math.inf, device=device))


def _top(cat_i: torch.Tensor, cat_d: torch.Tensor, k: int):
    d, idx = stable_topk_smallest(cat_d, k)
    return torch.gather(cat_i, 1, idx), d


def _merge_all_gather(lists, k: int):
    """[(ids, dists) [B, k] per slot, in slot order] → exact top-k; on ties
    the lower slot wins (``jax.lax.top_k``'s order)."""
    return _top(torch.cat([i for i, _ in lists], 1),
                torch.cat([d for _, d in lists], 1), k)


def _merge_ring(lists, k: int):
    """The ring's merge as rank 0 runs it: its own list, then the lists of
    S − 1, S − 2, …, 1 (each step receives from the previous rank), each
    step a stable top-k of ``[acc, next]``."""
    acc_i, acc_d = lists[0]
    for j in range(len(lists) - 1, 0, -1):
        cur_i, cur_d = lists[j]
        acc_i, acc_d = _top(torch.cat([acc_i, cur_i], 1),
                            torch.cat([acc_d, cur_d], 1), k)
    return acc_i, acc_d


def _finish(mi: torch.Tensor, md: torch.Tensor):
    return torch.where(torch.isfinite(md), mi, torch.full_like(mi, -1)), md


def _check_merge(merge: str) -> None:
    if merge not in ("all_gather", "ring"):
        raise ValueError(f"unknown merge {merge!r} (all_gather | ring)")


def make_sharded_search(merge: str = "all_gather", quantized: bool = False,
                        backend: str = "auto"):
    """Single-controller sharded search.

    Returns ``run(sidx, queries [B, d], params, valid=None, around=None,
    stats=None, tracer=None) → (ids, dists)`` ``[B, k]`` tensors on the
    index's device; a ``stats`` dict receives ``n_hops``, each searched
    slot's per-query hop counts ``{slot: int32[B]}``, and ``iterations``,
    the lock-step loop's passes with a row still searching (a host
    integer; 0 with no slot searched).  A ``tracer`` receives an
    ``ann.call`` span (``queries``, ``shards``) holding
    ``search.lockstep`` (``rows``, S·B: ``_lockstep_search``'s stack,
    query contexts, start distances and loop) and ``search.merge`` (the
    lists' masking and merge).  The
    participating slots (``valid[slot]``, default all) are searched as
    ``probing_search`` (``quantized``) or ``search`` on ``backend`` would
    search each, all at once in one lock-step loop (``_lockstep_search``).
    Where the context manager ``around`` is given (the server's per-shard
    spans), the search runs inside ``around(slot)`` of every participating
    slot, entered in slot order, so each slot's span covers the one search
    its slot took part in.
    Each list is masked (pad rows, invalid ids) and offset to global ids;
    non-participating slots contribute (-1, inf) and are not searched; the
    lists are merged with ``merge``; an id whose distance is not finite
    becomes -1.
    """
    _check_merge(merge)

    def run(sidx: ShardedIndex, queries, params: SearchParams, valid=None,
            around=None, stats=None, tracer=None):
        with maybe_span(tracer, "ann.call", queries=len(queries),
                        shards=sidx.n_shards):
            valid = np.ones(sidx.n_shards, bool) if valid is None \
                else np.asarray(valid, bool)
            q = as_queries(queries, sidx.device)
            live = [slot for slot in range(sidx.n_shards) if valid[slot]]
            found, counts = {}, {"n_hops": [], "iterations": 0}
            if live:
                with contextlib.ExitStack() as spans:
                    for slot in live if around is not None else ():
                        spans.enter_context(around(slot))
                    spans.enter_context(maybe_span(
                        tracer, "search.lockstep",
                        rows=len(live) * q.shape[0]))
                    found = dict(zip(live, _lockstep_search(
                        sidx, live, q, params, quantized, backend, counts,
                        tracer)))
            if stats is not None:
                stats["n_hops"] = dict(zip(live, counts["n_hops"]))
                stats["iterations"] = counts["iterations"]
            with maybe_span(tracer, "search.merge"):
                lists = []
                for slot in range(sidx.n_shards):
                    if not valid[slot]:
                        lists.append(_dead(q.shape[0], params.k, q.device))
                        continue
                    lists.append(_masked(*found[slot], sidx.offsets[slot],
                                         None if sidx.sizes is None
                                         else sidx.sizes[slot]))
                if merge == "ring":
                    return _finish(*_merge_ring(lists, params.k))
                return _finish(*_merge_all_gather(lists, params.k))

    return run


# ---------------------------------------------------------------------------
# SPMD over torch.distributed: one rank per slot.
# ---------------------------------------------------------------------------

def _pack(ids: torch.Tensor, dists: torch.Tensor) -> torch.Tensor:
    """(ids int32, dists f32) [B, k] → one int32 [B, 2k] message."""
    return torch.cat([ids.to(torch.int32),
                      dists.to(torch.float32).view(torch.int32)], 1)


def _unpack(msg: torch.Tensor):
    k = msg.shape[1] // 2
    return msg[:, :k], msg[:, k:].contiguous().view(torch.float32)


def spmd_sharded_search(local, offset: int, size: Optional[int], queries,
                        params: SearchParams, *, merge: str = "all_gather",
                        quantized: bool = False, valid: bool = True):
    """One rank's part of the SPMD sharded search (rank = slot of the
    default process group).

    The rank searches its slot ``local`` (unless ``valid`` is False: its
    list is then (-1, inf)), masks and offsets its list as the single
    controller does, and merges with every other rank:
    ``dist.all_gather`` (lists side by side in rank order) or the ring's
    S−1 ``isend``/``irecv`` steps (send to rank + 1, receive from rank − 1).
    Every rank returns the merged ``(ids, dists)`` on its index's device;
    rank r's ring merged in the order r, r−1, …, so on exact ties ranks may
    differ, and rank 0 holds the single controller's answer.  On a gloo
    group the lists travel as host copies.
    """
    _check_merge(merge)
    world = dist.get_world_size()
    rank = dist.get_rank()
    dev = local.device
    q = as_queries(queries, dev)
    if valid:
        res = _local_search(local, q, params, quantized)
        gids, d = _masked(res.ids, res.dists, int(offset), size)
    else:
        gids, d = _dead(q.shape[0], params.k, dev)
    wire = "cpu" if dist.get_backend() == dist.Backend.GLOO else dev
    msg = _pack(gids, d).to(wire)
    if merge == "all_gather":
        parts = [torch.empty_like(msg) for _ in range(world)]
        dist.all_gather(parts, msg)
        mi, md = _merge_all_gather([_unpack(p) for p in parts], params.k)
    else:
        acc_i, acc_d = _unpack(msg)
        cur = msg
        nxt, prv = (rank + 1) % world, (rank - 1) % world
        for _ in range(world - 1):
            buf = torch.empty_like(cur)
            reqs = [dist.isend(cur, nxt), dist.irecv(buf, prv)]
            for r in reqs:
                r.wait()
            cur = buf
            cur_i, cur_d = _unpack(cur)
            acc_i, acc_d = _top(torch.cat([acc_i, cur_i], 1),
                                torch.cat([acc_d, cur_d], 1), params.k)
        mi, md = acc_i, acc_d
    return _finish(mi.to(dev), md.to(dev))


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spmd_entry(rank: int, world: int, port: int, backend: str,
                timeout_s: float, fn: Callable, args: tuple, out) -> None:
    dist.init_process_group(
        backend, init_method=f"tcp://localhost:{port}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out.put((rank, fn(rank, world, *args)))
    finally:
        dist.destroy_process_group()


def spawn_spmd(fn: Callable, world_size: int, args: tuple = (), *,
               backend: str = "gloo", timeout_s: float = 300.0) -> list:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` fresh processes
    (the ``spawn`` start method), each a rank of a ``backend`` process group
    at ``tcp://localhost:<free port>``, and return the ranks' results in
    rank order.  ``fn`` must be importable by name and return picklable
    (numpy) values.  Raises if a rank exits non-zero or the ranks outlive
    ``timeout_s``; every process is ended before this returns.  Kernels a
    rank launches on the card should be built before the call
    (``kernels._build.build_all``): a rank then only loads them."""
    ctx = torch.multiprocessing.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_spmd_entry,
                         args=(r, world_size, port, backend, timeout_s, fn,
                               args, out), daemon=True)
             for r in range(world_size)]
    for p in procs:
        p.start()
    results: dict[int, object] = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(results) < world_size:
            try:
                rank, value = out.get(timeout=0.5)
                results[rank] = value
                continue
            except queue_mod.Empty:
                pass
            failed = [(i, p.exitcode) for i, p in enumerate(procs)
                      if p.exitcode not in (None, 0)]
            if failed:
                raise RuntimeError(f"SPMD ranks failed (rank, exit code): "
                                   f"{failed}")
            if time.monotonic() > deadline:
                raise TimeoutError(f"SPMD ranks still running after "
                                   f"{timeout_s} s")
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
        failed = [(i, p.exitcode) for i, p in enumerate(procs)
                  if p.exitcode != 0]
        if failed:
            raise RuntimeError(f"SPMD ranks failed (rank, exit code): "
                               f"{failed}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(world_size)]


def _spmd_search_rank(rank: int, world: int, fields: list, offsets: tuple,
                      sizes, valid, queries: np.ndarray, params: SearchParams,
                      quantized: bool, device: str) -> dict:
    from ..interop import index_from_numpy

    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    local = index_from_numpy(**fields[rank], device=device)
    out = {}
    for merge in ("all_gather", "ring"):
        ids, d = spmd_sharded_search(
            local, offsets[rank], None if sizes is None else sizes[rank],
            queries, params, merge=merge, quantized=quantized,
            valid=bool(valid[rank]))
        out[merge] = (ids.cpu().numpy(), d.cpu().numpy())
    return out


def spmd_search(sidx: ShardedIndex, queries, params: SearchParams, *,
                quantized: bool = False, valid=None,
                dist_backend: str = "gloo", timeout_s: float = 300.0) -> list:
    """``sidx`` searched by ``spmd_sharded_search`` in one process a slot
    (``spawn_spmd``, a ``dist_backend`` process group), each rank's slot
    carried over as host arrays and searched on ``sidx``'s device, once
    with each merge.  Returns, in rank order, each rank's ``{merge: (ids,
    dists)}`` for ``all_gather`` and ``ring`` as numpy arrays."""
    from ..interop import index_to_numpy

    valid = np.ones(sidx.n_shards, bool) if valid is None \
        else np.asarray(valid, bool)
    fields = [index_to_numpy(s) for s in sidx.slots]
    dev = sidx.device
    device = dev.type if dev.index is None else f"{dev.type}:{dev.index}"
    return spawn_spmd(
        _spmd_search_rank, sidx.n_shards,
        (fields, sidx.offsets, sidx.sizes, valid,
         np.asarray(torch.as_tensor(queries, dtype=torch.float32).cpu()),
         params, quantized, device),
        backend=dist_backend, timeout_s=timeout_s)


# ---------------------------------------------------------------------------
# Shard health + coverage accounting (module docstring, fault tolerance).
# ---------------------------------------------------------------------------

class ShardHealthRegistry:
    """Host-side liveness over S logical shards × R replicas.

    ``participation()`` is the per-physical-slot mask handed to the sharded
    search: at most ONE live replica per logical shard participates (two
    replicas contributing the same rows would fill the merged top-k with
    duplicate ids).  A logical shard is covered iff any replica is live.

    Liveness is driven explicitly (``mark_dead`` / ``mark_live`` — the
    operator surface, and what the fault harness's ``ShardDeathPlan``
    calls) or through **heartbeats** on the injectable monotonic ``clock``:
    a :class:`DeadlineHealthChecker` ``mark_dead``s any live replica whose
    heartbeat age exceeds its deadline.  ``publish`` mirrors the state into
    an ``obs`` registry (``shard_live{shard}``, ``shard_coverage``,
    ``shard_failover`` gauges).
    """

    def __init__(self, n_shards: int, n_replicas: int = 1, clock=None):
        self.n_shards = n_shards
        self.n_replicas = n_replicas
        self.clock = clock if clock is not None else time.perf_counter
        self._live = np.ones((n_shards, n_replicas), bool)
        now = self.clock()
        self._last_beat = np.full((n_shards, n_replicas), now, float)

    def mark_dead(self, shard: int, replica: int = 0) -> None:
        self._live[shard, replica] = False

    def mark_live(self, shard: int, replica: int = 0) -> None:
        self._live[shard, replica] = True
        self._last_beat[shard, replica] = self.clock()

    def heartbeat(self, shard: int, replica: int = 0,
                  now: Optional[float] = None) -> None:
        """Record a liveness heartbeat for one replica (does NOT revive a
        slot already marked dead — a zombie's late beat must not undo an
        operator/checker kill; use ``mark_live`` for explicit revival)."""
        self._last_beat[shard, replica] = \
            now if now is not None else self.clock()

    def heartbeat_age(self, shard: int, replica: int = 0,
                      now: Optional[float] = None) -> float:
        now = now if now is not None else self.clock()
        return float(now - self._last_beat[shard, replica])

    def publish(self, metrics) -> None:
        """Mirror liveness into an ``obs.MetricsRegistry`` as gauges."""
        for s in range(self.n_shards):
            metrics.gauge("shard_live", {"shard": s}).set(
                float(self._live[s].any()))
        metrics.gauge("shard_coverage").set(self.coverage())
        metrics.gauge("shard_failover").set(self.n_failover)

    def live_shards(self) -> list[int]:
        return [s for s in range(self.n_shards) if self._live[s].any()]

    def dead_shards(self) -> list[int]:
        return [s for s in range(self.n_shards) if not self._live[s].any()]

    def coverage(self) -> float:
        return len(self.live_shards()) / self.n_shards

    @property
    def n_failover(self) -> int:
        """Logical shards currently served by a non-primary replica."""
        return int(sum(1 for s in range(self.n_shards)
                       if not self._live[s, 0] and self._live[s].any()))

    def participation(self) -> np.ndarray:
        """bool[S·R] — first live replica of each logical shard."""
        mask = np.zeros((self.n_shards, self.n_replicas), bool)
        for s in range(self.n_shards):
            alive = np.where(self._live[s])[0]
            if alive.size:
                mask[s, alive[0]] = True
        return mask.ravel()


class DeadlineHealthChecker:
    """Deadline-based shard health: a live replica whose last heartbeat is
    older than ``deadline_s`` is ``mark_dead``-ed.

    Call :meth:`check` from the serve loop (O(S·R) numpy reads) or a timer.
    Both the registry clock and ``check(now=...)`` are injectable, so a
    fault schedule can age heartbeats without sleeping.

    With ``metrics``, every check refreshes
    ``shard_replica_heartbeat_age_seconds{shard,replica}`` (every slot's raw
    age, live or dead) and ``shard_heartbeat_age_seconds{shard}`` (the
    **min** age over the shard's live replicas, ``inf`` when none is live),
    bumps ``shard_marked_dead_total`` per kill, emits a
    ``shard_deadline_expired`` event, and republishes the liveness gauges.
    """

    def __init__(self, registry: ShardHealthRegistry, deadline_s: float,
                 metrics=None):
        if deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        self.registry = registry
        self.deadline_s = float(deadline_s)
        self.metrics = metrics
        self.n_checks = 0
        self.n_killed = 0

    def check(self, now: Optional[float] = None) -> list[tuple[int, int]]:
        """One sweep; returns the (shard, replica) slots killed this call."""
        reg = self.registry
        now = now if now is not None else reg.clock()
        self.n_checks += 1
        killed: list[tuple[int, int]] = []
        for s in range(reg.n_shards):
            for r in range(reg.n_replicas):
                age = reg.heartbeat_age(s, r, now=now)
                if self.metrics is not None:
                    self.metrics.gauge(
                        "shard_replica_heartbeat_age_seconds",
                        {"shard": s, "replica": r}).set(age)
                if not reg._live[s, r]:
                    continue
                if age > self.deadline_s:
                    reg.mark_dead(s, r)
                    killed.append((s, r))
                    self.n_killed += 1
                    if self.metrics is not None:
                        self.metrics.counter("shard_marked_dead_total").inc()
                        self.metrics.event(
                            "shard_deadline_expired", shard=s, replica=r,
                            age_s=age, deadline_s=self.deadline_s)
            if self.metrics is not None:
                live = np.where(reg._live[s])[0]
                age_s = min((reg.heartbeat_age(s, r, now=now) for r in live),
                            default=math.inf)
                self.metrics.gauge("shard_heartbeat_age_seconds",
                                   {"shard": s}).set(age_s)
        if self.metrics is not None:
            reg.publish(self.metrics)
        return killed


@dataclasses.dataclass(frozen=True)
class ShardedSearchResult:
    """Merged top-k plus explicit per-response degradation accounting."""

    ids: torch.Tensor              # [B, k] global ids (-1 where unfilled)
    dists: torch.Tensor            # [B, k]
    coverage: float                # live logical shards / S
    live_shards: int
    n_shards: int
    max_missed: int                # worst-case true neighbors lost to dead shards
    failover: int                  # shards answered by a non-primary replica


class FaultTolerantShardedSearch:
    """Registry-masked single-controller sharded search with coverage
    accounting.

    The mask is recomputed from the registry on every call, so marking a
    shard dead (or a replica live again) takes effect on the next batch.
    """

    def __init__(self, sidx: ShardedIndex, merge: str = "all_gather",
                 quantized: bool = False, n_replicas: int = 1,
                 registry: Optional[ShardHealthRegistry] = None,
                 backend: str = "auto"):
        n_slots = sidx.n_shards
        if n_slots % n_replicas:
            raise ValueError(f"{n_slots} slots not divisible by "
                             f"{n_replicas} replicas")
        self.sidx = sidx
        self.quantized = quantized
        # a shared registry lets several searchers (e.g. the two merge
        # strategies of a resilient server) see one liveness truth
        self.registry = registry if registry is not None else \
            ShardHealthRegistry(n_slots // n_replicas, n_replicas)
        if self.registry.n_shards * self.registry.n_replicas != n_slots:
            raise ValueError("registry shape does not match index slots")
        self._run = make_sharded_search(merge=merge, quantized=quantized,
                                        backend=backend)
        if sidx.sizes is not None:
            self.shard_sizes = np.asarray(sidx.sizes)[::n_replicas].astype(int)
        else:
            offs = np.asarray(sidx.offsets)[::n_replicas]
            self.shard_sizes = np.diff(
                np.append(offs, sidx.n_total)).astype(int)

    def __call__(self, queries, params: SearchParams,
                 around=None) -> ShardedSearchResult:
        """The masked search; ``around`` as ``make_sharded_search``'s."""
        mask = self.registry.participation()
        if not mask.any():
            raise RuntimeError("no live shard replicas")
        ids, dists = self._run(self.sidx, queries, params, valid=mask,
                               around=around)
        dead = self.registry.dead_shards()
        max_missed = int(min(params.k,
                             sum(min(params.k, self.shard_sizes[s])
                                 for s in dead)))
        return ShardedSearchResult(
            ids=ids, dists=dists,
            coverage=self.registry.coverage(),
            live_shards=len(self.registry.live_shards()),
            n_shards=self.registry.n_shards,
            max_missed=max_missed,
            failover=self.registry.n_failover)


def host_reference_merge(sidx: ShardedIndex, registry: ShardHealthRegistry,
                         queries, params: SearchParams,
                         quantized: bool = False):
    """Oracle for the masked merge: per-slot searches, masked and merged on
    the host in numpy over exactly the participating slots (stable sort:
    on ties the lower slot wins).  O(S) sequential searches — test and
    audit use only.  Returns numpy ``(ids, dists)``."""
    mask = registry.participation()
    all_i, all_d = [], []
    for slot in np.where(mask)[0]:
        res = _local_search(sidx.slots[slot], queries, params, quantized)
        ids = res.ids.cpu().numpy()
        keep = ids >= 0
        if sidx.sizes is not None:
            keep &= ids < sidx.sizes[slot]
        all_i.append(np.where(keep, ids + sidx.offsets[slot], -1))
        all_d.append(np.where(keep, res.dists.cpu().numpy(), np.inf))
    cat_i = np.concatenate(all_i, axis=1)
    cat_d = np.concatenate(all_d, axis=1)
    order = np.argsort(cat_d, axis=1, kind="stable")[:, : params.k]
    mi = np.take_along_axis(cat_i, order, axis=1)
    md = np.take_along_axis(cat_d, order, axis=1)
    return np.where(np.isfinite(md), mi, -1), md
