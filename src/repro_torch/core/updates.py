"""Streaming index maintenance: insert / delete on a live δ-EMG
(FreshDiskANN-style), without full rebuilds, made crash-safe by a
write-ahead log.

Counterpart of ``repro.core.updates``, on the graph's device, giving the
same arrays as the JAX package on the same input:

* ``insert`` searches the current graph for each new point's candidates
  (Algorithm 4's candidate generation; on the card the ``gather_l2_tiled``
  kernel), prunes them with the occlusion rule (``batched_l2``), splices
  the new rows in, adds reverse edges under the degree cap and runs the
  builder's connectivity repair.  The reverse-edge loop is sequential (a
  row's fill changes as it goes), so the rows it can touch, their
  neighbours' vectors and the new vectors are gathered off the device
  once and the loop runs on the host in numpy, in the reference's own
  expressions, so its comparisons round as the reference's do.
* ``delete`` marks tombstones; ``search_live`` routes through them and
  filters them from the results.
* ``consolidate`` splices each deleted node out by reconnecting its
  in-neighbours to its out-neighbours under the occlusion rule, then
  compacts.  The reference makes one selection call per (dead node,
  in-neighbour) pair, in the iteration order of a Python set of the dead
  ids.  A node's new row depends only on its own row and on dead rows,
  which never change, so only the order in which each node meets its dead
  out-neighbours matters: round r handles every node's r-th pair, in
  blocks of ``BuildParams.block`` rows.

Crash safety (``JournaledLiveIndex``): every mutation batch is journaled
to a write-ahead log *before* it touches the in-memory ``LiveIndex``.  A
WAL record is two files committed in order — ``wal_XXXXXXXXX.npz``
(payload arrays) then ``wal_XXXXXXXXX.json`` (manifest: seq, op, per-array
CRC32) — each written via tmp + ``os.replace``; a record is committed iff
its manifest exists, parses, and every checksum matches.  Periodic full
checkpoints (``checkpoint()``, ``checkpoint.manager``) bound replay
length; ``recover()`` restores the newest intact checkpoint and replays
committed records in sequence.  Every op is a deterministic function of
(state, payload) — no float atomics, stable sorts only — so recovery
reproduces the uninterrupted run bit for bit, on the card too.

The directory layout (``meta.json``, ``ckpt/step_*``, ``wal/wal_*``), the
record and checkpoint files and their keys and dtypes are the JAX
package's, so a journal either package wrote recovers in the other.
"""

from __future__ import annotations

import dataclasses
import io
import json
import logging
import os
import re
import time
import zlib
from typing import Callable, Optional

import numpy as np
import torch

from ..checkpoint.manager import list_steps, restore_latest, save_checkpoint
from .build_approx import (BuildParams, _edges, _prep_candidates,
                           _rank_in_group, _repair_connectivity,
                           _select_block)
from .distances import medoid as find_medoid
from .search import search
from .types import GraphIndex, SearchParams, SearchResult

log = logging.getLogger("repro_torch.updates")


@dataclasses.dataclass
class LiveIndex:
    """A δ-EMG plus mutation state: the graph's tensors and a tombstone
    bitmap ``bool[n]``, all on the graph's device."""

    graph: GraphIndex
    tombstones: torch.Tensor
    params: BuildParams

    @property
    def n_live(self) -> int:
        return int((~self.tombstones).sum())

    @property
    def frac_deleted(self) -> float:
        return int(self.tombstones.sum()) / self.tombstones.numel()


def as_live(graph: GraphIndex, params: Optional[BuildParams] = None) -> LiveIndex:
    return LiveIndex(graph=graph,
                     tombstones=torch.zeros(graph.n, dtype=torch.bool,
                                            device=graph.device),
                     params=params or BuildParams())


def _host(x, dtype) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.cpu()
    return np.asarray(x, dtype)


class _Stages:
    """Seconds of one op's stages into the histogram ``live_stage_seconds``
    {op, stage} of ``metrics``, one observation a stage when the op ends;
    nothing when ``metrics`` is None.  Each stage ends with the device
    synchronised, so it holds its own kernels' time."""

    def __init__(self, metrics, op: str, device: torch.device):
        self.metrics, self.op, self.device = metrics, op, device
        self.acc: dict[str, float] = {}
        self.t = self._now()

    def _now(self) -> float:
        if self.metrics is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def __call__(self, stage: str) -> None:
        if self.metrics is None:
            return
        now = self._now()
        self.acc[stage] = self.acc.get(stage, 0.0) + now - self.t
        self.t = now

    def observe(self) -> None:
        for stage, sec in self.acc.items():
            self.metrics.histogram("live_stage_seconds",
                                   {"op": self.op, "stage": stage}).observe(sec)


def _reverse_edges(kept: np.ndarray, cnt: np.ndarray, rows: np.ndarray,
                   targets: np.ndarray, old: np.ndarray, vecs: np.ndarray,
                   n0: int, M: int) -> None:
    """The reference's reverse-edge loop on the rows it can touch.

    ``rows`` int32[T, M] are the current rows of ``targets`` (sorted ids),
    changed in place.  ``vecs`` holds the vectors of ``old`` (the sorted
    ids the loop can read: the targets and their neighbours), then the m
    new vectors; ids index it through ``loc``, with -1 reading the last
    row as numpy's index -1 reads the reference's concatenated array."""
    m = kept.shape[0]
    n_old = old.size

    def loc(ids):
        ids = np.asarray(ids, np.int64)
        out = np.where(ids >= n0, ids - n0 + n_old, np.searchsorted(old, ids))
        return np.where(ids < 0, n_old + m - 1, out)

    lrows = loc(rows)
    lv = loc(targets)
    row_of = {int(v): i for i, v in enumerate(targets.tolist())}
    deg = (rows >= 0).sum(1).astype(np.int32)
    for j in range(m):
        u = n0 + j
        lu = n_old + j
        for v in kept[j, : cnt[j]].tolist():
            i = row_of[v]
            row = rows[i, : deg[i]]
            if (row == u).any():
                continue
            if deg[i] < M:
                rows[i, deg[i]] = u
                lrows[i, deg[i]] = lu
                deg[i] += 1
            else:
                d2row = ((vecs[lrows[i, :M]] - vecs[lv[i]]) ** 2).sum(-1)
                worst = int(np.argmax(d2row))
                if d2row[worst] > ((vecs[lu] - vecs[lv[i]]) ** 2).sum():
                    rows[i, worst] = u
                    lrows[i, worst] = lu


def insert(live: LiveIndex, new_vectors,
           fault_hook: Optional[Callable[[str], None]] = None,
           metrics=None) -> LiveIndex:
    """Batched insertion.  Returns a new LiveIndex (functional state).

    ``fault_hook`` (testing only) is called at the ``mid_splice`` point —
    after the new rows are spliced into the adjacency but before reverse
    edges restore the local δ-closure; a hook that raises simulates a crash
    that leaves a half-mutated adjacency on the floor.  ``metrics`` (an
    ``obs.MetricsRegistry``) times the stages ``search``, ``select``,
    ``reverse_edges`` and ``repair`` (``_Stages``)."""
    p = live.params
    g = live.graph
    dev = g.device
    stages = _Stages(metrics, "insert", dev)
    new_np = _host(new_vectors, np.float32)
    new = torch.from_numpy(new_np).to(dev)
    m = new.shape[0]
    n0 = g.n
    M = g.max_degree
    L = min(p.beam_width, n0)

    # candidate generation on the current graph
    sp = SearchParams(k=min(L, n0), l0=L, l_max=L, adaptive=False,
                      max_hops=p.max_hops)
    _, cand_ids, cand_dists = search(g, new, sp, with_candidates=True)
    stages("search")

    vectors = torch.cat([g.vectors, new]).contiguous()
    kept, cnt = _select_block(vectors, cand_ids, cand_dists, t=min(p.t, L),
                              rule=p.rule, max_keep=M, fixed_delta=p.delta)
    nbr = torch.cat([g.neighbors, kept.to(torch.int32)])
    stages("select")
    if fault_hook is not None:
        fault_hook("mid_splice")

    # reverse edges under the cap; replace the longest edge when full so new
    # nodes always become reachable (same rule as connectivity repair)
    kept_h, cnt_h = kept.cpu().numpy(), cnt.cpu().numpy()
    targets = np.unique(kept_h[kept_h >= 0]).astype(np.int64)
    if targets.size:
        t_dev = torch.from_numpy(targets).to(dev)
        rows = g.neighbors[t_dev].cpu().numpy()
        old = np.unique(np.concatenate([targets, rows[rows >= 0]]))
        vecs = np.concatenate(
            [g.vectors[torch.from_numpy(old).to(dev)].cpu().numpy(), new_np])
        _reverse_edges(kept_h, cnt_h, rows, targets, old, vecs, n0, M)
        nbr[t_dev] = torch.from_numpy(rows).to(dev)
    stages("reverse_edges")

    # evicting a full row's longest edge above can sever some node's only
    # in-edge — run the builder's connectivity repair so every node stays
    # reachable from the medoid (deterministic, so WAL replay reproduces it)
    deg = (nbr >= 0).sum(1, dtype=torch.int32)
    _repair_connectivity(vectors, nbr, deg, M, g.medoid)
    stages("repair")
    stages.observe()

    graph = GraphIndex(vectors=vectors, neighbors=nbr, medoid=g.medoid,
                       kind=g.kind, delta=g.delta)
    tomb = torch.cat([live.tombstones,
                      torch.zeros(m, dtype=torch.bool, device=dev)])
    return LiveIndex(graph=graph, tombstones=tomb, params=p)


def delete(live: LiveIndex, ids) -> LiveIndex:
    tomb = live.tombstones.clone()
    idx = torch.from_numpy(_host(ids, np.int64).reshape(-1))
    tomb[idx.to(tomb.device)] = True
    return LiveIndex(graph=live.graph, tombstones=tomb, params=live.params)


def search_live(live: LiveIndex, queries, k: int, alpha: float = 1.2,
                l_max: int = 128, **kw) -> SearchResult:
    """Error-bounded search that filters tombstones from the results while
    still routing through them.  Over-fetches k + #tombstone-margin and
    keeps the first k valid, live ids in result order."""
    tomb = live.tombstones
    over = int(min(l_max, k + max(8, 4 * int(bool(tomb.any())) * k)))
    p = SearchParams(k=over, l0=over, l_max=l_max, alpha=alpha,
                     adaptive=True, max_hops=kw.pop("max_hops", 2048))
    res = search(live.graph, queries, p, **kw)
    ids, dists = res.ids, res.dists
    keep = (ids >= 0) & ~tomb[ids.clamp_min(0).long()]
    rank = torch.cumsum(keep.to(torch.int32), dim=1) - 1
    keep &= rank < k
    B = ids.shape[0]
    # keep k + 1 slots so the dropped entries have somewhere to land
    out_ids = torch.full((B, k + 1), -1, dtype=torch.int32, device=ids.device)
    out_d = torch.full((B, k + 1), float("inf"), device=ids.device)
    slot = torch.where(keep, rank, torch.full_like(rank, k)).long()
    rows = torch.arange(B, device=ids.device)[:, None].expand_as(slot)
    out_ids[rows[keep], slot[keep]] = ids[keep]
    out_d[rows[keep], slot[keep]] = dists[keep]
    return SearchResult(ids=out_ids[:, :k], dists=out_d[:, :k],
                        n_dist_comps=res.n_dist_comps,
                        n_approx_comps=res.n_approx_comps,
                        n_hops=res.n_hops, final_l=res.final_l,
                        saturated=res.saturated,
                        n_encounters=res.n_encounters)


def _merge_rows(rows: torch.Tensor, repl: torch.Tensor, u: torch.Tensor,
                tomb: torch.Tensor) -> torch.Tensor:
    """Per row: the ascending distinct live ids of ``rows`` ∪ ``repl``
    other than ``u``, padded with -1 (the reference's
    ``sorted(set(row + repl) - {u})`` on ids ≥ 0 that are not dead)."""
    cat = torch.cat([rows, repl], dim=1).long()
    big = tomb.numel()
    bad = (cat < 0) | tomb[cat.clamp_min(0)] | (cat == u[:, None])
    s = torch.sort(torch.where(bad, torch.full_like(cat, big), cat),
                   dim=1).values
    dup = torch.zeros_like(s, dtype=torch.bool)
    dup[:, 1:] = s[:, 1:] == s[:, :-1]
    s = torch.sort(torch.where(dup, torch.full_like(s, big), s), dim=1).values
    return torch.where(s == big, torch.full_like(s, -1), s).to(torch.int32)


def consolidate(live: LiveIndex, metrics=None) -> LiveIndex:
    """Splice tombstoned nodes out: reconnect in-neighbors to the deleted
    node's out-neighbors (occlusion-pruned), then compact ids.
    ``metrics`` times the stages ``merge`` (the pairs' order and merged
    candidate rows), ``select`` and ``compact`` (``_Stages``)."""
    p = live.params
    g = live.graph
    tomb = live.tombstones
    dev = g.device
    stages = _Stages(metrics, "consolidate", dev)
    nbr = g.neighbors.clone()
    n, M = nbr.shape
    dead = set(torch.nonzero(tomb)[:, 0].cpu().tolist())
    if not dead:
        return live

    # every (u, dead d) edge of a live u, ordered per u as the reference's
    # loop reaches it: dead nodes in the set's iteration order, a repeated
    # edge twice in a row
    order = torch.full((n,), -1, dtype=torch.int64, device=dev)
    order[torch.tensor(list(dead), device=dev)] = torch.arange(
        len(dead), device=dev)
    src, dst = _edges(nbr)
    pick = tomb[dst] & ~tomb[src]
    src, dst = src[pick], dst[pick]
    _, perm = torch.sort(src * len(dead) + order[dst], stable=True)
    src, dst = src[perm], dst[perm]
    rnd = _rank_in_group(src)
    L = 2 * M - 1
    for r in range(int(rnd.max()) + 1 if rnd.numel() else 0):
        u_r, d_r = src[rnd == r], dst[rnd == r]
        for s in range(0, u_r.numel(), p.block):
            u, d = u_r[s:s + p.block], d_r[s:s + p.block]
            merged = _merge_rows(nbr[u], nbr[d], u, tomb)
            nonempty = (merged >= 0).any(1)
            cand_ids, cand_dists = _prep_candidates(g.vectors, u, merged, L)
            stages("merge")
            kept, _ = _select_block(g.vectors, cand_ids, cand_dists,
                                    t=min(p.t, L), rule=p.rule, max_keep=M,
                                    fixed_delta=p.delta)
            nbr[u[nonempty]] = kept[nonempty].to(torch.int32)
            stages("select")

    # compact: drop dead rows, remap ids
    alive = torch.nonzero(~tomb)[:, 0]
    remap = torch.full((n,), -1, dtype=torch.int64, device=dev)
    remap[alive] = torch.arange(alive.numel(), device=dev)
    new_nbr = nbr[alive].long()
    new_nbr = torch.where(new_nbr >= 0, remap[new_nbr.clamp_min(0)],
                          torch.full_like(new_nbr, -1)).to(torch.int32)
    new_vec = g.vectors[alive].contiguous()
    graph = GraphIndex(vectors=new_vec, neighbors=new_nbr,
                       medoid=find_medoid(new_vec), kind=g.kind,
                       delta=g.delta)
    stages("compact")
    stages.observe()
    return LiveIndex(graph=graph,
                     tombstones=torch.zeros(alive.numel(), dtype=torch.bool,
                                            device=dev),
                     params=p)


# ---------------------------------------------------------------------------
# Write-ahead log + crash-safe journaled index (module docstring, part 2).
# ---------------------------------------------------------------------------

_WAL_RE = re.compile(r"^wal_(\d{9})\.json$")


class WalCorruptError(RuntimeError):
    """A WAL record failed integrity checks (treated as never-written)."""


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def _atomic_write(path: str, data: bytes,
                  fsync_hist=None) -> None:
    """tmp + fsync + rename.  ``fsync_hist`` (an ``obs.Histogram``) times
    the fsync alone, where WAL commit latency lives on real disks."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        if fsync_hist is not None:
            t0 = time.perf_counter()
            os.fsync(f.fileno())
            fsync_hist.observe(time.perf_counter() - t0)
        else:
            os.fsync(f.fileno())
    os.replace(tmp, path)


def wal_append(wal_dir: str, seq: int, op: str,
               payload: dict[str, np.ndarray],
               fault_hook: Optional[Callable[[str], None]] = None,
               metrics=None, compress: bool = False) -> str:
    """Append one committed record.  Payload npz lands first, the manifest
    (whose existence *is* the commit) second — a crash between the two
    (the ``torn_journal`` fault point) leaves an uncommitted torn record.

    ``compress`` writes the payload with ``np.savez_compressed``; the
    manifest checksums the arrays, not the file, so both verify and replay
    alike.  ``metrics`` (an ``obs.MetricsRegistry``) times the append into
    ``wal_append_seconds``, each fsync into ``wal_fsync_seconds``, and
    counts ``wal_records_total{op}``."""
    t_start = time.perf_counter()
    fsync_hist = None if metrics is None else \
        metrics.histogram("wal_fsync_seconds")
    os.makedirs(wal_dir, exist_ok=True)
    base = os.path.join(wal_dir, f"wal_{seq:09d}")
    buf = io.BytesIO()
    (np.savez_compressed if compress else np.savez)(buf, **payload)
    _atomic_write(base + ".npz", buf.getvalue(), fsync_hist=fsync_hist)
    if fault_hook is not None:
        fault_hook("torn_journal")
    manifest = {
        "seq": seq,
        "op": op,
        "keys": sorted(payload.keys()),
        "dtypes": {k: str(v.dtype) for k, v in payload.items()},
        "shapes": {k: list(v.shape) for k, v in payload.items()},
        "checksums": {k: _crc(v) for k, v in payload.items()},
    }
    _atomic_write(base + ".json", json.dumps(manifest).encode(),
                  fsync_hist=fsync_hist)
    if metrics is not None:
        metrics.histogram("wal_append_seconds").observe(
            time.perf_counter() - t_start)
        metrics.counter("wal_records_total", {"op": op}).inc()
    return base + ".json"


def wal_read(wal_dir: str, seq: int) -> tuple[str, dict[str, np.ndarray]]:
    """Load + verify one record.  Raises ``WalCorruptError`` on any
    integrity violation (missing/torn manifest, unreadable npz, checksum
    mismatch) — recovery treats those records as never-written."""
    base = os.path.join(wal_dir, f"wal_{seq:09d}")
    if not os.path.exists(base + ".json") and not os.path.exists(base + ".npz"):
        raise FileNotFoundError(f"no WAL record {seq}")   # clean end of log
    try:
        with open(base + ".json") as f:
            manifest = json.load(f)
    except Exception as e:
        # payload present but manifest missing/unparsable: torn record
        raise WalCorruptError(f"record {seq}: unreadable manifest: {e}") from e
    try:
        with np.load(base + ".npz") as z:
            payload = {k: z[k].copy() for k in z.files}
    except Exception as e:
        raise WalCorruptError(f"record {seq}: unreadable payload: {e}") from e
    if set(manifest.get("keys", [])) != set(payload.keys()):
        raise WalCorruptError(f"record {seq}: manifest/payload key mismatch")
    for k, arr in payload.items():
        want = manifest["checksums"].get(k)
        if want is not None and _crc(arr) != want:
            raise WalCorruptError(f"record {seq}: checksum mismatch on {k!r}")
    return manifest["op"], payload


def wal_seqs(wal_dir: str) -> list[int]:
    """Sequence numbers of records with a manifest present (not verified)."""
    if not os.path.isdir(wal_dir):
        return []
    return sorted(int(m.group(1))
                  for m in map(_WAL_RE.match, os.listdir(wal_dir)) if m)


def _record_bytes(wal_dir: str, seq: int) -> int:
    """On-disk footprint of one record (payload + manifest; 0 if absent)."""
    base = os.path.join(wal_dir, f"wal_{seq:09d}")
    total = 0
    for suffix in (".npz", ".json"):
        try:
            total += os.path.getsize(base + suffix)
        except OSError:
            pass
    return total


def _truncate_wal(wal_dir: str, upto_seq: int) -> None:
    for s in wal_seqs(wal_dir):
        if s <= upto_seq:
            base = os.path.join(wal_dir, f"wal_{s:09d}")
            for suffix in (".json", ".npz"):
                try:
                    os.remove(base + suffix)
                except FileNotFoundError:
                    pass


def _apply_op(live: LiveIndex, op: str, payload: dict,
              fault_hook=None, metrics=None) -> LiveIndex:
    """Deterministic op application — shared by the live path and replay
    (which times no stages)."""
    if op == "insert":
        return insert(live, payload["vectors"], fault_hook=fault_hook,
                      metrics=metrics)
    if op == "delete":
        return delete(live, payload["ids"])
    if op == "consolidate":
        return consolidate(live, metrics=metrics)
    raise ValueError(f"unknown WAL op: {op!r}")


def _params_meta(p: BuildParams) -> dict:
    """``meta.json``'s params: the JAX package's ``BuildParams`` fields,
    whose ``checkpoint_dir`` (a build option) this port does not have."""
    return {**dataclasses.asdict(p), "checkpoint_dir": None}


def _params_from_meta(d: dict) -> BuildParams:
    names = {f.name for f in dataclasses.fields(BuildParams)}
    return BuildParams(**{k: v for k, v in d.items() if k in names})


class JournaledLiveIndex:
    """A ``LiveIndex`` whose mutations are crash-safe (WAL + checkpoints).

    Layout under ``directory`` (the JAX package's)::

        meta.json            static state (BuildParams, kind, δ) — written once
        ckpt/step_XXXXXXXXX/ full snapshots via ``checkpoint.manager``
                             (step number == WAL sequence at save time)
        wal/wal_XXXXXXXXX.{npz,json}   journal records (seq 1, 2, ...)

    ``fault_hook(point)`` (testing only) is invoked at the named crash
    points — ``before_journal``, ``torn_journal``, ``after_journal``,
    ``mid_splice``; a raising hook simulates the process dying there.

    ``consolidate_frac``: a delete that pushes the tombstone fraction past
    it triggers a ``consolidate``, journaled as its own record.
    ``checkpoint_every_bytes``: when the WAL's on-disk records since the
    last checkpoint reach this many bytes, a checkpoint is taken right
    after the mutation commits.  ``compress`` writes WAL payloads with
    ``np.savez_compressed``.  All three are kept in ``meta.json``.
    """

    def __init__(self, live: LiveIndex, directory: str, *,
                 seq: int = 0, consolidate_frac: float = 0.3,
                 keep_checkpoints: int = 3,
                 checkpoint_every_bytes: Optional[int] = None,
                 compress: bool = False,
                 fault_hook: Optional[Callable[[str], None]] = None,
                 metrics=None):
        self.live = live
        self.directory = directory
        self.seq = seq
        self.consolidate_frac = consolidate_frac
        self.keep_checkpoints = keep_checkpoints
        self.checkpoint_every_bytes = checkpoint_every_bytes
        self.compress = compress
        self.fault_hook = fault_hook
        # obs.MetricsRegistry (or None): observation only
        self.metrics = metrics
        self.wal_dir = os.path.join(directory, "wal")
        self.ckpt_dir = os.path.join(directory, "ckpt")
        self._wal_bytes = 0     # on-disk record bytes since last checkpoint

    # -- construction --------------------------------------------------------
    @classmethod
    def create(cls, live: LiveIndex, directory: str,
               **kw) -> "JournaledLiveIndex":
        """Initialize a journal directory: meta + a seq-0 base checkpoint."""
        os.makedirs(directory, exist_ok=True)
        self = cls(live, directory, **kw)
        meta = {
            "kind": live.graph.kind,
            "delta": live.graph.delta,
            "params": _params_meta(live.params),
            "consolidate_frac": self.consolidate_frac,
            "checkpoint_every_bytes": self.checkpoint_every_bytes,
            "compress": self.compress,
        }
        _atomic_write(os.path.join(directory, "meta.json"),
                      json.dumps(meta).encode())
        self.checkpoint()
        return self

    # -- state snapshot ------------------------------------------------------
    def _tree(self) -> dict:
        g = self.live.graph
        return {
            "vectors": g.vectors,
            "neighbors": g.neighbors,
            "medoid": np.asarray(g.medoid, np.int32),
            "tombstones": self.live.tombstones,
        }

    def checkpoint(self) -> str:
        """Commit a full snapshot at the current sequence, then drop WAL
        records no retained checkpoint still needs."""
        t0 = time.perf_counter()
        path = save_checkpoint(self.ckpt_dir, self.seq, self._tree(),
                               keep=self.keep_checkpoints)
        if self.metrics is not None:
            self.metrics.histogram("checkpoint_save_seconds").observe(
                time.perf_counter() - t0)
        steps = list_steps(self.ckpt_dir)
        if steps:
            _truncate_wal(self.wal_dir, min(steps))
        self._wal_bytes = 0
        return path

    # -- mutations (journal first, splice second) ----------------------------
    def _fault(self, point: str) -> None:
        if self.fault_hook is not None:
            self.fault_hook(point)

    def _mutate(self, op: str, payload: dict[str, np.ndarray]) -> None:
        self._fault("before_journal")
        wal_append(self.wal_dir, self.seq + 1, op, payload,
                   fault_hook=self.fault_hook, metrics=self.metrics,
                   compress=self.compress)
        self._fault("after_journal")
        self.live = _apply_op(self.live, op, payload,
                              fault_hook=self.fault_hook,
                              metrics=self.metrics)
        self.seq += 1
        self._wal_bytes += _record_bytes(self.wal_dir, self.seq)
        if self.metrics is not None:
            self.metrics.gauge("wal_bytes_since_checkpoint").set(
                self._wal_bytes)
        if (self.checkpoint_every_bytes is not None
                and self._wal_bytes >= self.checkpoint_every_bytes):
            if self.metrics is not None:
                self.metrics.counter("wal_auto_checkpoint_total").inc()
                self.metrics.gauge("wal_bytes_since_checkpoint").set(0)
            self.checkpoint()

    def insert(self, vectors) -> None:
        self._mutate("insert", {"vectors": _host(vectors, np.float32)})

    def delete(self, ids) -> None:
        self._mutate("delete", {"ids": _host(ids, np.int64)})
        if self.live.frac_deleted > self.consolidate_frac:
            self.consolidate()

    def consolidate(self) -> None:
        self._mutate("consolidate", {})

    def search(self, queries, k: int, **kw) -> SearchResult:
        return search_live(self.live, queries, k, **kw)

    @property
    def n_live(self) -> int:
        return self.live.n_live


def recover(directory: str, metrics=None,
            device="cuda") -> tuple[JournaledLiveIndex, dict]:
    """Rebuild a ``JournaledLiveIndex`` on ``device`` from disk after a
    crash.

    Restores the newest intact checkpoint (corrupt steps walk back inside
    ``restore_latest``), then replays committed WAL records in sequence; the
    replay stops at the first missing or torn record (the op the crash
    interrupted before its commit point never happened).  Returns
    ``(journal, info)``: the checkpoint step used, the records replayed,
    any torn record seen, and the wall time (``elapsed_s``, also observed
    into ``checkpoint_restore_seconds`` when ``metrics`` is given).
    """
    t_start = time.perf_counter()
    with open(os.path.join(directory, "meta.json")) as f:
        meta = json.load(f)
    params = _params_from_meta(meta["params"])
    template = {
        "vectors": np.zeros((0, 0), np.float32),
        "neighbors": np.zeros((0, 0), np.int32),
        "medoid": np.zeros((), np.int32),
        "tombstones": np.zeros((0,), np.bool_),
    }
    ckpt_dir = os.path.join(directory, "ckpt")
    wal_dir = os.path.join(directory, "wal")
    step, tree = restore_latest(ckpt_dir, template, device=device)
    if step is None:
        raise FileNotFoundError(
            f"no intact checkpoint under {ckpt_dir}; cannot recover")
    graph = GraphIndex(vectors=tree["vectors"].contiguous(),
                       neighbors=tree["neighbors"],
                       medoid=int(tree["medoid"]),
                       kind=meta["kind"], delta=meta["delta"])
    live = LiveIndex(graph=graph, tombstones=tree["tombstones"],
                     params=params)
    info = {"checkpoint_step": step, "replayed": 0, "torn_seq": None}
    seq = step
    while True:
        try:
            op, payload = wal_read(wal_dir, seq + 1)
        except WalCorruptError as e:
            # torn record: crash mid-append → op never committed
            log.warning("WAL replay stops at %s", e)
            info["torn_seq"] = seq + 1
            break
        except FileNotFoundError:
            break
        live = _apply_op(live, op, payload)
        seq += 1
        info["replayed"] += 1
    info["elapsed_s"] = time.perf_counter() - t_start
    if metrics is not None:
        metrics.histogram("checkpoint_restore_seconds").observe(
            info["elapsed_s"])
    journal = JournaledLiveIndex(
        live, directory, seq=seq,
        consolidate_frac=meta.get("consolidate_frac", 0.3),
        checkpoint_every_bytes=meta.get("checkpoint_every_bytes"),
        compress=meta.get("compress", False), metrics=metrics)
    # resume the byte accumulator: committed records newer than the restored
    # checkpoint are exactly what the next auto-checkpoint threshold is over
    journal._wal_bytes = sum(_record_bytes(wal_dir, s)
                             for s in range(step + 1, seq + 1))
    return journal, info
