"""Graph-invariant auditor for δ-EMG indexes (post-recovery /
post-mutation).

Counterpart of ``repro.core.verify``, in torch on the graph's device, with
the same checks, messages and metrics, so a report equals the JAX
package's on the same graph:

* **structure**   — ids in range, no self-loops, no duplicate edges per row
                    (hard errors: these mean corrupted adjacency).
* **degree**      — every row within the cap; no isolated live node.
* **tombstones**  — bitmap shape/dtype matches the graph; a live medoid.
* **reachability** — BFS from the medoid covers every live node.
* **monotone descent (sampled)** — for a sample of live nodes ``u`` (drawn
  with ``np.random.default_rng(seed)`` as there, so the same nodes are
  probed), a search with query ``vec(u)`` must reach ``u``; a failure
  share above ``monotone_tol`` is a hard violation, below it a warning.
* **reverse-edge symmetry under the cap** — for each distinct edge (u, v)
  with ``deg(v) < M`` and neither end tombstoned, (v, u) should usually
  exist; reported as a metric with a tolerance.  The reference builds a
  Python set of all n·M edges; here the edges are sorted keys u·n + v and
  each (v, u) is looked up with ``searchsorted``.

``audit`` returns an ``AuditReport``; ``report.ok`` is True iff no hard
violation was found.  Runnable from the CLI via ``launch/serve.py
--audit``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .build_approx import _edges
from .search import search
from .types import GraphIndex, SearchParams


@dataclasses.dataclass
class AuditReport:
    """Outcome of one invariant audit."""

    n: int = 0
    n_live: int = 0
    violations: list = dataclasses.field(default_factory=list)   # hard errors
    warnings: list = dataclasses.field(default_factory=list)     # soft findings
    metrics: dict = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.violations

    def summary(self) -> str:
        head = ("OK" if self.ok else f"{len(self.violations)} VIOLATION(S)")
        lines = [f"[audit] {head} — n={self.n} live={self.n_live}"]
        lines += [f"  ERROR: {v}" for v in self.violations]
        lines += [f"  warn:  {w}" for w in self.warnings]
        for k in sorted(self.metrics):
            lines.append(f"  {k} = {self.metrics[k]}")
        return "\n".join(lines)


def _bfs_live_reachable(nbr: torch.Tensor, start: int) -> torch.Tensor:
    """bool[n]: reachable from ``start`` (tombstones route, so no
    filtering).  The auditor's own BFS, on frontier masks where the
    builder's (``build_approx._bfs_reachable``) keeps id lists, so each
    can check the other."""
    n = nbr.shape[0]
    seen = torch.zeros(n, dtype=torch.bool, device=nbr.device)
    seen[start] = True
    frontier = seen.clone()
    while bool(frontier.any()):
        nxt = nbr[frontier].reshape(-1).long()
        frontier = torch.zeros_like(seen)
        frontier[nxt[nxt >= 0]] = True
        frontier &= ~seen
        seen |= frontier
    return seen


def _first(ids: torch.Tensor) -> list:
    return ids[:5].tolist()


def audit(graph: GraphIndex, tombstones=None,
          sample: int = 32, seed: int = 0,
          symmetry_tol: float = 0.25,
          check_monotone: bool = True,
          monotone_tol: float = 0.1) -> AuditReport:
    """Audit the invariants listed in the module docstring.

    ``tombstones`` — optional bool[n] tensor or array (None → all nodes
    live).  ``sample`` caps the number of monotone-descent probes.
    ``symmetry_tol`` is the tolerated fraction of missing reverse edges
    among edges whose target has spare capacity; ``monotone_tol`` the
    tolerated fraction of failed descent probes.
    """
    nbr = graph.neighbors
    dev = nbr.device
    n, M = nbr.shape
    rep = AuditReport(n=n)
    if tombstones is None:
        tomb_h = np.zeros(n, bool)
    elif isinstance(tombstones, torch.Tensor):
        tomb_h = tombstones.cpu().numpy()
    else:
        tomb_h = np.asarray(tombstones)

    # -- tombstone bitmap consistency ---------------------------------------
    if tomb_h.shape != (n,):
        rep.violations.append(
            f"tombstone bitmap shape {tomb_h.shape} != ({n},)")
        tomb_h = np.zeros(n, bool)
    if tomb_h.dtype != np.bool_:
        rep.violations.append(f"tombstone bitmap dtype {tomb_h.dtype} != bool")
        tomb_h = tomb_h.astype(bool)
    tomb = torch.from_numpy(tomb_h).to(dev)
    live = ~tomb
    rep.n_live = int(live.sum())
    med = int(graph.medoid)
    if not (0 <= med < n):
        rep.violations.append(f"medoid {med} out of range [0, {n})")
        return rep        # nothing below is meaningful without an entry point
    if tomb_h[med]:
        rep.violations.append(f"medoid {med} is tombstoned")
    if rep.n_live == 0:
        rep.violations.append("no live nodes")
        return rep

    # -- structure ----------------------------------------------------------
    nbr64 = nbr.long()
    n_oob = int(((nbr64 < -1) | (nbr64 >= n)).sum())
    if n_oob:
        rep.violations.append(f"{n_oob} neighbor ids out of range [-1, {n})")
    rows = torch.arange(n, device=dev)
    self_loops = int((nbr64 == rows[:, None]).sum())
    if self_loops:
        rep.violations.append(f"{self_loops} self-loop edges")
    # duplicate neighbors within a row (among valid entries)
    holes = -torch.arange(1, n * M + 1, device=dev).reshape(n, M)
    srt = torch.sort(torch.where(nbr64 >= 0, nbr64, holes), dim=1).values
    n_dup = int(((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).sum())
    if n_dup:
        rep.violations.append(f"{n_dup} duplicate edges within rows")

    # -- degree -------------------------------------------------------------
    deg = (nbr64 >= 0).sum(1)
    rep.metrics["mean_degree"] = int(deg[live].sum()) / rep.n_live
    rep.metrics["max_degree_cap"] = M
    isolated = torch.nonzero(live & (deg == 0) & (rows != med))[:, 0]
    if isolated.numel() and rep.n_live > 1:
        rep.violations.append(
            f"{isolated.numel()} isolated live nodes (first: "
            f"{_first(isolated)})")

    if n_oob:
        return rep        # BFS / gather below would index out of bounds

    # -- reachability (every live node, exact BFS) --------------------------
    seen = _bfs_live_reachable(nbr, med)
    unreachable = torch.nonzero(live & ~seen)[:, 0]
    rep.metrics["n_unreachable_live"] = int(unreachable.numel())
    if unreachable.numel():
        rep.violations.append(
            f"{unreachable.numel()} live nodes unreachable from medoid "
            f"(first: {_first(unreachable)})")

    # -- reverse-edge symmetry under the cap --------------------------------
    src, dst = _edges(nbr)
    keys = torch.unique(src * n + dst)            # the distinct edges, sorted
    u, v = keys // n, keys % n
    exempt = (deg[v] >= M) | tomb[v] | tomb[u]    # cap-full or tombstoned
    u, v = u[~exempt], v[~exempt]
    considered = int(u.numel())
    back = v * n + u
    at = torch.searchsorted(keys, back).clamp_max(max(keys.numel() - 1, 0))
    missing = considered - int((keys[at] == back).sum()) if considered else 0
    frac_missing = missing / max(considered, 1)
    rep.metrics["reverse_edge_missing_frac"] = float(frac_missing)
    if frac_missing > symmetry_tol:
        rep.warnings.append(
            f"reverse-edge symmetry-under-cap: {missing}/{considered} "
            f"({frac_missing:.2f}) missing > tol {symmetry_tol}")

    # -- sampled δ-monotone descent -----------------------------------------
    if check_monotone and unreachable.numel() == 0:
        rng = np.random.default_rng(seed)
        live_ids = np.where((seen & live).cpu().numpy())[0]
        probe = rng.choice(live_ids, size=min(sample, live_ids.size),
                           replace=False).astype(np.int32)
        probe_t = torch.from_numpy(probe).to(dev)
        p = SearchParams(k=1, l0=8, l_max=64, alpha=1.2, adaptive=True,
                         max_hops=2048)
        res = search(graph, graph.vectors[probe_t.long()], p)
        got = res.ids[:, 0]
        dists = res.dists[:, 0]
        # success = reached the node itself, or an exact duplicate of it
        bad = torch.nonzero((got != probe_t) & (dists > 1e-5))[:, 0]
        rep.metrics["monotone_probes"] = int(probe.size)
        rep.metrics["monotone_failures"] = int(bad.numel())
        if bad.numel():
            msg = (f"monotone descent failed for {bad.numel()}/{probe.size} "
                   f"sampled nodes (first: {_first(probe_t[bad])})")
            if bad.numel() / probe.size > monotone_tol:
                rep.violations.append(msg)
            else:
                rep.warnings.append(msg)
    return rep


def audit_live(live, **kw) -> AuditReport:
    """Audit a ``core.updates.LiveIndex`` (graph + tombstone bitmap)."""
    return audit(live.graph, tombstones=live.tombstones, **kw)
