"""Self-healing shards: detect → rebuild → verify → atomically install.

Counterpart of ``repro.core.repair``.  The serving stack *detects* shard
loss (``ShardHealthRegistry`` + ``DeadlineHealthChecker``) and *degrades*
with explicit accounting (coverage / max_missed); this module closes the
loop: a dead replica is rebuilt from a durable vector source and re-enters
serving — without an operator — once the rebuilt graph is verified.

Components
----------
``ShardVectorStore``
    Durable per-shard vector source.  ``create`` snapshots the contiguous
    row partition (the exact padded rows ``build_sharded`` feeds each
    shard's build, via ``distributed.shard_rows``) as one npz + manifest
    per shard: tmp + fsync + ``os.replace`` writes, per-file CRC32 in the
    manifest, verify-on-read.  A corrupted source fails loudly
    (``ShardSourceCorruptError``) instead of rebuilding a wrong shard.  The
    layout is the JAX package's, file for file: a store either package
    creates loads in the other (``meta.json``'s ``params`` carry the
    reference's ``checkpoint_dir`` field, ``None``, which the port's
    ``BuildParams`` does not have and ignores on read).

``RepairController``
    Watches the registry for dead replicas and repairs them under a
    per-sweep budget.  One repair is a **two-phase** state machine:

    contained phase (any failure → backoff + retry, slot stays dead)
        load_source → rebuild (``distributed.build_shard`` on the serving
        index's device: the per-shard seed of ``build_sharded``, so the
        rebuilt index is bit-identical to the original build) → audit
        (``core.verify`` invariants) → spot-check (``host_reference_merge``
        restricted to the candidate slot: ids in range, self-probes return
        their own row)

    install phase (atomic-install rule)
        install the candidate ``ShardedIndex`` (one slot of the tuple
        replaced) → ``mark_live``.  The participation mask flips *only
        after* the verified index is installed: a crash before the install
        leaves the old index and a dead slot; a crash between install and
        ``mark_live`` leaves a verified index in a slot the mask still
        excludes.  Either way liveness never regresses and the next sweep
        retries.

    Failures back off exponentially (``backoff_s · 2^(attempt−1)``, capped)
    on the injectable monotonic clock.  ``fault_hook(point)`` fires at
    ``load_source`` / ``rebuild`` (contained) and ``before_install`` /
    ``mid_install`` / ``after_install`` (NOT contained — a raising hook
    simulates the process dying there, ``testing.faults.RepairFaultPlan``).

Observability (``obs``): ``repair_started_total`` /
``repair_succeeded_total`` / ``repair_failed_total`` counters (riding the
events of the same names), ``shard_under_repair{shard}`` gauge (1 from
first attempt until success), ``repair_duration_seconds`` histogram
(successful repairs).  All timing uses the injected monotonic clock.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import time
from typing import Callable, Optional

import numpy as np

from .build_approx import BuildParams
from .distributed import (ShardedIndex, ShardHealthRegistry, build_shard,
                          host_reference_merge, shard_rows)
from .types import EMQGIndex, SearchParams
from .updates import _atomic_write, _crc, _params_from_meta, _params_meta
from .verify import audit


class ShardSourceCorruptError(RuntimeError):
    """A shard's durable vector source failed integrity checks."""


class RepairError(RuntimeError):
    """A rebuilt shard failed verification (audit or spot-check)."""


# ---------------------------------------------------------------------------
# Durable per-shard vector source
# ---------------------------------------------------------------------------

class ShardVectorStore:
    """CRC-verified per-shard vector snapshots backing shard rebuilds.

    Layout under ``directory``::

        meta.json           {n_shards, n_total, per, dim, seed, quantized,
                             params}  — written once at create
        shard_XXXX.npz      the shard's full padded rows (``shard_rows``
                            output — rebuild input is bit-identical to the
                            original build input)
        shard_XXXX.json     {shard, n_real, dtype, shape, crc}
    """

    def __init__(self, directory: str):
        self.directory = directory
        with open(os.path.join(directory, "meta.json")) as f:
            self.meta = json.load(f)
        self.params = _params_from_meta(self.meta["params"])

    @property
    def n_shards(self) -> int:
        return int(self.meta["n_shards"])

    @property
    def n_total(self) -> int:
        return int(self.meta["n_total"])

    @property
    def quantized(self) -> bool:
        return bool(self.meta["quantized"])

    @property
    def seed(self) -> int:
        return int(self.meta["seed"])

    @classmethod
    def create(cls, directory: str, vectors, n_shards: int,
               params: Optional[BuildParams] = None, quantized: bool = False,
               seed: int = 0) -> "ShardVectorStore":
        vectors = np.asarray(vectors, np.float32)
        n = vectors.shape[0]
        per = int(np.ceil(n / n_shards))
        os.makedirs(directory, exist_ok=True)
        for s in range(n_shards):
            rows, n_real = shard_rows(vectors, s, per)
            base = os.path.join(directory, f"shard_{s:04d}")
            buf = io.BytesIO()
            np.savez(buf, rows=rows)
            _atomic_write(base + ".npz", buf.getvalue())
            manifest = {
                "shard": s,
                "n_real": n_real,
                "dtype": str(rows.dtype),
                "shape": list(rows.shape),
                "crc": _crc(rows),
            }
            _atomic_write(base + ".json", json.dumps(manifest).encode())
        meta = {
            "n_shards": n_shards,
            "n_total": n,
            "per": per,
            "dim": int(vectors.shape[1]),
            "seed": seed,
            "quantized": quantized,
            "params": _params_meta(params or BuildParams()),
        }
        _atomic_write(os.path.join(directory, "meta.json"),
                      json.dumps(meta).encode())
        return cls(directory)

    def load_shard(self, shard: int) -> tuple[np.ndarray, int]:
        """Load + verify one shard's padded rows.  Returns ``(rows, n_real)``;
        raises ``ShardSourceCorruptError`` on any integrity violation."""
        base = os.path.join(self.directory, f"shard_{shard:04d}")
        try:
            with open(base + ".json") as f:
                manifest = json.load(f)
        except Exception as e:
            raise ShardSourceCorruptError(
                f"shard {shard}: unreadable manifest: {e}") from e
        try:
            with np.load(base + ".npz") as z:
                rows = z["rows"].copy()
        except Exception as e:
            raise ShardSourceCorruptError(
                f"shard {shard}: unreadable payload: {e}") from e
        if list(rows.shape) != manifest["shape"]:
            raise ShardSourceCorruptError(
                f"shard {shard}: shape mismatch "
                f"{list(rows.shape)} != {manifest['shape']}")
        if _crc(rows) != manifest["crc"]:
            raise ShardSourceCorruptError(f"shard {shard}: checksum mismatch")
        return rows, int(manifest["n_real"])

    def build_shard(self, shard: int, device="cuda"):
        """From-source rebuild of one shard's index on ``device`` —
        bit-identical to the slot ``build_sharded`` produced there."""
        rows, _ = self.load_shard(shard)
        return build_shard(rows, shard, self.params, self.quantized,
                           self.seed, device)


# ---------------------------------------------------------------------------
# Repair controller
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RepairConfig:
    budget_per_sweep: int = 1          # max repair attempts per sweep
    backoff_s: float = 0.5             # first-retry delay after a failure
    backoff_cap_s: float = 30.0        # exponential backoff ceiling
    audit_sample: int = 16             # verify.audit monotone-probe sample
    probe_queries: int = 4             # spot-check self-probes per repair
    probe_self_tol: float = 0.5        # min fraction of self-probes that hit


@dataclasses.dataclass(frozen=True)
class RepairOutcome:
    shard: int
    replica: int
    status: str                        # "succeeded" | "failed"
    attempt: int
    duration_s: float
    error: Optional[str] = None


def install_slot(sidx: ShardedIndex, slot: int, local) -> ShardedIndex:
    """New ``ShardedIndex`` with physical slot ``slot`` replaced by
    ``local``.  Purely functional — the old index is untouched, so a crash
    mid-install can never corrupt serving."""
    slots = sidx.slots[:slot] + (local,) + sidx.slots[slot + 1:]
    return dataclasses.replace(sidx, slots=slots)


class RepairController:
    """Sweeps dead replicas and repairs them (see module docstring).

    ``get_sidx`` / ``set_sidx`` decouple the controller from index
    ownership: the serve layer passes closures over its live
    ``ShardedIndex`` so that an install swaps one consistent index.
    Rebuilds run on the current index's device.  ``sweep`` is cheap when
    nothing is dead (one O(S·R) registry scan) — call it per dispatch,
    after the health check.  ``last_rebuild`` holds ``(shard, replica,
    index)`` of the newest rebuild, installed or refused by the gate, so
    an operator can look at what the gate refused.
    """

    def __init__(self, store: ShardVectorStore,
                 registry: ShardHealthRegistry,
                 get_sidx: Callable[[], ShardedIndex],
                 set_sidx: Callable[[ShardedIndex], None],
                 config: Optional[RepairConfig] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 probe_params: Optional[SearchParams] = None,
                 metrics=None,
                 fault_hook: Optional[Callable[[str], None]] = None):
        if store.n_shards != registry.n_shards:
            raise ValueError(f"store has {store.n_shards} shards, registry "
                             f"{registry.n_shards}")
        self.store = store
        self.registry = registry
        self.get_sidx = get_sidx
        self.set_sidx = set_sidx
        self.config = config or RepairConfig()
        self.clock = clock
        self.probe_params = probe_params
        self.metrics = metrics
        self.fault_hook = fault_hook
        self._attempts: dict[tuple[int, int], int] = {}
        self._next_try: dict[tuple[int, int], float] = {}
        self.n_sweeps = 0
        self.n_repaired = 0
        self.n_failed = 0
        self.last_rebuild: Optional[tuple] = None

    # -- helpers -------------------------------------------------------------
    def _fault(self, point: str) -> None:
        if self.fault_hook is not None:
            self.fault_hook(point)

    def _event(self, name: str, **kw) -> None:
        # registry.event auto-increments the matching ``{name}_total``
        # counter, so the repair_* counters ride the events
        if self.metrics is not None:
            self.metrics.event(name, **kw)

    def _under_repair(self, shard: int, val: float) -> None:
        if self.metrics is not None:
            self.metrics.gauge("shard_under_repair", {"shard": shard}).set(val)

    # -- scheduling ----------------------------------------------------------
    def pending(self) -> list[tuple[int, int]]:
        """Dead (shard, replica) slots, coverage holes first: a shard with
        NO live replica is a correctness gap (results are missing rows), a
        dead replica of a covered shard only costs redundancy."""
        reg = self.registry
        dead = [(s, r) for s in range(reg.n_shards)
                for r in range(reg.n_replicas) if not reg._live[s, r]]
        return sorted(dead, key=lambda sr: (bool(reg._live[sr[0]].any()),
                                            sr[0], sr[1]))

    def sweep(self, now: Optional[float] = None) -> list[RepairOutcome]:
        """One repair sweep: attempt up to ``budget_per_sweep`` repairs on
        dead slots whose backoff window has passed."""
        now = self.clock() if now is None else now
        self.n_sweeps += 1
        budget = self.config.budget_per_sweep
        outcomes: list[RepairOutcome] = []
        for s, r in self.pending():
            if budget <= 0:
                break
            if self._next_try.get((s, r), -np.inf) > now:
                continue    # still backing off
            budget -= 1
            outcomes.append(self._repair(s, r, now))
        return outcomes

    # -- one repair ----------------------------------------------------------
    def _repair(self, s: int, r: int, now: float) -> RepairOutcome:
        attempt = self._attempts.get((s, r), 0) + 1
        self._attempts[(s, r)] = attempt
        self._under_repair(s, 1.0)
        self._event("repair_started", shard=s, replica=r, attempt=attempt)
        t0 = self.clock()

        # contained phase: any failure here leaves serving untouched
        try:
            self._fault("load_source")
            rows, n_real = self.store.load_shard(s)
            self._fault("rebuild")
            local = build_shard(rows, s, self.store.params,
                                self.store.quantized, self.store.seed,
                                self.get_sidx().device)
            self.last_rebuild = (s, r, local)
            self._verify(local, s)
            slot = s * self.registry.n_replicas + r
            candidate = install_slot(self.get_sidx(), slot, local)
            self._spot_check(candidate, slot, rows, n_real)
        except Exception as e:  # noqa: BLE001 — contained by design
            self.n_failed += 1
            delay = min(self.config.backoff_s * 2.0 ** (attempt - 1),
                        self.config.backoff_cap_s)
            self._next_try[(s, r)] = now + delay
            self._event("repair_failed", shard=s, replica=r, attempt=attempt,
                        error=f"{type(e).__name__}: {e}", retry_in_s=delay)
            return RepairOutcome(shard=s, replica=r, status="failed",
                                 attempt=attempt,
                                 duration_s=self.clock() - t0,
                                 error=f"{type(e).__name__}: {e}")

        # install phase: NOT contained — a raising fault hook here simulates
        # a crash; the mask flips only after the verified install lands
        self._fault("before_install")
        self.set_sidx(candidate)
        self._fault("mid_install")
        self.registry.mark_live(s, r)
        self._fault("after_install")

        dur = self.clock() - t0
        self.n_repaired += 1
        self._attempts.pop((s, r), None)
        self._next_try.pop((s, r), None)
        self._under_repair(s, 0.0)
        if self.metrics is not None:
            self.metrics.histogram("repair_duration_seconds").observe(dur)
        self._event("repair_succeeded", shard=s, replica=r, attempt=attempt,
                    duration_s=dur)
        return RepairOutcome(shard=s, replica=r, status="succeeded",
                             attempt=attempt, duration_s=dur)

    # -- verification --------------------------------------------------------
    def _verify(self, local, shard: int) -> None:
        graph = local.graph if isinstance(local, EMQGIndex) else local
        report = audit(graph, sample=self.config.audit_sample, seed=0)
        if not report.ok:
            raise RepairError(
                f"shard {shard}: rebuilt graph failed audit: "
                f"{report.violations}")

    def _spot_check(self, candidate: ShardedIndex, slot: int,
                    rows: np.ndarray, n_real: int) -> None:
        """host_reference_merge restricted to the candidate slot: returned
        ids must be valid global ids, and self-probes (queries that ARE
        stored rows) must find their own row at distance ~0."""
        if n_real <= 0:
            return                          # a rowless slot serves nothing
        reg = ShardHealthRegistry(self.registry.n_shards,
                                  self.registry.n_replicas,
                                  clock=self.clock)
        reg._live[:] = False
        reg._live[slot // reg.n_replicas, slot % reg.n_replicas] = True
        m = min(self.config.probe_queries, n_real)
        queries = rows[:m]
        params = self.probe_params or SearchParams(k=1, l0=16, l_max=32,
                                                   adaptive=False)
        ids, dists = host_reference_merge(candidate, reg, queries, params,
                                          quantized=self.store.quantized)
        valid = ids >= 0
        if (ids[valid] >= candidate.n_total).any():
            raise RepairError(
                f"slot {slot}: spot-check leaked a global id >= "
                f"{candidate.n_total}")
        if not np.isfinite(dists[valid]).all():
            raise RepairError(f"slot {slot}: non-finite distance on a "
                              "returned id")
        offset = candidate.offsets[slot]
        expect = offset + np.arange(m)      # probes are the shard's own rows
        hit = (ids[:, 0] == expect) & (dists[:, 0] <= 1e-4)
        if hit.mean() < self.config.probe_self_tol:
            raise RepairError(
                f"slot {slot}: only {int(hit.sum())}/{m} self-probes found "
                "their own row")
