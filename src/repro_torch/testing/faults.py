"""Deterministic fault injection for the port's serve and checkpoint stack.

Counterpart of the single-node parts of ``repro.testing.faults`` (numpy
only), so the port's fault suites import nothing of the JAX package.  Each
fault is deterministic and seedable:

* **Search faults** — ``inject_search_faults`` wraps a server's
  ``_search`` seam with a ``FaultPlan``: raise ``KernelFault`` on chosen
  calls (optionally only for a given backend tier, which is how a
  "CUDA kernel is broken" scenario is staged)
  and/or add latency spikes.
* **Checkpoint corruption** — ``flip_bits`` (raw bit flips anywhere in a
  file, e.g. ``arrays.npz``), ``tamper_array`` (perturb one stored array
  while keeping the manifest byte-identical → exercises checksum
  verification specifically), ``tear_checkpoint`` (drop the manifest →
  invalid step), ``make_torn_tmp`` (a ``.tmp`` directory as left by a
  process killed mid-save).
* **WAL crash points** — ``crash_at(point)`` builds the ``fault_hook`` a
  ``JournaledLiveIndex`` accepts: raise ``SimulatedCrash`` at a named
  protocol point (``before_journal`` / ``torn_journal`` / ``after_journal``
  / ``mid_splice``), optionally only on the Nth visit.  ``torn_wal_record``
  tears an already-committed record post-hoc (truncated payload +
  checksum-stale manifest) — the shape a crash during a *later* append
  leaves behind.

The shard-death and shard-repair faults come with the sharded index
(ROADMAP A.6).  Nothing here is imported by production code paths —
faults flow only test → harness → server seam.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional

import numpy as np


class KernelFault(RuntimeError):
    """Injected stand-in for an accelerator kernel failure."""


@dataclasses.dataclass
class FaultPlan:
    """Deterministic schedule of faults on the search seam.

    ``fail_first`` fails the first N *matching* calls (matching = the
    backend and beam-width filters, when set); ``fail_calls`` additionally fails
    those matching-call indices (0-based).  ``latency_s`` sleeps before
    every matching call (``latency_calls`` restricts it to given indices).
    """

    fail_first: int = 0
    fail_calls: tuple[int, ...] = ()
    match_backend: Optional[str] = None     # None → any backend
    match_min_beam_width: Optional[int] = None  # only calls with W ≥ this
    exc_type: type = KernelFault
    latency_s: float = 0.0
    latency_calls: Optional[tuple[int, ...]] = None   # None → every call

    def should_fail(self, match_idx: int) -> bool:
        return match_idx < self.fail_first or match_idx in self.fail_calls

    def delay_for(self, match_idx: int) -> float:
        if self.latency_s <= 0:
            return 0.0
        if self.latency_calls is not None and match_idx not in self.latency_calls:
            return 0.0
        return self.latency_s


class inject_search_faults:
    """Context manager wrapping ``server._search`` with a ``FaultPlan``.

    Counts calls (total and plan-matching) for assertions, and records the
    ``(backend, beam_width)`` tier of *every* call in ``tier_log`` so
    tests can assert the exact fallback ladder a fault sequence walked —
    e.g. that the circuit breaker bottoms out at ``("jnp", 1)`` on the
    CPU::

        with inject_search_faults(srv, FaultPlan(fail_first=2)) as inj:
            srv.submit_many(queries)
            responses = srv.drain()
        assert inj.n_failed == 2
        assert inj.tier_log[-1] == ("jnp", 1)
    """

    def __init__(self, server, plan: FaultPlan):
        self.server = server
        self.plan = plan
        self.n_calls = 0
        self.n_matched = 0
        self.n_failed = 0
        self.tier_log: list[tuple] = []   # (backend, beam_width)
        self._orig = None

    def _matches(self, backend: str,
                 beam_width: Optional[int] = None) -> bool:
        p = self.plan
        if p.match_backend is not None and backend != p.match_backend:
            return False
        if (p.match_min_beam_width is not None and beam_width is not None
                and beam_width < p.match_min_beam_width):
            return False
        return True

    def __enter__(self):
        self._orig = self.server._search
        plan = self.plan

        def wrapped(queries, params=None, backend=None):
            self.n_calls += 1
            bck = backend if backend is not None else self.server.backend
            p = params if params is not None else self.server.params
            self.tier_log.append((bck, getattr(p, "beam_width", None)))
            if self._matches(bck, getattr(p, "beam_width", None)):
                idx = self.n_matched
                self.n_matched += 1
                delay = plan.delay_for(idx)
                if delay > 0:
                    time.sleep(delay)
                if plan.should_fail(idx):
                    self.n_failed += 1
                    raise plan.exc_type(
                        f"injected fault #{idx} on tier beam/{bck}")
            return self._orig(queries, params=params, backend=backend)

        self.server._search = wrapped
        return self

    def __exit__(self, *exc):
        self.server._search = self._orig
        return False


# ---------------------------------------------------------------------------
# Checkpoint corruption.
# ---------------------------------------------------------------------------


def flip_bits(path: str, n_bits: int = 8, seed: int = 0) -> list[int]:
    """Flip ``n_bits`` deterministic bits in a file; returns byte offsets.

    Offsets are drawn from the middle half of the file so small files keep
    their zip local headers intact more often than not — but any outcome
    (unreadable archive, checksum mismatch, silent data change) must be
    contained by the restore walk-back, so callers should assert on the
    *recovery*, not on which layer caught it.
    """
    rng = np.random.default_rng(seed)
    with open(path, "rb") as f:
        data = bytearray(f.read())
    if not data:
        raise ValueError(f"cannot flip bits in empty file: {path}")
    lo, hi = len(data) // 4, max(len(data) // 4 + 1, 3 * len(data) // 4)
    offsets = sorted(int(o) for o in rng.integers(lo, hi, size=n_bits))
    for off in offsets:
        data[off] ^= 1 << int(rng.integers(0, 8))
    with open(path, "wb") as f:
        f.write(bytes(data))
    return offsets


def tamper_array(step_dir: str, key: Optional[str] = None,
                 amount: float = 1.0) -> str:
    """Perturb one array inside ``arrays.npz``, leaving the manifest (and
    therefore its recorded checksums) untouched — the restore path must
    catch this via checksum verification, not via a load error.  Returns
    the tampered key."""
    npz = os.path.join(step_dir, "arrays.npz")
    with np.load(npz) as z:
        flat = {k: z[k].copy() for k in z.files}
    if key is None:
        key = sorted(flat.keys())[0]
    arr = flat[key]
    if arr.size == 0:
        raise ValueError(f"array {key!r} is empty, nothing to tamper")
    if np.issubdtype(arr.dtype, np.floating):
        arr.flat[arr.size // 2] += amount
    else:
        arr.flat[arr.size // 2] ^= 1
    np.savez(npz, **flat)
    return key


def tear_checkpoint(step_dir: str) -> None:
    """Invalidate a committed checkpoint the way a torn write would:
    remove its manifest (a step without a readable manifest is never
    listed as restorable)."""
    os.remove(os.path.join(step_dir, "manifest.json"))


def make_torn_tmp(directory: str, step: int) -> str:
    """Recreate the on-disk state of a process killed mid-save: a
    ``step_XXXXXXXXX.tmp`` directory holding a partial manifest and a
    truncated ``arrays.npz``.  The next committed save must prune it and
    ``restore_latest`` must never consider it."""
    tmp = os.path.join(directory, f"step_{step:09d}.tmp")
    os.makedirs(tmp, exist_ok=True)
    with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
        f.write(b"PK\x03\x04truncated-mid-write")
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        f.write(json.dumps({"step": step})[:-5])    # torn JSON
    return tmp


# ---------------------------------------------------------------------------
# WAL crash points (streaming-update journal).
# ---------------------------------------------------------------------------


class SimulatedCrash(RuntimeError):
    """Raised by a crash hook — models the process dying at that point."""


def crash_at(point: str, on_visit: int = 0):
    """Build a ``fault_hook`` that raises ``SimulatedCrash`` the
    ``on_visit``-th time the named protocol point is reached (other points
    pass through).  The hook carries ``.visits`` for assertions."""
    state = {"visits": 0}

    def hook(p: str) -> None:
        if p != point:
            return
        v = state["visits"]
        state["visits"] += 1
        if v == on_visit:
            raise SimulatedCrash(f"crash at {point} (visit {v})")

    hook.point = point
    hook.state = state
    return hook


def torn_wal_record(wal_dir: str, seq: int, mode: str = "truncate") -> None:
    """Corrupt an already-committed WAL record post-hoc.

    ``mode="truncate"`` halves the payload npz (unreadable archive);
    ``mode="checksum"`` rewrites the payload with one element perturbed
    while the manifest keeps the stale CRC.  Either way ``wal_read`` must
    raise ``WalCorruptError`` and replay must stop *before* this record.
    """
    base = os.path.join(wal_dir, f"wal_{seq:09d}")
    npz = base + ".npz"
    if mode == "truncate":
        with open(npz, "rb") as f:
            data = f.read()
        with open(npz, "wb") as f:
            f.write(data[: max(1, len(data) // 2)])
    elif mode == "checksum":
        with np.load(npz) as z:
            flat = {k: z[k].copy() for k in z.files}
        key = sorted(flat)[0]
        arr = flat[key]
        if arr.size == 0:
            raise ValueError(f"array {key!r} empty, nothing to perturb")
        if np.issubdtype(arr.dtype, np.floating):
            arr.flat[0] += 1.0
        else:
            arr.flat[0] ^= 1
        np.savez(npz, **flat)
    else:
        raise ValueError(f"unknown mode: {mode!r}")
