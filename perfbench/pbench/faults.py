"""Faults planted in the timed path, to read what the check makes of
them: ``calibrate.py --faults`` reads them on the card at a cell's own
size, and ``tests/test_perfbench_control.py`` on the CPU.  The benchmark's
own runs never plant one.

Loop faults replace the port's lock-step probing loop
(``core.probing._beam_probing_batch``, also bound in ``core.distributed``)
while a block runs:

* ``unchanged``: the loop returns its start (no hop);
* ``half_stopped``: the second half of the batch stops after
  ``STOP_HOPS`` hops, the first half searches in full;
* ``zero_estimates``: the RaBitQ estimates all read 0;
* ``altered``: every exact distance off by 0.1%.

Graph faults change the snapshot of the built graph that the check reads:
``shuffled`` gives each node another node's adjacency row, ``truncated``
keeps the first half of each row (as a build whose degree alignment was
skipped leaves rows short).
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib

import torch

LOOP_FAULTS = ("unchanged", "half_stopped", "zero_estimates", "altered")
GRAPH_FAULTS = ("shuffled", "truncated")
STOP_HOPS = 4
_HOMES = ("repro_torch.core.probing", "repro_torch.core.distributed")


def _faulty(loop, kind: str):
    def run(neighbors, n_nodes, batch_exact, batch_approx, queries, start,
            p, seen_base=None):
        if kind == "unchanged":
            return loop(neighbors, n_nodes, batch_exact, batch_approx,
                        queries, start, dataclasses.replace(p, max_hops=0),
                        seen_base)
        if kind == "zero_estimates":
            approx = batch_approx
            batch_approx = lambda ids: torch.zeros_like(approx(ids))  # noqa
        if kind == "altered":
            exact = batch_exact
            batch_exact = lambda q, ids: exact(q, ids) * 1.001  # noqa
        st = loop(neighbors, n_nodes, batch_exact, batch_approx, queries,
                  start, p, seen_base)
        if kind == "half_stopped":
            short = loop(neighbors, n_nodes, batch_exact, batch_approx,
                         queries, start,
                         dataclasses.replace(p, max_hops=STOP_HOPS),
                         seen_base)
            h = queries.shape[0] // 2
            st = type(st)(*[torch.cat([a[:h], b[h:]])
                            for a, b in zip(st, short)])
        return st
    return run


@contextlib.contextmanager
def loop_fault(kind: str):
    """The port's probing loop with ``kind`` planted, in every module that
    binds it."""
    if kind not in LOOP_FAULTS:
        raise ValueError(f"no loop fault {kind!r}")
    mods = [importlib.import_module(m) for m in _HOMES]
    original = mods[0]._beam_probing_batch
    try:
        for m in mods:
            m._beam_probing_batch = _faulty(original, kind)
        yield
    finally:
        for m in mods:
            m._beam_probing_batch = original


def graph_fault(snap: dict, kind: str, seed: int) -> dict:
    """A copy of the snapshot with ``kind`` planted in its graph."""
    if kind not in GRAPH_FAULTS:
        raise ValueError(f"no graph fault {kind!r}")
    nb = snap["neighbors"]
    if kind == "truncated":
        cut = nb.clone()
        cut[:, nb.shape[1] // 2:] = -1
        return {**snap, "neighbors": cut}
    perm = torch.randperm(nb.shape[0],
                          generator=torch.Generator().manual_seed(seed))
    return {**snap, "neighbors": nb[perm]}
