"""The port's kernel launches, as the harness reads them: the launch
counter of its RaBitQ estimate, and the bytes each launch of a call needs,
counted at the port's kernel entry points.

A roofline reader names the entry point it counts (``HOOK``: a module of
the port and a function in it) and how many bytes one launch needs from
its arguments (``launch_bytes``).  ``counting`` replaces each named
function by a wrapper that adds those bytes up while a call runs and puts
the originals back after it.  It is used on a second replay of the
window's first call, with the profiler off, so that counting (which reads
the ids back to the host) takes nothing from the timed or the traced call;
the search is deterministic, so both replays make the same launches, and a
reader whose launch count differs from the trace's reports nothing.
"""

from __future__ import annotations

import contextlib
import importlib


def sync(device) -> None:
    """Wait for the card (nothing to wait for on the CPU)."""
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def fused_estimate_launches() -> int:
    """The port's count of ``fused_estimate`` launches: one a lock-step
    iteration of the probing loop."""
    from repro_torch.kernels.bitdot import ops as bitdot_ops
    return bitdot_ops.LAUNCHES["fused_estimate"]


@contextlib.contextmanager
def counting(readers: dict):
    """``readers``: {metric name: module with ``HOOK`` and
    ``launch_bytes``}.  Yields {metric name: [bytes, launches]}, filled as
    the hooked functions run."""
    totals = {name: [0.0, 0] for name in readers}
    patched = []
    try:
        for name, mod in readers.items():
            target = importlib.import_module(mod.HOOK[0])
            original = getattr(target, mod.HOOK[1])

            def wrapper(*args, _orig=original, _mod=mod, _tot=totals[name],
                        **kwargs):
                nbytes = _mod.launch_bytes(*args, **kwargs)
                if nbytes:
                    _tot[0] += nbytes
                    _tot[1] += 1
                return _orig(*args, **kwargs)

            setattr(target, mod.HOOK[1], wrapper)
            patched.append((target, mod.HOOK[1], original))
        yield totals
    finally:
        for target, attr, original in reversed(patched):
            setattr(target, attr, original)


def distinct_rows(ids) -> int:
    """Rows of a base table a launch reads at least once: the distinct
    non-negative ids (negative ids are padding and read nothing)."""
    import torch
    valid = ids[ids >= 0]
    if valid.numel() == 0:
        return 0
    return int(torch.unique(valid).numel())


def rows_with_work(ids) -> int:
    """Query rows with at least one valid id: the rows whose query data a
    launch needs."""
    return int((ids >= 0).any(dim=1).sum())
