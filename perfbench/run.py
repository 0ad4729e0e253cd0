"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 perfbench/run.py --workload synth-d128.batch --seed 7 --seconds 10 \
        --trace 0

From the root of a checkout that holds the port (``src/repro_torch``), on a
machine with as many CUDA cards as the cell asks for.  It sets the cell up
(inputs and weights from ``--seed``, the index built by the port), warms
it up, measures ``--seconds`` of back-to-back calls, checks every answer
against the plain reference under ``perfbench/configs`` and prints one
JSON line: the end-to-end metrics with ``--trace 0``, the per-layer
metrics of one more call traced by ``torch.profiler`` with ``--trace 1``.
The numbers the check compared are the last lines on standard error and
the line's last key.  The kernels build into ``build/`` of the checkout.

Exit codes: 0 with a result; 2 for a checkout without the port or a cell
that is not there; 3 without the cards the cell needs; 4 when JAX or the
JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def _env() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" /
                                             "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = _args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"perfbench: no port at {ROOT / 'src' / 'repro_torch'}",
              file=sys.stderr)
        return 2
    _env()
    sys.path.insert(0, str(BENCH))
    sys.path.insert(0, str(ROOT / "src"))
    from pbench.cell import Cell, forbidden_modules, run_cell

    try:
        cell = Cell(args.workload)
    except (KeyError, FileNotFoundError) as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    import torch
    need = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {cell.name} needs {need} CUDA card(s), found "
              f"{have}", file=sys.stderr)
        return 3

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    line = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                    T_START, log=log)
    found = forbidden_modules()
    if found:
        print(f"perfbench: loaded {found}: the port's run must not load JAX "
              "or the JAX package", file=sys.stderr)
        return 4
    for name, c in line["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAILED"
        log(f"check {name} = {c['value']!r} (limit {c['limit']!r}) {ok}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
