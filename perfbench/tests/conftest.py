"""Shared set-up of the benchmark's own tests (run them with
``python -m pytest -q perfbench/tests``; the repository's test run does
not collect them).  They run on the CPU at tiny sizes; tests marked
``cuda`` need the card and skip here."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

# sizes a CPU holds in seconds, and the limits of the numbers that depend
# on the size (a recall's miss, read at these sizes); every other key of a
# configuration as it is
TINY = {
    "synth-d128": {"n": 1500, "dim": 32, "warmup_queries": 8,
                   "build": {"max_degree": 16, "beam_width": 32, "t": 8,
                             "iters": 2, "align_degree": True,
                             "max_hops": 256, "block": 1500},
                   "search": {"k": 10, "l0": 10, "l_max": 64, "alpha": 1.2,
                              "adaptive": True, "max_hops": 512},
                   "limits": {"recall_miss": 0.3, "graph_miss": 0.05}},
}
TINY_TRAFFIC = {"batch": {"queries_per_call": 48}}


def make_tiny(dst: Path) -> Path:
    """A copy of the benchmark under ``dst`` with every configuration and
    traffic cut to ``TINY``; returns its ``perfbench`` directory."""
    shutil.copytree(BENCH, dst / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    for name, cut in TINY.items():
        path = dst / "perfbench" / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cfg.update({k: v for k, v in cut.items() if k != "limits"})
        cfg["limits"].update(cut.get("limits", {}))
        path.write_text(json.dumps(cfg))
    for name, cut in TINY_TRAFFIC.items():
        path = dst / "perfbench" / "traffic" / f"{name}.json"
        path.write_text(json.dumps({**json.loads(path.read_text()), **cut}))
    return dst / "perfbench"


@pytest.fixture(scope="session")
def tiny_bench(tmp_path_factory) -> Path:
    return make_tiny(tmp_path_factory.mktemp("tiny"))


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"
