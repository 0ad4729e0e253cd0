#!/usr/bin/env python3
"""Why a shard of the sharded δ-EMQG cannot self-heal at scale: build
shards on one card and report what the repair gate sees.

    python3 tools/shard_survey.py [--n 200000] [--shards 4]

For each corpus (``clustered_vectors`` at the repo's cluster scale 0.35
and at 1.0, and standard-normal rows, all d = 128, seed 0), shards 1 and 2
of the contiguous partition into ``--shards`` are built on the card as
``build_sharded`` builds them (``build_shard``: quantized, ``chip_smoke``'s
``BUILD_PARAMS``, seed 0 + shard).  Each line gives the build seconds, the
nodes its medoid cannot reach (``build_approx._bfs_reachable``) and the
verdict of ``verify.audit`` as ``core.repair``'s gate calls it.  Shard 1 of
the first corpus is built a second time and compared with the first to
the bit: the rebuild a repair installs.  One JSON line per build, after
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--shards", type=int, default=4)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke as cs
    from repro_torch.core import BuildParams
    from repro_torch.core.build_approx import _bfs_reachable
    from repro_torch.core.distributed import build_shard, shard_rows
    from repro_torch.core.verify import audit
    from repro_torch.data import clustered_vectors
    from repro_torch.kernels import _build
    from repro_torch.testing import indexes_equal

    if not torch.cuda.is_available():
        print("shard_survey: needs an NVIDIA card", file=sys.stderr)
        return 3
    _build.build_all()
    print(cs.card_line())
    n, d = args.n, 128
    per = -(-n // args.shards)
    corpora = {
        "clustered_0.35": lambda: clustered_vectors(n, d, 48, seed=0),
        "clustered_1.0": lambda: clustered_vectors(n, d, 48, scale=1.0,
                                                   seed=0),
        "normal": lambda: np.random.default_rng(0).standard_normal(
            (n, d)).astype(np.float32),
    }
    bp = BuildParams(**cs.BUILD_PARAMS)

    def build(rows, shard):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index = build_shard(rows, shard, bp, quantized=True, device="cuda")
        torch.cuda.synchronize()
        return index, time.perf_counter() - t0

    for name, make in corpora.items():
        X = make()
        for shard in (1, 2):
            rows, _ = shard_rows(X, shard, per)
            index, secs = build(rows, shard)
            g = index.graph
            rep = audit(g, sample=16, seed=0)
            row = dict(corpus=name, shard=shard, rows=per, build_s=secs,
                       unreachable=int((~_bfs_reachable(
                           g.neighbors, g.medoid)).sum()),
                       audit_ok=rep.ok, violations=rep.violations[:1])
            if name == "clustered_0.35" and shard == 1:
                again, row["rebuild_s"] = build(rows, shard)
                row["rebuild_bitwise_equal"] = indexes_equal(index, again)
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
