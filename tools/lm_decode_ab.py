#!/usr/bin/env python3
"""Greedy decode speed of ``chip_smoke.py``'s LM on the card, this tree's
``repro_torch`` against another tree's, on the same weights.

    OLD=2f0bd2f; mkdir -p build/ab/lm_old
    git archive $OLD | tar -x -C build/ab/lm_old
    python3 tools/lm_decode_ab.py --old build/ab/lm_old

Ten pairs, one process a pair.  Each process imports both trees'
``repro_torch`` (the first one's modules dropped from ``sys.modules``
before the second is imported), builds this tree's ``chip_smoke.LM_ARCH``
(smollm-135m) in bf16 from seed 0 on the card once, and runs each tree's
``serve.generate`` on those weights, on Markov prompts of
``chip_smoke.LM_GEN``'s shape (8 × (128 + 32)): old, new, new, old in even
pairs and new, old, old, new in odd ones, after one warm-up call each.  So
the device work is the same and only the host code differs, and a
process's start and its card's state, which move a run by ~10%, fall on
both trees alike.  A run's rate is batch × (prompt + max_new − 1) decode
steps over the host clock around a synchronised call.  Each process prints
one JSON line with each tree's rates; the two trees' tokens must be equal.
No kernel is built: decode attention is plain PyTorch.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PAIRS = 10


def _import_tree(tree: Path, arch: str):
    """(the arch's config, generate) of the tree's ``repro_torch``; the
    config is made here, while the tree's modules are the ones imported
    (``get_arch`` imports its config module by name)."""
    for name in [m for m in sys.modules
                 if m == "repro_torch" or m.startswith("repro_torch.")]:
        del sys.modules[name]
    sys.path.insert(0, str(tree / "src"))
    try:
        from repro_torch.configs import get_arch
        from repro_torch.serve import generate
        return get_arch(arch).model_cfg, generate
    finally:
        sys.path.remove(str(tree / "src"))


def run_pair(old: Path, old_first: bool) -> None:
    sys.path.insert(0, str(ROOT))
    from chip_smoke import LM_ARCH, LM_GEN
    import torch

    trees = {"old": _import_tree(old, LM_ARCH),
             "new": _import_tree(ROOT, LM_ARCH)}
    from repro_torch.data import lm_batch, make_markov_lm
    from repro_torch.models import transformer as tf

    B, P, new = LM_GEN["batch"], LM_GEN["prompt"], LM_GEN["max_new"]
    cfg = trees["new"][0]
    params = tf.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                     device="cuda")
    lm = make_markov_lm(cfg.vocab, seed=0)
    prompts = torch.from_numpy(lm_batch(lm, B, P, step=2)[0]).cuda()

    def run(tag):
        tree_cfg, generate = trees[tag]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = generate(tree_cfg, params, prompts, max_new=new,
                       max_seq=LM_GEN["max_seq"])
        torch.cuda.synchronize()
        return out, B * (P + new - 1) / (time.perf_counter() - t0)

    toks = {tag: run(tag)[0] for tag in trees}          # warm-up
    if not torch.equal(toks["old"], toks["new"]):
        raise SystemExit("the two trees' greedy tokens differ")
    order = ("old", "new", "new", "old") if old_first else \
        ("new", "old", "old", "new")
    rates = {"old": [], "new": []}
    for tag in order:
        rates[tag].append(run(tag)[1])
    print(json.dumps({"order": order, "decode_tok_s": rates,
                      "card": torch.cuda.get_device_name(0)}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", type=Path, help="the other tree's root")
    ap.add_argument("--first", choices=("old", "new"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    old = args.old.resolve()
    if args.first is not None:
        run_pair(old, args.first == "old")
        return 0
    for i in range(PAIRS):
        subprocess.run([sys.executable, __file__, "--old", str(old),
                        "--first", "old" if i % 2 == 0 else "new"],
                       check=True, timeout=600)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
