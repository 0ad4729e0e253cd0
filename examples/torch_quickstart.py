"""Quickstart on the PyTorch port: build a δ-EMG, run the error-bounded
search, check the bound.

    PYTHONPATH=src python examples/torch_quickstart.py              # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

Counterpart of ``examples/quickstart.py``: the same corpus, seeds and
parameters on ``repro_torch``, which imports neither JAX nor ``repro``.
Without a card it raises unless given ``--device cpu``.  ``--n`` shrinks
the corpus (default the reference's 4,000).
"""

import argparse

import numpy as np
import torch

from repro_torch.core import (
    BuildParams,
    SearchParams,
    build_approx,
    error_bounded_search,
    search,
    theorem4_delta_prime,
)
from repro_torch.core.distances import brute_force_knn
from repro_torch.core.types import resolve_device
from repro_torch.data import clustered_vectors


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. a SIFT-like corpus (synthetic — no download)
    base = clustered_vectors(n=args.n, dim=48, n_clusters=48, seed=0)
    queries = clustered_vectors(n=64, dim=48, n_clusters=48, seed=1)
    q = torch.as_tensor(queries, device=dev)

    # 2. build the approximate δ-EMG (Algorithm 4)
    graph = build_approx(base, BuildParams(
        max_degree=24,   # M
        beam_width=64,   # L
        t=32,            # adaptive-δ neighborhood scale
        iters=3,
    ), verbose=True, device=dev)
    print(f"mean out-degree: {float(graph.degrees().float().mean()):.1f}")

    # 3. error-bounded top-k search (Algorithm 3) — α controls the bound
    res = error_bounded_search(graph, q, k=10, alpha=1.5, l_max=192)

    gt_d, gt_i = brute_force_knn(q, graph.vectors, 10)
    ids, gt_i = res.ids.cpu().numpy(), gt_i.cpu().numpy()
    gt_d = gt_d.cpu().numpy()
    recall = np.mean([len(set(ids[i].tolist()) & set(gt_i[i].tolist())) / 10
                      for i in range(len(queries))])
    rde = float(np.mean((res.dists.cpu().numpy() - gt_d)
                        / np.maximum(gt_d, 1e-9)))
    print(f"recall@10 = {recall:.4f}   relative-distance-error = {rde:.2e}")
    print(f"mean distance computations / query = "
          f"{float(res.n_dist_comps.float().mean()):.0f} "
          f"(vs {len(base)} brute force)")

    # 4. the error-bounded certificate (Theorem 4)
    p = SearchParams(k=10, l0=10, l_max=192, alpha=1.5, adaptive=True,
                     max_hops=2048)
    _, cand_ids, cand_dists = search(graph, q, p, with_candidates=True)
    found, dprime = theorem4_delta_prime(graph, q, cand_ids, cand_dists,
                                         k=10, delta=0.05)
    print(f"local-optimum certificate found for "
          f"{float(found.float().mean()) * 100:.0f}% of queries; mean "
          f"certified δ' = {float(dprime[found].mean()):.4f}")
    return dict(recall=float(recall), rde=rde,
                certified=float(found.float().mean()))


if __name__ == "__main__":
    main()
