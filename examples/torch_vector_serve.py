"""End-to-end ANN *serving* example on the PyTorch port (the paper's system
in its deployment shape): δ-EMQG + RaBitQ + probing search behind a
batched request queue, then the sharded variant of the same index.

    PYTHONPATH=src python examples/torch_vector_serve.py              # the card
    PYTHONPATH=src python examples/torch_vector_serve.py --device cpu

Counterpart of ``examples/vector_serve.py``, same corpus, seeds and
parameters.  The reference runs its sharded variant in a subprocess that
fakes 8 XLA devices; here the 4 shards are slots of one
``ShardedIndex`` on the one device, searched by the single controller
(``make_sharded_search``), in this process.  Without a card it raises
unless given ``--device cpu``.  ``--n`` shrinks the corpus (default the
reference's 4,000).
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.core import BuildParams, SearchParams, build_emqg
from repro_torch.core.distances import brute_force_knn
from repro_torch.core.distributed import build_sharded, make_sharded_search
from repro_torch.core.types import resolve_device
from repro_torch.data import clustered_vectors
from repro_torch.serve import AnnServer


def _recall(ids, gt_i, k):
    return float(np.mean([len(set(ids[i].tolist()) & set(gt_i[i].tolist()))
                          / k for i in range(len(ids))]))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    n, dim, k = args.n, 48, 10
    build = BuildParams(max_degree=24, beam_width=64, t=32, iters=2,
                        block=1024, align_degree=True)
    params = SearchParams(k=k, l0=k, l_max=192, alpha=1.3, adaptive=True,
                          max_hops=2048)
    base = clustered_vectors(n, dim, 48, seed=0)
    queries = clustered_vectors(300, dim, 48, seed=1)
    _, gt_i = brute_force_knn(torch.as_tensor(queries, device=dev),
                              torch.as_tensor(base, device=dev), k)
    gt_i = gt_i.cpu().numpy()

    print("building δ-EMQG (RaBitQ codes + degree-aligned graph)…")
    t0 = time.time()
    idx = build_emqg(base, build, device=dev)
    print(f"  built in {time.time() - t0:.1f}s; code compression = "
          f"{base.nbytes / (idx.codes.codes.numel() * 4):.0f}×")

    srv = AnnServer(idx, params, max_batch=64, buckets=(16, 64), device=dev)
    srv.submit_many(queries)
    out = srv.drain()
    ids = np.stack([r[0] for r in out])
    rec = _recall(ids, gt_i, k)
    print(f"served {srv.stats.n_requests} requests in {srv.stats.n_batches} "
          f"batches → recall@{k}={rec:.3f}, QPS={srv.stats.qps:.0f} "
          f"({dev.type})")

    # ---- the sharded variant: 4 shards, one device, one controller ----
    print("\nsharded serving (4 shards on one device)…")
    sidx = build_sharded(base, 4, build, quantized=True, device=dev)
    run = make_sharded_search(merge="all_gather", quantized=True)
    s_ids, _ = run(sidx, queries, params)
    s_rec = _recall(s_ids.cpu().numpy(), gt_i, k)
    print(f"  4-shard sharded index recall@10 = {s_rec:.3f}")
    return dict(recall=rec, qps=srv.stats.qps, sharded_recall=s_rec)


if __name__ == "__main__":
    main()
