"""The paper's technique inside a recommender, on the PyTorch port: train a
small MIND model on synthetic click logs, then serve
`retrieval_cand`-style queries two ways — exact brute-force scoring vs
the δ-EMQG index over the learned item embeddings — and compare recall +
distance budget.

    PYTHONPATH=src python examples/torch_recsys_retrieval.py          # the card
    PYTHONPATH=src python examples/torch_recsys_retrieval.py --device cpu

Counterpart of ``examples/recsys_retrieval.py``: the same model sizes,
data, optimizer and index parameters.  ``--steps`` (default the
reference's 200) shortens the training.  Without a card it raises unless
given ``--device cpu``.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.core import (BuildParams, build_emqg,
                              error_bounded_probing_search)
from repro_torch.core.types import resolve_device
from repro_torch.data import recsys_seq_batch
from repro_torch.models import recsys as rs
from repro_torch.optim import OptConfig
from repro_torch.train import TrainState, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = rs.MINDConfig(name="mind-demo", n_items=8192, embed_dim=32,
                        n_interests=4, routing_iters=3, seq_len=24, n_neg=16)
    params = rs.mind_init(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev)
    opt = OptConfig(lr=3e-3, total_steps=200, warmup_steps=10)
    step_fn = make_train_step(lambda p, b: rs.mind_loss(cfg, p, b), opt)
    state = TrainState.create(params, opt)

    print("training MIND on planted-interest click logs…")
    last = args.steps - 1
    for s in range(args.steps):
        raw = recsys_seq_batch(64, step=s, n_items=cfg.n_items,
                               seq_len=cfg.seq_len, n_neg=cfg.n_neg)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()
                 if k in ("hist_items", "hist_mask", "target_item",
                          "neg_items")}
        state, m = step_fn(state, batch)
        if s % 50 == 0 or s == last:
            print(f"  step {s}: loss={float(m['loss']):.3f} "
                  f"acc={float(m['acc']):.3f}")

    params = state.params
    k = 50
    raw = recsys_seq_batch(16, step=9999, n_items=cfg.n_items,
                           seq_len=cfg.seq_len, n_neg=cfg.n_neg)
    hist = torch.from_numpy(raw["hist_items"]).to(dev)
    mask = torch.from_numpy(raw["hist_mask"]).to(dev)
    cand = torch.arange(cfg.n_items, dtype=torch.int32, device=dev)

    # (a) exact: score every item (the retrieval_cand cell's function)
    t0 = time.time()
    with torch.no_grad():
        _, ids_e = rs.mind_retrieval(cfg, params, hist, mask, cand, k=k)
    ids_e = ids_e.cpu().numpy()
    print(f"exact scoring of {cfg.n_items} items: {time.time() - t0:.2f}s")

    # (b) the paper: δ-EMQG over the learned item-embedding table
    item_table = params["item_emb"].detach().cpu().numpy()
    t0 = time.time()
    idx = build_emqg(item_table, BuildParams(max_degree=24, beam_width=64,
                                             t=32, iters=2, block=1024,
                                             align_degree=True), device=dev)
    print(f"δ-EMQG build over item table: {time.time() - t0:.1f}s")
    with torch.no_grad():
        caps = rs.mind_user_interests(cfg, params, hist, mask)
    caps = caps.detach()
    flat_q = caps.reshape(-1, cfg.embed_dim)
    res = error_bounded_probing_search(idx, flat_q, k=k, alpha=1.2,
                                       l_max=256)
    per_int = res.ids.cpu().numpy().reshape(16, cfg.n_interests, k)
    caps = caps.cpu().numpy()

    recalls = []
    for b in range(16):
        got_ids = np.unique(per_int[b].ravel())
        scores = caps[b] @ item_table[got_ids].T
        top = got_ids[np.argsort(-scores.max(0))[:k]]
        recalls.append(len(set(top.tolist()) & set(ids_e[b].tolist())) / k)
    recall = float(np.mean(recalls))
    print(f"δ-EMQG retrieval recall@{k} vs exact: {recall:.3f}")
    print(f"distance budget: "
          f"{float(res.n_dist_comps.float().mean()):.0f} exact + "
          f"{float(res.n_approx_comps.float().mean()):.0f} approx "
          f"per interest-query, vs {cfg.n_items} exact per user brute-force")
    return dict(loss=float(m["loss"]), recall=recall)


if __name__ == "__main__":
    main()
