"""The recsys part of the reference's ``repro.launch.steps`` that has a
meaning on one card: each arch's initializer and loss (``_RECSYS_INIT``,
``_RECSYS_LOSS``), the forward its serve cell runs (``_RECSYS_SERVE``,
the function of ``_recsys_serve_cell``), its retrieval over candidates
(``_RECSYS_RETRIEVAL``, ``_recsys_retrieval_cell``'s), the model FLOPs
of B samples (``_recsys_model_flops``), and ``recsys_batch``, a batch of
an arch's serve or train inputs from the synthetic logs.  The rest of
that module lowers XLA dry-run cells for a TPU mesh and is not ported.
"""

from __future__ import annotations

import torch

from ..core.types import resolve_device
from ..data import recsys_ctr_batch, recsys_seq_batch
from ..models import recsys as rs

_RECSYS_LOSS = {
    "fm": lambda cfg, p, b: rs.fm_loss(cfg, p, b),
    "dcn-v2": lambda cfg, p, b: rs.dcn_loss(cfg, p, b),
    "dien": lambda cfg, p, b: rs.dien_loss(cfg, p, b),
    "mind": lambda cfg, p, b: rs.mind_loss(cfg, p, b),
}

_RECSYS_INIT = {
    "fm": rs.fm_init, "dcn-v2": rs.dcn_init, "dien": rs.dien_init,
    "mind": rs.mind_init,
}

# the serve cell's function of (cfg, params, batch): the forward, and for
# MIND the user-interest inference
_RECSYS_SERVE = {
    "fm": lambda cfg, p, b: rs.fm_forward(cfg, p, b["sparse_ids"]),
    "dcn-v2": lambda cfg, p, b: rs.dcn_forward(cfg, p, b["dense"],
                                               b["sparse_ids"]),
    "dien": lambda cfg, p, b: rs.dien_forward(cfg, p, b),
    "mind": lambda cfg, p, b: rs.mind_user_interests(cfg, p, b["hist_items"],
                                                     b["hist_mask"]),
}

# the retrieval cell's function of (cfg, params, user, cand_ids, k), the
# user a one-sample batch of ``recsys_batch``: fm's user fields are sparse
# fields 1.. (the candidate fills field 0), dcn-v2's too with its dense
# features, dien's and mind's the user's history
_RECSYS_RETRIEVAL = {
    "fm": lambda cfg, p, u, c, k: rs.fm_retrieval(
        cfg, p, u["sparse_ids"][:, 1:], c, k=k),
    "dcn-v2": lambda cfg, p, u, c, k: rs.dcn_retrieval(
        cfg, p, u["dense"], u["sparse_ids"][:, 1:], c, k=k),
    "dien": lambda cfg, p, u, c, k: rs.dien_retrieval(cfg, p, u, c, k=k),
    "mind": lambda cfg, p, u, c, k: rs.mind_retrieval(
        cfg, p, u["hist_items"], u["hist_mask"], c, k=k),
}


def _recsys_model_flops(arch, B: int) -> float:
    """The reference's count of the model FLOPs of B samples."""
    cfg = arch.model_cfg
    if arch.id == "fm":
        return B * (2.0 * cfg.n_sparse * cfg.embed_dim * 2)
    if arch.id == "dcn-v2":
        d = cfg.d_input
        mlp = sum(2.0 * a * b for a, b in
                  zip((d,) + cfg.mlp_dims[:-1], cfg.mlp_dims))
        return B * (cfg.n_cross * 2.0 * d * d + mlp)
    if arch.id == "dien":
        g, db, T = cfg.gru_dim, cfg.d_beh, cfg.seq_len
        gru = 2.0 * T * 3 * (db * g + g * g) + 2.0 * T * 3 * (g * g + g * g)
        mlp = (2.0 * (g + 2 * db) * cfg.mlp_dims[0]
               + 2.0 * cfg.mlp_dims[0] * cfg.mlp_dims[1])
        return B * (gru + mlp)
    if arch.id == "mind":
        d, T, K = cfg.embed_dim, cfg.seq_len, cfg.n_interests
        return B * (2.0 * T * d * d + cfg.routing_iters * 4.0 * T * K * d)
    return 0.0


def recsys_batch(arch_id: str, cfg, B: int, step: int = 0,
                 device="cuda") -> dict:
    """B samples of ``arch_id``'s inputs at ``cfg``'s rows, items and
    categories (seed 0, ``step`` keys the batch), as tensors on
    ``device``: fm and dcn-v2 from ``recsys_ctr_batch`` (``sparse_ids``,
    dcn-v2's ``dense``, ``label``), dien and mind from
    ``recsys_seq_batch`` (dien's categories are item ids mod
    ``cfg.n_cats``; mind's ``n_neg`` negatives), every field the arch's
    loss reads."""
    dev = resolve_device(device)
    if arch_id in ("fm", "dcn-v2"):
        raw = recsys_ctr_batch(B, step, n_sparse=cfg.n_sparse, rows=cfg.rows)
        keys = ("sparse_ids", "label") + (("dense",) if arch_id == "dcn-v2"
                                          else ())
    elif arch_id in ("dien", "mind"):
        dien = arch_id == "dien"
        raw = recsys_seq_batch(B, step, n_items=cfg.n_items,
                               n_cats=cfg.n_cats if dien else 4096,
                               seq_len=cfg.seq_len,
                               n_neg=4 if dien else cfg.n_neg)
        keys = (("hist_items", "hist_cats", "hist_mask", "target_item",
                 "target_cat", "label") if dien else
                ("hist_items", "hist_mask", "target_item", "neg_items"))
    else:
        raise KeyError(f"{arch_id} is not a recsys arch")
    return {k: torch.from_numpy(raw[k]).to(dev) for k in keys}
