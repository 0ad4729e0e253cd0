"""Recommendation models on PyTorch: FM, DCN-v2, DIEN, MIND and the
embedding substrate.  Counterpart of ``repro.models.recsys``, with its
names and arithmetic.

The substrate is a row gather (``index_select``) and a masked sum: sparse
categorical fields hash into per-field row ranges of one flat table
``[n_fields·rows, dim]``.  Every function here is plain PyTorch, as every
one is jnp (no Pallas kernel) in the reference.  Initializers draw from
an explicit ``torch.Generator`` (other numbers than ``jax.random`` gives
from the same seed: tests carry the reference's parameters across with
``interop.recsys_params_from_numpy``) and put the parameters on
``device``: ``"cuda"`` by default, which raises without a card.

Models (``*_loss`` returns (loss, metrics) from a batch dict):
  FM      — 2-way factorization machine, O(nk) sum-square trick (Rendle'10)
  DCN-v2  — cross network v2, full-rank cross layers + deep tower
  DIEN    — GRU interest extractor + AUGRU interest evolution (target attn)
  MIND    — multi-interest B2I capsule routing

Retrieval scores one user against C candidates and returns the top k as
``jax.lax.top_k`` does: scores descending, ties lowest index first
(``_top_k``, a stable sort; ``torch.topk`` promises no tie order).  MIND's
user interests are also the queries of the δ-EMQG MIPS index
(``core.mips``), the paper's technique put to work.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..core.types import resolve_device
from .common import dense_init, gru_init, gru_scan, mlp_apply, mlp_init


def _device_and_gen(gen: Optional[torch.Generator], device):
    """(device, generator) of an initializer: seed 0 on the device when
    ``gen`` is None; on the ``meta`` device (shapes only) no generator."""
    dev = resolve_device(device)
    if gen is None and dev.type != "meta":
        gen = torch.Generator(device=dev).manual_seed(0)
    return dev, gen


def _take(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` for ids of any shape: one row gather."""
    rows = torch.index_select(table, 0, ids.reshape(-1))
    return rows.reshape(*ids.shape, table.shape[1])


def _top_k(scores: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis: (values, int32 indices),
    values descending, equal values lowest index first."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)


def _masked_mean_denominator(mask: torch.Tensor) -> torch.Tensor:
    """max(Σ mask, 1) along the last axis, kept as a column."""
    return torch.clamp(mask.sum(-1, keepdim=True), min=1)


# ---------------------------------------------------------------------------
# Embedding substrate
# ---------------------------------------------------------------------------

def embedding_table_init(gen: Optional[torch.Generator], n_fields: int,
                         rows: int, dim: int, dtype=torch.float32,
                         device=None) -> torch.Tensor:
    """Stacked per-field table, stored FLAT [n_fields·rows, dim]."""
    dev = device or gen.device
    return (torch.randn((n_fields * rows, dim), generator=gen,
                        dtype=torch.float32, device=dev) * 0.01).to(dtype)


def field_lookup_flat(table: torch.Tensor, ids: torch.Tensor,
                      rows: int) -> torch.Tensor:
    """table [F·rows, d], ids int[B, F] (one id per field) → [B, F, d]:
    each id clipped to [0, rows), offset to its field's range, one row
    gather."""
    F = ids.shape[1]
    offs = torch.arange(F, dtype=ids.dtype, device=ids.device) * rows
    return _take(table, torch.clamp(ids, 0, rows - 1) + offs[None, :])


def embedding_bag(table: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor,
                  mode: str = "mean") -> torch.Tensor:
    """EmbeddingBag: table [R, d], ids int[B, L], mask bool[B, L] → [B, d],
    the masked sum (``mode="sum"``) or mean of the gathered rows."""
    R = table.shape[0]
    rows = _take(table, torch.clamp(ids, 0, R - 1))             # [B, L, d]
    rows = torch.where(mask[:, :, None], rows, 0.0)
    s = rows.sum(1)
    if mode == "sum":
        return s
    return s / _masked_mean_denominator(mask)


# ---------------------------------------------------------------------------
# FM
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FMConfig:
    name: str = "fm"
    n_sparse: int = 39
    rows: int = 1 << 21
    embed_dim: int = 10
    dtype: Any = torch.float32


def fm_init(cfg: FMConfig, gen: Optional[torch.Generator] = None,
            device="cuda") -> dict:
    dev, gen = _device_and_gen(gen, device)
    return {
        "emb": embedding_table_init(gen, cfg.n_sparse, cfg.rows,
                                    cfg.embed_dim, cfg.dtype, device=dev),
        "lin": embedding_table_init(gen, cfg.n_sparse, cfg.rows, 1,
                                    cfg.dtype, device=dev),
        "bias": torch.zeros((), dtype=torch.float32, device=dev),
    }


def fm_forward(cfg: FMConfig, params: dict,
               sparse_ids: torch.Tensor) -> torch.Tensor:
    """sparse_ids int[B, F] → logit f32[B]."""
    v = field_lookup_flat(params["emb"], sparse_ids, cfg.rows)      # [B, F, k]
    w = field_lookup_flat(params["lin"], sparse_ids, cfg.rows)[..., 0]
    sum_v = v.sum(1)                                                # [B, k]
    sum_v2 = (v * v).sum(1)
    pair = 0.5 * (sum_v * sum_v - sum_v2).sum(-1)                   # O(nk)
    return (params["bias"] + w.sum(1) + pair).float()


def fm_loss(cfg: FMConfig, params: dict, batch: dict):
    return _bce(fm_forward(cfg, params, batch["sparse_ids"]), batch["label"])


# ---------------------------------------------------------------------------
# DCN-v2
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DCNConfig:
    name: str = "dcn-v2"
    n_dense: int = 13
    n_sparse: int = 26
    rows: int = 1 << 21
    embed_dim: int = 16
    n_cross: int = 3
    mlp_dims: tuple = (1024, 1024, 512)
    dtype: Any = torch.float32

    @property
    def d_input(self) -> int:
        return self.n_dense + self.n_sparse * self.embed_dim


def dcn_init(cfg: DCNConfig, gen: Optional[torch.Generator] = None,
             device="cuda") -> dict:
    dev, gen = _device_and_gen(gen, device)
    d = cfg.d_input
    p = {
        "emb": embedding_table_init(gen, cfg.n_sparse, cfg.rows,
                                    cfg.embed_dim, cfg.dtype, device=dev),
        "mlp": mlp_init(gen, [d, *cfg.mlp_dims], cfg.dtype, device=dev),
        "head": dense_init(gen, cfg.mlp_dims[-1], 1, cfg.dtype, device=dev),
    }
    for i in range(cfg.n_cross):
        p[f"cross_w{i}"] = dense_init(gen, d, d, cfg.dtype, device=dev)
        p[f"cross_b{i}"] = torch.zeros((d,), dtype=cfg.dtype, device=dev)
    return p


def dcn_forward(cfg: DCNConfig, params: dict, dense: torch.Tensor,
                sparse_ids: torch.Tensor) -> torch.Tensor:
    """dense f32[B, n_dense], sparse_ids int[B, n_sparse] → logit f32[B]."""
    emb = field_lookup_flat(params["emb"], sparse_ids, cfg.rows)
    x0 = torch.cat([dense.to(cfg.dtype), emb.reshape(emb.shape[0], -1)], -1)
    x = x0
    for i in range(cfg.n_cross):                 # x_{l+1} = x0∘(Wx+b)+x
        x = x0 * (x @ params[f"cross_w{i}"] + params[f"cross_b{i}"]) + x
    h = mlp_apply(params["mlp"], x, len(cfg.mlp_dims), final_act=True)
    return (h @ params["head"])[:, 0].float()


def dcn_loss(cfg: DCNConfig, params: dict, batch: dict):
    logit = dcn_forward(cfg, params, batch["dense"], batch["sparse_ids"])
    return _bce(logit, batch["label"])


# ---------------------------------------------------------------------------
# DIEN
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DIENConfig:
    name: str = "dien"
    n_items: int = 1 << 22
    n_cats: int = 1 << 12
    embed_dim: int = 18
    seq_len: int = 100
    gru_dim: int = 108
    mlp_dims: tuple = (200, 80)
    dtype: Any = torch.float32

    @property
    def d_beh(self) -> int:
        return 2 * self.embed_dim      # item ⊕ category


def dien_init(cfg: DIENConfig, gen: Optional[torch.Generator] = None,
              device="cuda") -> dict:
    dev, gen = _device_and_gen(gen, device)
    d_beh, gd = cfg.d_beh, cfg.gru_dim
    return {
        "item_emb": embedding_table_init(gen, 1, cfg.n_items, cfg.embed_dim,
                                         cfg.dtype, device=dev),
        "cat_emb": embedding_table_init(gen, 1, cfg.n_cats, cfg.embed_dim,
                                        cfg.dtype, device=dev),
        "gru1": gru_init(gen, d_beh, gd, cfg.dtype, device=dev),
        "gru2": gru_init(gen, gd, gd, cfg.dtype, device=dev),
        "att_w": dense_init(gen, gd, d_beh, cfg.dtype, device=dev),
        "mlp": mlp_init(gen, [gd + 2 * d_beh, *cfg.mlp_dims], cfg.dtype,
                        device=dev),
        "head": dense_init(gen, cfg.mlp_dims[-1], 1, cfg.dtype, device=dev),
    }


def _behavior_embed(cfg: DIENConfig, params: dict, item_ids, cat_ids):
    e_i = _take(params["item_emb"], torch.clamp(item_ids, 0, cfg.n_items - 1))
    e_c = _take(params["cat_emb"], torch.clamp(cat_ids, 0, cfg.n_cats - 1))
    return torch.cat([e_i, e_c], -1)


def _target_attention(scores: torch.Tensor, mask: torch.Tensor):
    """Softmax over the valid steps of each row, 0 at the others."""
    att = torch.softmax(scores.masked_fill(~mask, float("-inf")), -1)
    return torch.where(mask, att, 0.0)


def dien_forward(cfg: DIENConfig, params: dict, batch: dict) -> torch.Tensor:
    """batch: hist_items/hist_cats int[B, T], hist_mask bool[B, T],
    target_item/target_cat int[B] → logit f32[B]."""
    beh = _behavior_embed(cfg, params, batch["hist_items"], batch["hist_cats"])
    tgt = _behavior_embed(cfg, params, batch["target_item"][:, None],
                          batch["target_cat"][:, None])[:, 0]     # [B, d_beh]
    mask = batch["hist_mask"]
    beh = torch.where(mask[:, :, None], beh, 0.0)

    h_states, _ = gru_scan(params["gru1"], beh)                   # [B, T, g]
    # AUGRU: each interest state against the target, Σ_g,d h W t summed as
    # h · (t Wᵀ) (no [B, T, d] product)
    scores = torch.einsum("btg,bg->bt", h_states, tgt @ params["att_w"].T)
    att = _target_attention(scores, mask)
    _, h_final = gru_scan(params["gru2"], h_states, atts=att,
                          keep_states=False)                      # [B, g]

    beh_sum = beh.sum(1) / _masked_mean_denominator(mask)
    feat = torch.cat([h_final, tgt, beh_sum], -1)
    h = mlp_apply(params["mlp"], feat, len(cfg.mlp_dims), final_act=True)
    return (h @ params["head"])[:, 0].float()


def dien_loss(cfg: DIENConfig, params: dict, batch: dict):
    return _bce(dien_forward(cfg, params, batch), batch["label"])


# ---------------------------------------------------------------------------
# MIND
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MINDConfig:
    name: str = "mind"
    n_items: int = 1 << 22
    embed_dim: int = 64
    n_interests: int = 4
    routing_iters: int = 3
    seq_len: int = 50
    n_neg: int = 16
    pow_p: float = 2.0                 # label-aware attention sharpness
    dtype: Any = torch.float32


def mind_init(cfg: MINDConfig, gen: Optional[torch.Generator] = None,
              device="cuda") -> dict:
    dev, gen = _device_and_gen(gen, device)
    d = cfg.embed_dim
    return {
        "item_emb": embedding_table_init(gen, 1, cfg.n_items, d, cfg.dtype,
                                         device=dev),
        "s_bilinear": dense_init(gen, d, d, cfg.dtype, device=dev),
        "b_init": (torch.randn((cfg.n_interests,), generator=gen,
                               dtype=torch.float32, device=dev)
                   * 0.1).to(cfg.dtype),
    }


def _squash(x: torch.Tensor) -> torch.Tensor:
    n2 = (x * x).sum(-1, keepdim=True)
    return (n2 / (1.0 + n2)) * x / torch.sqrt(n2 + 1e-9)


def mind_user_interests(cfg: MINDConfig, params: dict,
                        hist_items: torch.Tensor,
                        hist_mask: torch.Tensor) -> torch.Tensor:
    """B2I dynamic routing: hist [B, T] → interest capsules [B, K, d]."""
    e = _take(params["item_emb"],
              torch.clamp(hist_items, 0, cfg.n_items - 1))          # [B, T, d]
    low = e @ params["s_bilinear"]                                  # S·e_i
    low = torch.where(hist_mask[:, :, None], low, 0.0)
    B, T, d = low.shape
    K = cfg.n_interests
    b_logits = params["b_init"][None, None, :].expand(B, T, K).float()

    caps = torch.zeros((B, K, d), dtype=low.dtype, device=low.device)
    for _ in range(cfg.routing_iters):
        c = torch.softmax(b_logits, -1)                  # over capsules
        c = torch.where(hist_mask[:, :, None], c, 0.0)
        caps = _squash(torch.einsum("btk,btd->bkd", c, low))
        b_logits = b_logits + torch.einsum("bkd,btd->btk", caps, low)
    return caps


def mind_loss(cfg: MINDConfig, params: dict, batch: dict):
    """Sampled-softmax training with label-aware attention (paper §4.3).
    batch: hist_items [B, T], hist_mask [B, T], target_item [B],
    neg_items [B, n_neg]."""
    caps = mind_user_interests(cfg, params, batch["hist_items"],
                               batch["hist_mask"])                  # [B, K, d]
    tgt = _take(params["item_emb"],
                torch.clamp(batch["target_item"], 0, cfg.n_items - 1))
    att = torch.einsum("bkd,bd->bk", caps, tgt)
    att = torch.softmax(torch.pow(torch.abs(att), cfg.pow_p)
                        * torch.sign(att), -1)
    user = torch.einsum("bk,bkd->bd", att, caps)                    # [B, d]
    neg = _take(params["item_emb"],
                torch.clamp(batch["neg_items"], 0, cfg.n_items - 1))
    pos_logit = torch.einsum("bd,bd->b", user, tgt)
    neg_logit = torch.einsum("bd,bnd->bn", user, neg)
    logits = torch.cat([pos_logit[:, None], neg_logit], 1)
    logp = torch.log_softmax(logits.float(), -1)
    loss = -logp[:, 0].mean()
    acc = (torch.argmax(logits, -1) == 0).float().mean()
    return loss, {"acc": acc}


def mind_serve_scores(cfg: MINDConfig, params: dict, hist_items, hist_mask,
                      cand_items: torch.Tensor) -> torch.Tensor:
    """Serving: max-over-interests score against candidates [B, C] → [B, C]."""
    caps = mind_user_interests(cfg, params, hist_items, hist_mask)
    cand = _take(params["item_emb"],
                 torch.clamp(cand_items, 0, cfg.n_items - 1))       # [B, C, d]
    return torch.einsum("bkd,bcd->bkc", caps, cand).amax(1)


# ---------------------------------------------------------------------------
# Retrieval scoring — the δ-EMG integration point
# ---------------------------------------------------------------------------

def retrieval_scores_exact(query: torch.Tensor, item_table: torch.Tensor,
                           k: int = 100):
    """Brute-force candidate scoring: query [B, d] (or [B, K, d] multi-
    interest, max over K) against item_table [C, d] → top-k (scores, ids)."""
    if query.dim() == 3:
        s = torch.einsum("bkd,cd->bkc", query, item_table).amax(1)
    else:
        s = query @ item_table.T
    return _top_k(s, k)


def fm_retrieval(cfg: FMConfig, params: dict, user_ids: torch.Tensor,
                 cand_ids: torch.Tensor, k: int = 100):
    """FM as a retrieval scorer: query = Σ user-field latent vectors; the
    candidate item lives in field 0.  score(q, i) = ⟨q, v_i⟩ + w_i.
    user_ids int[B, F−1] (fields 1..F−1), cand_ids int[C] → top-k (scores,
    positions in cand_ids), as the reference returns them."""
    F, R = cfg.n_sparse, cfg.rows
    offs = torch.arange(1, F, dtype=user_ids.dtype,
                        device=user_ids.device) * R
    uv = _take(params["emb"], torch.clamp(user_ids, 0, R - 1) + offs[None, :])
    q = uv.sum(1)                                                   # [B, k]
    iv = _take(params["emb"], torch.clamp(cand_ids, 0, R - 1))      # field 0
    iw = _take(params["lin"], torch.clamp(cand_ids, 0, R - 1))[:, 0]
    return _top_k((q @ iv.T + iw[None, :]).float(), k)


def dcn_retrieval(cfg: DCNConfig, params: dict, dense: torch.Tensor,
                  user_sparse: torch.Tensor, cand_ids: torch.Tensor,
                  k: int = 100):
    """Full-model scoring of C candidates for one user context: the user's
    features broadcast across candidates, the candidate id in sparse field
    0.  dense [1, n_dense], user_sparse [1, n_sparse − 1], cand_ids [C]."""
    C = cand_ids.shape[0]
    sparse = torch.cat([cand_ids[:, None].to(user_sparse.dtype),
                        user_sparse.expand(C, cfg.n_sparse - 1)], 1)
    logit = dcn_forward(cfg, params, dense.expand(C, cfg.n_dense), sparse)
    score, idx = _top_k(logit, k)
    return score[None], cand_ids[idx.long()][None]


def dien_retrieval(cfg: DIENConfig, params: dict, batch: dict,
                   cand_ids: torch.Tensor, k: int = 100):
    """DIEN candidate scoring: GRU1 runs once for the user; the target
    attention, the AUGRU and the MLP head run per candidate.  The
    reference's attention over the broadcast states, Σ_g,d h[t,g] W[g,d]
    t[c,d], is computed as (t Wᵀ)[c,g] · h[t,g] (no [C, T, g] tensor), and
    the AUGRU reads the user's one row of states against the C rows of
    its hidden state."""
    C = cand_ids.shape[0]
    beh = _behavior_embed(cfg, params, batch["hist_items"], batch["hist_cats"])
    mask = batch["hist_mask"]                                       # [1, T]
    beh = torch.where(mask[:, :, None], beh, 0.0)
    h_states, _ = gru_scan(params["gru1"], beh)                     # [1, T, g]

    tgt = _behavior_embed(cfg, params, cand_ids[:, None],
                          (cand_ids % cfg.n_cats)[:, None])[:, 0]  # [C, d_beh]
    m_rep = mask.expand(C, mask.shape[1])
    scores = (tgt @ params["att_w"].T) @ h_states[0].T              # [C, T]
    att = _target_attention(scores, m_rep)
    h0 = torch.zeros((C, cfg.gru_dim), dtype=h_states.dtype,
                     device=h_states.device)
    _, h_final = gru_scan(params["gru2"], h_states, h0=h0, atts=att,
                          keep_states=False)                        # [C, g]
    beh_sum = beh.sum(1) / _masked_mean_denominator(mask)
    feat = torch.cat([h_final, tgt, beh_sum.expand(C, beh_sum.shape[1])], -1)
    h = mlp_apply(params["mlp"], feat, len(cfg.mlp_dims), final_act=True)
    logit = (h @ params["head"])[:, 0].float()
    score, idx = _top_k(logit, k)
    return score[None], cand_ids[idx.long()][None]


def mind_retrieval(cfg: MINDConfig, params: dict, hist_items, hist_mask,
                   cand_ids: torch.Tensor, k: int = 100):
    """MIND retrieval: max-over-interest dot scores against the candidate
    table — the cell the δ-EMQG index replaces with graph search."""
    caps = mind_user_interests(cfg, params, hist_items, hist_mask)  # [B,K,d]
    cand = _take(params["item_emb"],
                 torch.clamp(cand_ids, 0, cfg.n_items - 1))         # [C, d]
    scores = torch.einsum("bkd,cd->bkc", caps, cand).amax(1).float()
    score, idx = _top_k(scores, k)
    return score, cand_ids[idx.long()]


def _bce(logit: torch.Tensor, label: torch.Tensor):
    label = label.float()
    loss = (torch.maximum(logit, torch.zeros_like(logit)) - logit * label
            + torch.log1p(torch.exp(-torch.abs(logit)))).mean()
    acc = ((logit > 0) == (label > 0.5)).float().mean()
    return loss, {"acc": acc}
