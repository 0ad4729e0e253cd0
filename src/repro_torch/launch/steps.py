"""The recsys, GNN and ANN parts of the reference's
``repro.launch.steps`` that have a meaning on one card.

Recsys: each arch's initializer and loss (``_RECSYS_INIT``,
``_RECSYS_LOSS``), the forward its serve cell runs (``_RECSYS_SERVE``,
the function of ``_recsys_serve_cell``), its retrieval over candidates
(``_RECSYS_RETRIEVAL``, ``_recsys_retrieval_cell``'s), the model FLOPs
of B samples (``_recsys_model_flops``), and ``recsys_batch``, a batch of
an arch's serve or train inputs from the synthetic logs.

GNN: ``gnn_batch``, the batch ``_gnn_cell`` declares for one of gat-cora's
four cells, made from ``sbm_graph`` (the full graphs and the graph the
minibatch cell samples) and ``fanout_sample`` or ``molecule_batch``, and
``_gnn_model_flops``, that cell's count of a train step's FLOPs.

ANN: ``ann_serve``, the serving call of ``_ann_serve_cell`` (the
quantized local probing search and the all-gather top-k merge over a
``ShardedIndex``, with the arch's ``SearchParams``), and
``_ann_model_flops``, that cell's count of a call's FLOPs.

The rest of that module lowers XLA dry-run cells for a TPU mesh and is
not ported.
"""

from __future__ import annotations

import functools
import time
from typing import Optional

import numpy as np
import torch

from ..core.distributed import ShardedIndex, make_sharded_search
from ..core.types import resolve_device
from ..data import (CSRGraph, fanout_sample, molecule_batch, recsys_ctr_batch,
                    recsys_seq_batch, sbm_graph)
from ..models import gnn
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


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------

def _gnn_sizes(shape) -> tuple[int, int, int]:
    """(nodes, edges, graphs) of a train step of ``_gnn_cell`` at
    ``shape`` on one card (the reference pads the edges to its data-
    parallel axes, which one card does not have)."""
    dims = shape.dims
    if shape.kind == "molecule":
        return (dims["batch"] * dims["n_nodes"],
                dims["batch"] * dims["n_edges"], dims["batch"])
    if shape.kind == "minibatch":
        return dims["pad_nodes"], dims["pad_edges"], 0
    return dims["n_nodes"], dims["n_edges"], 0


def _gnn_model_flops(arch, shape_name: str) -> float:
    """The reference's count of a train step's model FLOPs at a GNN cell,
    3 × the forward's: E·H·d·4 (SDDMM and SpMM) + the two layers' GEMMs."""
    cfg, shape = arch.model_cfg[shape_name], arch.shapes[shape_name]
    n_nodes, n_edges, _ = _gnn_sizes(shape)
    d_out = cfg.d_hidden * cfg.n_heads
    return 3.0 * (2.0 * n_edges * d_out * 2 + 2.0 * n_nodes *
                  cfg.d_in * d_out + 2.0 * n_nodes * d_out * cfg.n_classes)


def sbm_avg_degree(n_nodes: int, n_edges: int) -> float:
    """``sbm_graph``'s ``avg_degree`` whose symmetrised edge count is
    ``n_edges`` (even): ``int(n_nodes · avg_degree)`` = n_edges / 2."""
    return (n_edges // 2 + 0.5) / n_nodes


@functools.lru_cache(maxsize=4)
def host_graph(n_nodes: int, n_classes: int, d_feat: int, n_edges: int,
               csr: Optional[str] = None) -> dict:
    """A cell's host graph, made once a process (the newest four kept):
    ``sbm_graph`` (seed 0) of ``n_nodes`` nodes in ``n_classes``
    communities with ``d_feat`` features and ``n_edges`` edges after
    symmetrisation, with ``csr`` (a device name) its ``CSRGraph`` too,
    ordered on that device; ``graph_s`` and ``csr_s`` are the seconds
    each took."""
    t0 = time.perf_counter()
    g = sbm_graph(n_nodes, n_classes, d_feat,
                  avg_degree=sbm_avg_degree(n_nodes, n_edges), seed=0)
    g["graph_s"] = time.perf_counter() - t0
    if csr:
        t0 = time.perf_counter()
        g["csr"] = CSRGraph.from_edges(g["src"], g["dst"], n_nodes,
                                       device=csr)
        g["csr_s"] = time.perf_counter() - t0
    return g


def cell_graph(arch, shape_name: str, device="cuda") -> dict:
    """``host_graph`` of a full-graph or minibatch cell (with its CSR for
    the minibatch cell, ordered on ``device``)."""
    shape = arch.shapes[shape_name]
    dims = shape.dims
    return host_graph(dims["n_nodes"], dims["n_classes"], dims["d_feat"],
                      dims["n_edges"], csr=str(resolve_device(device))
                      if shape.kind == "minibatch" else None)


def gnn_batch(arch, shape_name: str, step: int = 0, device="cuda") -> dict:
    """The batch of ``_gnn_cell`` at ``shape_name`` as tensors on
    ``device``: ``x``, ``src``, ``dst``, ``labels`` and ``label_mask``;
    for molecule also ``graph_ids``, ``node_mask`` and ``n_graphs``, with
    labels and mask per graph.

    * full graph (full_graph_sm, ogb_products): the cell's ``sbm_graph``,
      the same every step, every node labelled (the reference's cell is
      abstract: it names no split); ``graph_s`` is ``host_graph``'s
      seconds for it;
    * minibatch_lg: ``fanout_sample`` of that graph from
      ``batch_nodes`` seed nodes drawn by the step (seed (0, step),
      without replacement), padded to the cell's pads; the seed nodes are
      labelled; ``n_sub_nodes`` / ``n_sub_edges`` are the sizes before
      the pads (the sampler cuts what outgrows them: the caller checks),
      ``sample_s`` the sampler's seconds, ``graph_s`` and ``csr_s``
      ``host_graph``'s;
    * molecule: ``molecule_batch`` keyed by the step.
    """
    dev = resolve_device(device)
    shape = arch.shapes[shape_name]
    dims = shape.dims
    if shape.kind == "molecule":
        raw = molecule_batch(dims["batch"], dims["n_nodes"], dims["n_edges"],
                             dims["d_feat"], dims["n_classes"], step)
        raw["label_mask"] = np.ones(dims["batch"], bool)
        out = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
        out["n_graphs"] = dims["batch"]
        return out
    g = cell_graph(arch, shape_name, dev)
    if shape.kind == "minibatch":
        t0 = time.perf_counter()
        seeds = np.random.default_rng((0, step)).choice(
            dims["n_nodes"], dims["batch_nodes"], replace=False)
        raw = fanout_sample(g["csr"], g["x"], g["labels"], seeds,
                            dims["fanout"], seed=step,
                            pad_nodes=dims["pad_nodes"],
                            pad_edges=dims["pad_edges"])
        sizes = {k: raw.pop(k) for k in ("n_sub_nodes", "n_sub_edges")}
        out = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
        return {**out, **sizes, "sample_s": time.perf_counter() - t0,
                "graph_s": g["graph_s"], "csr_s": g["csr_s"]}
    return {"graph_s": g["graph_s"],
            "x": torch.from_numpy(g["x"]).to(dev),
            "src": torch.from_numpy(g["src"]).to(dev),
            "dst": torch.from_numpy(g["dst"]).to(dev),
            "labels": torch.from_numpy(g["labels"]).to(dev),
            "label_mask": torch.ones(dims["n_nodes"], dtype=torch.bool,
                                     device=dev)}


def check_untruncated(batch: dict, shape) -> None:
    """Raise where ``fanout_sample`` cut a subgraph to the cell's pads."""
    dims = shape.dims
    if (batch["n_sub_nodes"] > dims["pad_nodes"]
            or batch["n_sub_edges"] > dims["pad_edges"]):
        raise RuntimeError(
            f"{shape.name}: the sampled subgraph has {batch['n_sub_nodes']:,} "
            f"nodes and {batch['n_sub_edges']:,} edges, past the pads "
            f"{dims['pad_nodes']:,} / {dims['pad_edges']:,}: the sampler "
            "cut it")


def gnn_loss(cfg, edge_chunk=None):
    """``_gnn_cell``'s loss of (params, batch) at ``cfg``, the edges in
    chunks of ``edge_chunk`` (``models.gnn.plan_edge_chunk``)."""
    def loss(params, b):
        return gnn.loss_fn(cfg, params, b["x"], b["src"], b["dst"],
                           b["labels"], b["label_mask"],
                           graph_ids=b.get("graph_ids"),
                           n_graphs=b.get("n_graphs", 0),
                           node_mask=b.get("node_mask"),
                           edge_chunk=edge_chunk)
    return loss


# ---------------------------------------------------------------------------
# ANN serving cells (sift1m)
# ---------------------------------------------------------------------------

def ann_serve(arch, shape, sidx: ShardedIndex):
    """The serving call of ``_ann_serve_cell`` for ``arch`` (family "ann")
    at ``shape`` over the built index ``sidx``: ``run(queries [B, d],
    stats=None) → (ids, dists) [B, k]``, the quantized probing search of
    every shard merged by ``make_sharded_search(merge="all_gather",
    quantized=True)`` with the arch's ``SearchParams``, on the index's
    device (``stats``: as that search's).  The reference's cell takes
    abstract shapes on a mesh; here the index is built and the call
    runs."""
    if arch.family != "ann" or shape.kind != "ann_serve":
        raise ValueError(f"{arch.id}/{shape.name} is not an ANN serve cell")
    run = make_sharded_search(merge="all_gather", quantized=True)
    params = arch.model_cfg["search"]
    return lambda queries, stats=None: run(sidx, queries, params,
                                           stats=stats)


def _ann_model_flops(arch, shape, sidx: ShardedIndex) -> float:
    """The reference's model FLOPs of one ANN serve call over ``sidx``:
    the dense cost of an exact rerank of ``l_max`` candidates a query and
    shard, B · S · l_max · 2 · dim (the useful-work floor of the probing
    search), S the index's shards."""
    B = shape.dims["batch"]
    return B * sidx.n_shards * arch.model_cfg["search"].l_max * 2.0 \
        * arch.model_cfg["dim"]
