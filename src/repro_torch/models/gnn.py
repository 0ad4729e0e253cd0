"""Graph attention network (GAT, Veličković et al. 2018) over an edge
list, on PyTorch.  Counterpart of ``repro.models.gnn``, with its names and
arithmetic:

  SDDMM  — per-edge attention logits  e_ij = LeakyReLU(a_src·h_i + a_dst·h_j)
  segment-softmax over destination    α_ij = exp(e_ij − max_j) / Σ_j
  SpMM   — message aggregation        h'_j = Σ_i α_ij · h_i

The reference's ``jax.ops.segment_max`` / ``segment_sum`` are
``scatter_reduce(..., "amax")`` and ``index_add`` over the destination
ids, its gathers ``index_select``; every function is plain PyTorch, as
every one is jnp (no Pallas kernel) there.  Its conventions hold: the
segment max is gradient-stopped and zeroed where not finite, a padded
edge (``src = -1``) goes to node 0 with e = -inf and z = 0, the
denominator is clamped at 1e-9, the last layer averages its heads and the
others apply ELU and add the bias.

The reference shards the edges over its mesh and combines the partial
segment reductions with ``pmax`` / ``psum``; its ``hints.constrain`` and
``axis_name`` are XLA sharding and are not ported.  Their one-card
counterpart is the **edge chunk** (``edge_chunk=``): the edges run in
chunks in series, the partial max, denominator and messages add up across
chunks by max and sum, and a chunk's gather ``h[src]`` and its messages
are recomputed in the backward pass (``_EdgeAggregate``), so no
``[E, H, d]`` tensor lives across the edge list.  On ogb_products (E =
61,859,140) the last layer's ``h[src]`` alone would be 93 GB in f32.
``plan_edge_chunk`` sizes the chunk from the card's memory.

Shapes: full graph (cora, ogb_products), a padded sampled subgraph
(``data.fanout_sample``) and a block-diagonal batch of small graphs
(molecule, with ``graph_readout``).  Initializers draw from an explicit
``torch.Generator`` (other numbers than ``jax.random``: tests carry the
reference's parameters across with ``interop.gnn_params_from_numpy``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F

from ..core.types import resolve_device
from .common import dense_init

# the share of the card a step plans to fill (launch.train's CARD_SHARE)
CARD_SHARE = 0.9


@dataclasses.dataclass(frozen=True)
class GATConfig:
    name: str = "gat"
    n_layers: int = 2
    d_in: int = 1433
    d_hidden: int = 8
    n_heads: int = 8
    n_classes: int = 7
    negative_slope: float = 0.2
    readout: Optional[str] = None      # None (node-level) | "mean" (graph-level)
    dtype: Any = torch.float32

    @property
    def layer_dims(self) -> list[tuple[int, int]]:
        dims = []
        d = self.d_in
        for i in range(self.n_layers):
            out = self.d_hidden if i < self.n_layers - 1 else self.n_classes
            dims.append((d, out))
            d = out * self.n_heads if i < self.n_layers - 1 else out
        return dims


def init(cfg: GATConfig, gen: Optional[torch.Generator] = None,
         device="cuda") -> dict:
    """``layer{i}``: ``w`` [d_in, H·d_out], ``a_src`` / ``a_dst`` [H,
    d_out], ``b`` [H·d_out] (zeros), on ``device`` (seed 0 when ``gen`` is
    None; ``"meta"`` gives shapes only)."""
    dev = resolve_device(device)
    if gen is None and dev.type != "meta":
        gen = torch.Generator(device=dev).manual_seed(0)

    def mk(a, b):
        if dev.type == "meta":
            return torch.empty((a, b), dtype=cfg.dtype, device=dev)
        return dense_init(gen, a, b, cfg.dtype, device=dev)

    params = {}
    for i, (d_in, d_out) in enumerate(cfg.layer_dims):
        params[f"layer{i}"] = {
            "w": mk(d_in, cfg.n_heads * d_out),
            "a_src": mk(cfg.n_heads, d_out),
            "a_dst": mk(cfg.n_heads, d_out),
            "b": torch.zeros((cfg.n_heads * d_out,), dtype=cfg.dtype,
                             device=dev),
        }
    return params


def _leaky_relu(x: torch.Tensor, slope: float) -> torch.Tensor:
    """``jax.nn.leaky_relu``: x where x ≥ 0 (its gradient 1 at 0)."""
    return torch.where(x >= 0, x, slope * x)


def _edge_z(s_src, s_dst, seg_max, src, dst, mask, slope):
    """Per edge: the softmax numerator z [c, H] (0 on a padded edge)."""
    e = _leaky_relu(s_src.index_select(0, src) + s_dst.index_select(0, dst),
                    slope)
    e = torch.where(mask[:, None], e, float("-inf"))
    z = torch.exp(e - seg_max.index_select(0, dst))
    return torch.where(mask[:, None], z, 0.0)


def _segment_max(s_src, s_dst, src, dst, mask, slope, n_nodes: int,
                 chunk: int) -> torch.Tensor:
    """max over each destination's in-edges of e [N, H], gradient-stopped,
    0 where no edge reaches a node (not finite)."""
    H = s_src.shape[1]
    out = torch.full((n_nodes, H), float("-inf"), dtype=s_src.dtype,
                     device=s_src.device)
    with torch.no_grad():
        for lo in range(0, src.shape[0], chunk):
            s, t, m = src[lo:lo + chunk], dst[lo:lo + chunk], \
                mask[lo:lo + chunk]
            e = _leaky_relu(s_src.index_select(0, s)
                            + s_dst.index_select(0, t), slope)
            e = torch.where(m[:, None], e, float("-inf"))
            out.scatter_reduce_(0, t.long()[:, None].expand(-1, H), e,
                                "amax", include_self=False)
    return torch.where(torch.isfinite(out), out, 0.0)


class _EdgeAggregate(torch.autograd.Function):
    """(denominator [N, H], messages Σ z·h[src] [N, H, d]) over the edges
    in chunks of ``chunk``; the backward recomputes each chunk's gathers
    and z and adds its gradients into h, s_src and s_dst."""

    @staticmethod
    def forward(ctx, h, s_src, s_dst, seg_max, src, dst, mask, slope, chunk):
        N, H, d = h.shape
        denom = torch.zeros((N, H), dtype=h.dtype, device=h.device)
        agg = torch.zeros((N, H, d), dtype=h.dtype, device=h.device)
        for lo in range(0, src.shape[0], chunk):
            s, t, m = src[lo:lo + chunk], dst[lo:lo + chunk], \
                mask[lo:lo + chunk]
            z = _edge_z(s_src, s_dst, seg_max, s, t, m, slope)
            denom.index_add_(0, t, z)
            agg.index_add_(0, t, z[:, :, None] * h.index_select(0, s))
        ctx.save_for_backward(h, s_src, s_dst, seg_max, src, dst, mask)
        ctx.slope, ctx.chunk = slope, chunk
        return denom, agg

    @staticmethod
    def backward(ctx, g_denom, g_agg):
        h, s_src, s_dst, seg_max, src, dst, mask = ctx.saved_tensors
        dh, ds_src, ds_dst = (torch.zeros_like(x) for x in (h, s_src, s_dst))
        for lo in range(0, src.shape[0], ctx.chunk):
            s, t, m = src[lo:lo + ctx.chunk], dst[lo:lo + ctx.chunk], \
                mask[lo:lo + ctx.chunk]
            hs = h.index_select(0, s).requires_grad_(True)
            ps = s_src.index_select(0, s).requires_grad_(True)
            pt = s_dst.index_select(0, t).requires_grad_(True)
            with torch.enable_grad():
                e = torch.where(m[:, None], _leaky_relu(ps + pt, ctx.slope),
                                float("-inf"))
                z = torch.where(m[:, None],
                                torch.exp(e - seg_max.index_select(0, t)),
                                0.0)
                msg = z[:, :, None] * hs
                d_hs, d_ps, d_pt = torch.autograd.grad(
                    (z, msg), (hs, ps, pt),
                    (g_denom.index_select(0, t), g_agg.index_select(0, t)))
            dh.index_add_(0, s, d_hs)
            ds_src.index_add_(0, s, d_ps)
            ds_dst.index_add_(0, t, d_pt)
        return dh, ds_src, ds_dst, None, None, None, None, None, None


def _gat_layer(p: dict, x: torch.Tensor, src: torch.Tensor,
               dst: torch.Tensor, edge_mask: torch.Tensor, n_nodes: int,
               n_heads: int, slope: float, mean_heads: bool,
               edge_chunk: Optional[int] = None) -> torch.Tensor:
    """One GAT layer over an edge list; ``edge_chunk`` (edges) runs the
    edges in chunks with the backward's recomputation, None in one piece
    under plain autograd."""
    H = n_heads
    h = (x @ p["w"]).reshape(x.shape[0], H, -1)
    s_src = torch.einsum("nhd,hd->nh", h, p["a_src"])           # [N, H]
    s_dst = torch.einsum("nhd,hd->nh", h, p["a_dst"])
    src_c = torch.where(src >= 0, src, 0)
    dst_c = torch.where(dst >= 0, dst, 0)
    E = src.shape[0]
    seg_max = _segment_max(s_src, s_dst, src_c, dst_c, edge_mask, slope,
                           n_nodes, edge_chunk or max(E, 1))
    if edge_chunk is None:
        z = _edge_z(s_src, s_dst, seg_max, src_c, dst_c, edge_mask, slope)
        denom = torch.zeros((n_nodes, H), dtype=h.dtype,
                            device=h.device).index_add(0, dst_c, z)
        msg = z[:, :, None] * h.index_select(0, src_c)           # [E, H, d]
        agg = torch.zeros((n_nodes, H, h.shape[2]), dtype=h.dtype,
                          device=h.device).index_add(0, dst_c, msg)
    else:
        denom, agg = _EdgeAggregate.apply(h, s_src, s_dst, seg_max, src_c,
                                          dst_c, edge_mask, slope,
                                          int(edge_chunk))
    out = agg / torch.clamp_min(denom[:, :, None], 1e-9)
    if mean_heads:
        return out.mean(1)                                      # final layer
    out = F.elu(out)
    return out.reshape(x.shape[0], -1) + p["b"]


def forward(cfg: GATConfig, params: dict, x: torch.Tensor,
            src: torch.Tensor, dst: torch.Tensor,
            edge_mask: Optional[torch.Tensor] = None,
            edge_chunk: Optional[int] = None) -> torch.Tensor:
    """x f32[N, d_in]; src/dst int32[E] (−1 = padding) → logits.

    Node-level: [N, n_classes].  With cfg.readout == "mean" callers follow
    with ``graph_readout``.
    """
    if edge_mask is None:
        edge_mask = src >= 0
    n_nodes = x.shape[0]
    for i in range(cfg.n_layers):
        x = _gat_layer(params[f"layer{i}"], x, src, dst, edge_mask, n_nodes,
                       cfg.n_heads, cfg.negative_slope,
                       mean_heads=i == cfg.n_layers - 1,
                       edge_chunk=edge_chunk)
    return x


def graph_readout(node_logits: torch.Tensor, graph_ids: torch.Tensor,
                  n_graphs: int, node_mask: torch.Tensor) -> torch.Tensor:
    """Mean-pool node representations per graph (molecule cell)."""
    gid = torch.where(node_mask, graph_ids, n_graphs)
    kept = torch.where(node_mask[:, None], node_logits, 0.0)
    summed = torch.zeros((n_graphs + 1, kept.shape[1]), dtype=kept.dtype,
                         device=kept.device).index_add(0, gid, kept)
    counts = torch.zeros((n_graphs + 1,), dtype=torch.float32,
                         device=kept.device).index_add(
        0, gid, node_mask.float())
    return summed[:n_graphs] / torch.clamp_min(counts[:n_graphs, None], 1.0)


def loss_fn(cfg: GATConfig, params: dict, x, src, dst, labels, label_mask,
            graph_ids: Optional[torch.Tensor] = None, n_graphs: int = 0,
            node_mask: Optional[torch.Tensor] = None,
            edge_chunk: Optional[int] = None):
    """(mean NLL over ``label_mask``, {"acc"}) of the node logits or, with
    ``cfg.readout == "mean"``, of the per-graph readout."""
    logits = forward(cfg, params, x, src, dst, edge_chunk=edge_chunk)
    if cfg.readout == "mean":
        logits = graph_readout(logits, graph_ids, n_graphs, node_mask)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, labels.long()[:, None])[:, 0]
    nll = torch.where(label_mask, nll, 0.0)
    n = torch.clamp_min(label_mask.sum().float(), 1.0)
    acc = torch.where(label_mask, logits.argmax(-1) == labels, False).sum() / n
    return nll.sum() / n, {"acc": acc}


def edge_bytes(cfg: GATConfig, chunked: bool) -> int:
    """Bytes an edge costs a train step: in one piece, what autograd keeps
    of every layer's per-edge tensors (z, e, the gathered h[src] and the
    messages, f32); chunked, what one chunk of the widest layer holds at
    once in the backward (h[src], the messages, their gradients)."""
    per_layer = [cfg.n_heads * d_out for _, d_out in cfg.layer_dims]
    if chunked:
        return 4 * (6 * max(per_layer) + 16 * cfg.n_heads) + 32
    return sum(4 * (3 * hd + 8 * cfg.n_heads) for hd in per_layer) + 32


def node_bytes(cfg: GATConfig) -> int:
    """Bytes a node costs a train step: its features and, each layer, the
    node tensors and their gradients (h, the aggregate, the output; the
    scores, max and denominator), f32."""
    return 4 * (cfg.d_in + sum(6 * cfg.n_heads * d_out + 8 * cfg.n_heads
                               for _, d_out in cfg.layer_dims))


def plan_edge_chunk(cfg: GATConfig, n_nodes: int, n_edges: int,
                    card_bytes: int) -> Optional[int]:
    """The edge chunk one card of ``card_bytes`` holds in a train step:
    None when the edge list fits in one piece, else the most edges (a
    multiple of 2¹⁶) whose chunk fits beside the node tensors; raises
    ``SystemExit`` naming the bytes when the node tensors alone do not
    fit."""
    room = int(CARD_SHARE * card_bytes) - n_nodes * node_bytes(cfg)
    if n_edges * edge_bytes(cfg, chunked=False) <= room:
        return None
    chunk = room // edge_bytes(cfg, chunked=True) // (1 << 16) * (1 << 16)
    if chunk <= 0:
        raise SystemExit(
            f"[gnn] {cfg.name}: {n_nodes:,} nodes take "
            f"{n_nodes * node_bytes(cfg):,} bytes of node tensors, against "
            f"{int(CARD_SHARE * card_bytes):,} usable of the card's "
            f"{card_bytes:,}")
    return int(min(chunk, n_edges))
