"""CSR graph container + fanout neighbor sampler (GraphSAGE-style) for the
``minibatch_lg`` GNN cell.  The sampler is host-side numpy — samplers
are irregular and feed the card with fixed-shape padded subgraphs.

A copy of the JAX package's ``repro.data.sampler``: the same seed gives
the same subgraph, bit for bit.  ``fanout_sample`` returns a two-hop
(configurable) sampled subgraph with locally re-indexed, padded edge
arrays, ready for ``models.gnn.forward``.  ``CSRGraph.from_edges`` sorts
the edges on a device, by a stable sort: the reference's order.  Like the
reference it cuts a
subgraph that outgrows ``pad_nodes`` / ``pad_edges`` without a word;
``n_sub_nodes`` and ``n_sub_edges`` give the uncut sizes, and a caller
that must not lose edges checks them against the pads.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.types import resolve_device


@dataclasses.dataclass
class CSRGraph:
    indptr: np.ndarray     # int64[n+1]
    indices: np.ndarray    # int32[nnz]

    @property
    def n_nodes(self) -> int:
        return self.indptr.shape[0] - 1

    @staticmethod
    def from_edges(src: np.ndarray, dst: np.ndarray, n_nodes: int,
                   device="cuda") -> "CSRGraph":
        """The edges ordered by destination as the reference's stable
        ``argsort`` orders them, and the row pointers: sorted on
        ``device`` in torch (a second on the card at 10⁸ edges, against
        ten for numpy's sort on the host), the arrays on the host."""
        dev = resolve_device(device)
        d, order = torch.sort(torch.from_numpy(np.asarray(dst)).to(dev).long(),
                              stable=True)
        s = torch.from_numpy(np.asarray(src)).to(dev)[order]
        indptr = torch.searchsorted(d, torch.arange(n_nodes + 1, device=dev))
        return CSRGraph(indptr=indptr.cpu().numpy(),
                        indices=s.cpu().numpy().astype(np.int32))

    def sample_neighbors(self, nodes: np.ndarray, fanout: int,
                         rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
        """Up to ``fanout`` in-neighbors per node → (src, dst) edge arrays."""
        srcs, dsts = [], []
        for v in nodes:
            lo, hi = self.indptr[v], self.indptr[v + 1]
            deg = hi - lo
            if deg == 0:
                continue
            k = min(fanout, int(deg))
            sel = rng.choice(int(deg), size=k, replace=False)
            srcs.append(self.indices[lo + sel])
            dsts.append(np.full(k, v, np.int32))
        if not srcs:
            return np.empty(0, np.int32), np.empty(0, np.int32)
        return np.concatenate(srcs), np.concatenate(dsts)


def fanout_sample(graph: CSRGraph, feats: np.ndarray, labels: np.ndarray,
                  batch_nodes: np.ndarray, fanouts: tuple[int, ...],
                  seed: int = 0, pad_nodes: int | None = None,
                  pad_edges: int | None = None) -> dict:
    """Multi-hop fanout sampling with local re-indexing and fixed-shape
    padding.  Returns x/src/dst/labels/label_mask arrays (padded slots get
    src=dst=-1 and label_mask False)."""
    rng = np.random.default_rng(seed)
    frontier = batch_nodes.astype(np.int32)
    all_src, all_dst = [], []
    seen = dict((int(v), i) for i, v in enumerate(frontier))
    order = list(frontier)
    for f in fanouts:
        s, d = graph.sample_neighbors(np.unique(frontier), f, rng)
        all_src.append(s)
        all_dst.append(d)
        nxt = []
        for v in s:
            if int(v) not in seen:
                seen[int(v)] = len(order)
                order.append(int(v))
                nxt.append(int(v))
        frontier = np.asarray(nxt, np.int32) if nxt else np.empty(0, np.int32)
        if frontier.size == 0:
            break
    src = np.concatenate(all_src) if all_src else np.empty(0, np.int32)
    dst = np.concatenate(all_dst) if all_dst else np.empty(0, np.int32)
    remap = np.vectorize(seen.__getitem__, otypes=[np.int64])
    src_l = remap(src).astype(np.int32) if src.size else src
    dst_l = remap(dst).astype(np.int32) if dst.size else dst
    nodes = np.asarray(order, np.int64)

    n_sub, e_sub = nodes.size, src_l.size
    pad_nodes = pad_nodes or n_sub
    pad_edges = pad_edges or e_sub
    x = np.zeros((pad_nodes, feats.shape[1]), np.float32)
    x[:n_sub] = feats[nodes[:pad_nodes]]
    ps = np.full(pad_edges, -1, np.int32)
    pd = np.full(pad_edges, -1, np.int32)
    ps[:min(e_sub, pad_edges)] = src_l[:pad_edges]
    pd[:min(e_sub, pad_edges)] = dst_l[:pad_edges]
    lab = np.zeros(pad_nodes, np.int32)
    lab[:n_sub] = labels[nodes[:pad_nodes]]
    lmask = np.zeros(pad_nodes, bool)
    lmask[:batch_nodes.size] = True        # supervise only the seed nodes
    return {"x": x, "src": ps, "dst": pd, "labels": lab, "label_mask": lmask,
            "n_sub_nodes": n_sub, "n_sub_edges": e_sub}
