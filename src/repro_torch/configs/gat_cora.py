"""gat-cora — 2-layer GAT (8 hidden × 8 heads).  [arXiv:1710.10903; paper]

The model dims follow the GAT paper; input features / classes vary per
shape cell (cora / reddit-minibatch / ogb_products / molecule), so
``model_cfg`` here is a dict of per-shape GATConfigs.
"""

import torch

from repro_torch.configs.base import ArchSpec, ShapeSpec, register
from repro_torch.models.gnn import GATConfig


def _cfg(d_in, n_classes, readout=None):
    return GATConfig(name="gat-cora", n_layers=2, d_hidden=8, n_heads=8,
                     d_in=d_in, n_classes=n_classes, readout=readout,
                     dtype=torch.float32)


SHAPE_CFGS = {
    "full_graph_sm": _cfg(1433, 7),
    "minibatch_lg": _cfg(602, 41),          # reddit-scale sampled training
    "ogb_products": _cfg(100, 47),
    "molecule": _cfg(32, 2, readout="mean"),
}

ARCH = register(ArchSpec(
    id="gat-cora",
    family="gnn",
    model_cfg=SHAPE_CFGS,
    shapes={
        "full_graph_sm": ShapeSpec(
            "full_graph_sm", "full_graph",
            {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433,
             "n_classes": 7}),
        "minibatch_lg": ShapeSpec(
            "minibatch_lg", "minibatch",
            # padded two-hop fanout(15,10) subgraph of reddit
            {"n_nodes": 232965, "n_edges": 114615892, "batch_nodes": 1024,
             "fanout": (15, 10), "d_feat": 602, "n_classes": 41,
             "pad_nodes": 180224, "pad_edges": 180224}),
        "ogb_products": ShapeSpec(
            "ogb_products", "full_graph",
            {"n_nodes": 2449029, "n_edges": 61859140, "d_feat": 100,
             "n_classes": 47}),
        "molecule": ShapeSpec(
            "molecule", "molecule",
            {"n_nodes": 30, "n_edges": 64, "batch": 128, "d_feat": 32,
             "n_classes": 2}),
    },
    source="arXiv:1710.10903; paper",
    smoke_cfg=_cfg(16, 4),
))
