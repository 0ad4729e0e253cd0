"""dcn-v2 — cross network v2.  [arXiv:2008.13535; paper]
13 dense + 26 sparse × 16, 3 cross layers, MLP 1024-1024-512."""

import torch

from repro_torch.configs.base import ArchSpec, recsys_shapes, register
from repro_torch.models.recsys import DCNConfig

ARCH = register(ArchSpec(
    id="dcn-v2",
    family="recsys",
    model_cfg=DCNConfig(
        name="dcn-v2", n_dense=13, n_sparse=26, rows=1 << 21, embed_dim=16,
        n_cross=3, mlp_dims=(1024, 1024, 512), dtype=torch.float32),
    shapes=recsys_shapes(),
    source="arXiv:2008.13535; paper",
    smoke_cfg=DCNConfig(name="dcn-smoke", n_dense=13, n_sparse=26, rows=512,
                        embed_dim=8, n_cross=2, mlp_dims=(64, 32)),
))
