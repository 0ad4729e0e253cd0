"""dien — deep interest evolution (GRU + AUGRU).  [arXiv:1809.03672;
unverified]  embed 18, seq 100, gru 108, MLP 200-80."""

import torch

from repro_torch.configs.base import ArchSpec, recsys_shapes, register
from repro_torch.models.recsys import DIENConfig

ARCH = register(ArchSpec(
    id="dien",
    family="recsys",
    model_cfg=DIENConfig(
        name="dien", n_items=1 << 22, n_cats=1 << 12, embed_dim=18,
        seq_len=100, gru_dim=108, mlp_dims=(200, 80), dtype=torch.float32),
    shapes=recsys_shapes(),
    source="arXiv:1809.03672; unverified",
    smoke_cfg=DIENConfig(name="dien-smoke", n_items=2048, n_cats=64,
                         embed_dim=8, seq_len=12, gru_dim=24,
                         mlp_dims=(32, 16)),
))
