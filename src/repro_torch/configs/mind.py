"""mind — multi-interest network w/ dynamic (capsule) routing.
[arXiv:1904.08030; unverified]  embed 64, 4 interests, 3 routing iters.
The δ-EMQG integration: the user's interests are per-interest MIPS
queries against the item-embedding corpus (``core.mips``)."""

import torch

from repro_torch.configs.base import ArchSpec, recsys_shapes, register
from repro_torch.models.recsys import MINDConfig

ARCH = register(ArchSpec(
    id="mind",
    family="recsys",
    model_cfg=MINDConfig(
        name="mind", n_items=1 << 23, embed_dim=64, n_interests=4,
        routing_iters=3, seq_len=50, n_neg=16, dtype=torch.float32),
    shapes=recsys_shapes(),
    source="arXiv:1904.08030; unverified",
    smoke_cfg=MINDConfig(name="mind-smoke", n_items=2048, embed_dim=16,
                         n_interests=4, routing_iters=3, seq_len=12, n_neg=4),
))
