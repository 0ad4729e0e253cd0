"""fm — factorization machine, O(nk) sum-square pairwise term.
[ICDM'10 (Rendle); paper]  39 sparse fields, embed 10."""

import torch

from repro_torch.configs.base import ArchSpec, recsys_shapes, register
from repro_torch.models.recsys import FMConfig

ARCH = register(ArchSpec(
    id="fm",
    family="recsys",
    model_cfg=FMConfig(name="fm", n_sparse=39, rows=1 << 21, embed_dim=10,
                       dtype=torch.float32),
    shapes=recsys_shapes(),
    source="ICDM'10 (Rendle); paper",
    smoke_cfg=FMConfig(name="fm-smoke", n_sparse=39, rows=512, embed_dim=10),
))
