"""phi3-mini-3.8b — dense, RoPE/SwiGLU/GQA (kv=32 → MHA-like).
[arXiv:2404.14219; unverified]"""

import torch

from repro_torch.configs.base import ArchSpec, lm_shapes, register
from repro_torch.models.transformer import LMConfig

ARCH = register(ArchSpec(
    id="phi3-mini-3.8b",
    family="lm",
    model_cfg=LMConfig(
        name="phi3-mini-3.8b",
        n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, head_dim=96,
        d_ff=8192, vocab=32064, dtype=torch.bfloat16,
    ),
    shapes=lm_shapes(sub_quadratic=False, accum_train=8),
    source="arXiv:2404.14219; unverified",
    smoke_cfg=LMConfig(
        name="phi3-smoke", n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, vocab=512, dtype=torch.float32),
))
