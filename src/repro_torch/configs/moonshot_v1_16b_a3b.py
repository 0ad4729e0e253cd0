"""moonshot-v1-16b-a3b — Moonlight/Kimi-style fine-grained MoE.
[hf:moonshotai/Moonlight-16B-A3B; hf]  64 experts top-6, 2 shared experts,
first layer dense (DeepSeek-V3 recipe).  The reference's dims (48 layers,
~28B total / ~5.6B active; the HF release has 27 layers)."""

import torch

from repro_torch.configs.base import ArchSpec, lm_shapes, register
from repro_torch.models.transformer import LMConfig

ARCH = register(ArchSpec(
    id="moonshot-v1-16b-a3b",
    family="lm",
    model_cfg=LMConfig(
        name="moonshot-v1-16b-a3b",
        n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
        d_ff=1408, vocab=163840,
        n_experts=64, top_k=6, n_shared_experts=2,
        moe_period=1, first_dense=1,
        dtype=torch.bfloat16,
    ),
    shapes=lm_shapes(sub_quadratic=False, accum_train=8),
    source="hf:moonshotai/Moonlight-16B-A3B; hf",
    smoke_cfg=LMConfig(
        name="moonshot-smoke", n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=96, vocab=512, n_experts=8, top_k=2,
        n_shared_experts=1, moe_period=1, first_dense=1, dtype=torch.float32),
))
