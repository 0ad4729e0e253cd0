"""llama4-maverick-400b-a17b — MoE with alternating dense/MoE layers
(moe_period=2: ~400B total / 17B active), 1 shared expert per MoE layer,
sliding-window attention 8192 with window_period 4.  [hf:meta-llama/
Llama-4-*; unverified]  The reference's window rule windows every layer of
this config (ROADMAP C.6); the port reproduces it."""

import torch

from repro_torch.configs.base import ArchSpec, lm_shapes, register
from repro_torch.models.transformer import LMConfig

ARCH = register(ArchSpec(
    id="llama4-maverick-400b-a17b",
    family="lm",
    model_cfg=LMConfig(
        name="llama4-maverick-400b-a17b",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
        d_ff=8192, vocab=202048,
        n_experts=128, top_k=1, n_shared_experts=1,
        moe_period=2, first_dense=0,
        window=8192, window_period=4,
        dtype=torch.bfloat16,
    ),
    shapes=lm_shapes(sub_quadratic=True, accum_train=4),
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
    smoke_cfg=LMConfig(
        name="llama4-smoke", n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=96, vocab=512, n_experts=8, top_k=1,
        n_shared_experts=1, moe_period=2, first_dense=0, window=16,
        window_period=4, dtype=torch.float32),
))
