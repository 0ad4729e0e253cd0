"""smollm-135m — llama-arch small dense.  [hf:HuggingFaceTB/SmolLM-135M; hf]"""

import torch

from repro_torch.configs.base import ArchSpec, lm_shapes, register
from repro_torch.models.transformer import LMConfig

ARCH = register(ArchSpec(
    id="smollm-135m",
    family="lm",
    model_cfg=LMConfig(
        name="smollm-135m",
        n_layers=30, d_model=576, n_heads=9, n_kv_heads=3, head_dim=64,
        d_ff=1536, vocab=49152, dtype=torch.bfloat16,
    ),
    shapes=lm_shapes(sub_quadratic=False, accum_train=4),
    source="hf:HuggingFaceTB/SmolLM-135M; hf",
    smoke_cfg=LMConfig(
        name="smollm-smoke", n_layers=3, d_model=48, n_heads=3, n_kv_heads=3,
        head_dim=16, d_ff=128, vocab=512, dtype=torch.float32),
))
