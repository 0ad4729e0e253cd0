"""internlm2-20b — dense GQA decoder.  [arXiv:2403.17297; hf]"""

import torch

from repro_torch.configs.base import ArchSpec, lm_shapes, register
from repro_torch.models.transformer import LMConfig

ARCH = register(ArchSpec(
    id="internlm2-20b",
    family="lm",
    model_cfg=LMConfig(
        name="internlm2-20b",
        n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
        d_ff=16384, vocab=92544, dtype=torch.bfloat16,
    ),
    shapes=lm_shapes(sub_quadratic=False, accum_train=16),
    source="arXiv:2403.17297; hf",
    smoke_cfg=LMConfig(
        name="internlm2-smoke", n_layers=3, d_model=96, n_heads=6,
        n_kv_heads=2, head_dim=16, d_ff=192, vocab=512, dtype=torch.float32),
))
