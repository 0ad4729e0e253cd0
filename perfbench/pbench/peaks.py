"""Published peaks of the card the cells run on, and the frozen counts of
useful work that the per-layer metrics divide by them.

NVIDIA H100 SXM (data sheet, dense rates, at the 700 W power limit):
67 TFLOP/s float32 outside the tensor cores, 3.35 TB/s of HBM3.
The port's ANN kernels run in float32 on the CUDA cores, so the float32 peak is the one their FLOPs are held to.
"""

from __future__ import annotations

H100_FP32_FLOPS = 67e12
H100_HBM_BYTES_PER_S = 3.35e12


def ann_serve_flops(batch: int, shards: int, l_max: int, dim: int) -> float:
    """Frozen copy of the port's ``launch.steps._ann_model_flops``: the
    dense cost of an exact rerank of ``l_max`` candidates a query and
    shard, B · S · l_max · 2 · dim (the useful-work floor of the probing
    search)."""
    return batch * shards * l_max * 2.0 * dim

