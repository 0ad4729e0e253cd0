"""Plain reference of the synth-d960 configuration: the exact k nearest
corpus points of each query by L2 distance, worked out in float64 over the
whole corpus (``control=True``: in float32 with TF32 products, the
precision below the configuration's float32)."""

from pbench import annref


def exact_knn(base, queries, k: int, control: bool = False):
    """(ids int64 [Q, k], distances [Q, k]) ascending, ties to the lower
    id."""
    return annref.exact_topk(base, queries, k, "l2", control=control)
