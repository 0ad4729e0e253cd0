"""Carry an index built by the JAX package across into this port.

``index_from_numpy`` takes the reference index's fields as numpy arrays
(``np.asarray`` of each) and returns the port's ``GraphIndex`` — or, given
the RaBitQ fields too, ``EMQGIndex`` — on ``device``.  The ``uint32`` code
words become their ``int32`` view, bit for bit.  Nothing here imports the
JAX package; the caller converts.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .core.types import EMQGIndex, GraphIndex, RaBitQCodes, resolve_device


def index_from_numpy(vectors, neighbors, medoid, kind: str = "delta_emg",
                     delta: float = 0.0, codes=None, norms=None, ip_xo=None,
                     rotation=None, center=None, dim: Optional[int] = None,
                     device="cuda"):
    """GraphIndex from (vectors, neighbors, medoid, kind, delta); EMQGIndex
    when ``codes`` (uint32[n, W]) and the other RaBitQ fields are given."""
    dev = resolve_device(device)

    def f32(x):
        return torch.from_numpy(np.array(x, np.float32)).to(dev).contiguous()

    graph = GraphIndex(
        vectors=f32(vectors),
        neighbors=torch.from_numpy(np.array(neighbors, np.int32)).to(dev),
        medoid=int(np.asarray(medoid)), kind=kind, delta=float(delta))
    if codes is None:
        return graph
    words = np.array(codes, np.uint32).view(np.int32)
    rq = RaBitQCodes(
        codes=torch.from_numpy(words).to(dev), norms=f32(norms),
        ip_xo=f32(ip_xo), rotation=f32(rotation), center=f32(center),
        dim=int(dim if dim is not None else graph.dim))
    return EMQGIndex(graph=graph, codes=rq)
