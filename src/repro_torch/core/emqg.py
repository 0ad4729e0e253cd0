"""δ-EMQG assembly (Sec. 6.1): approximate δ-EMG + RaBitQ codes with
degree-aligned neighborhoods.  Counterpart of ``repro.core.emqg``.

The RaBitQ rotation is passed in, or drawn from a ``torch.Generator``
(seeded from ``BuildParams.seed`` when none is given).  The JAX package
draws it from ``jax.random``, which PyTorch cannot reproduce, so a build
that must match the reference takes the reference's rotation.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import rabitq
from .build_approx import (BuildParams, BuildPhases, approx_graph,
                           on_device)
from .types import EMQGIndex, GraphIndex


def _rotation(dim: int, generator, rotation, seed: int, device):
    if rotation is not None:
        if not isinstance(rotation, torch.Tensor):
            rotation = torch.from_numpy(np.array(rotation, np.float32))
        return rotation.to(device, torch.float32)
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    return rabitq.random_rotation(dim, generator, device=device)


def build_emqg(vectors, params: Optional[BuildParams] = None,
               generator: Optional[torch.Generator] = None,
               rotation=None, verbose: bool = False, metrics=None,
               device="cuda", tracer=None) -> EMQGIndex:
    """Full δ-EMQG build on ``device``: Algorithm 4 with degree alignment,
    then RaBitQ codes under ``rotation`` (or one drawn from
    ``generator``).  ``metrics`` and ``tracer`` observe as
    ``build_approx``'s, the codes in a ``build.quantize`` span."""
    if params is None:
        params = BuildParams(align_degree=True)
    elif not params.align_degree:
        params = dataclasses.replace(params, align_degree=True)
    vectors = on_device(vectors, device)
    phases = BuildPhases(vectors.device, metrics, tracer)
    with phases("build", n=vectors.shape[0]):
        graph = approx_graph(vectors, params, phases, verbose, metrics)
        with phases("build.quantize"):
            rot = _rotation(graph.dim, generator, rotation, params.seed,
                            graph.device)
            codes = rabitq.fit(graph.vectors, rot)
    return EMQGIndex(graph=graph, codes=codes)


def from_graph(graph: GraphIndex, generator: Optional[torch.Generator] = None,
               rotation=None) -> EMQGIndex:
    """Attach RaBitQ codes to an existing graph, on the graph's device."""
    rot = _rotation(graph.dim, generator, rotation, 0, graph.device)
    return EMQGIndex(graph=graph, codes=rabitq.fit(graph.vectors, rot))


def memory_footprint(index: EMQGIndex) -> dict:
    """Bytes per component — the paper's Fig. 4 'index size' accounting."""
    g, c = index.graph, index.codes
    return {
        "vectors": g.vectors.numel() * g.vectors.element_size(),
        "adjacency": g.neighbors.numel() * 4,
        "codes": c.codes.numel() * 4,
        "code_scalars": (c.norms.numel() + c.ip_xo.numel()) * 4,
        "rotation": c.rotation.numel() * 4,
    }
