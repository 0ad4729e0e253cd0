"""The benchmark's inputs, made from fixed seeds on the device.

``subspace_law`` and ``subspace_points`` draw a corpus of low local
intrinsic dimension: clusters, each a ``rank``-dimensional random subspace
through its centre, with a little isotropic noise on top.  Embeddings and
descriptors that users index lie near such manifolds; points drawn
isotropically in all ``dim`` coordinates do not (their nearest neighbours
are all but equidistant, and a graph search over them runs far longer and
finds less than on any deployed corpus).  Queries are drawn from the same
law with a stream of their own, so none is a corpus point.  The generator
is the benchmark's own: a change to the program cannot change it.
"""

from __future__ import annotations

import numpy as np
import torch


def rng_for(*key: int) -> np.random.Generator:
    """A numpy generator keyed by whole numbers of any size."""
    return np.random.default_rng([int(k) for k in key])


def generator(device, *key: int) -> torch.Generator:
    """A torch generator on ``device`` keyed by whole numbers of any size
    (folded to 63 bits through numpy's seed sequence)."""
    seed = int(rng_for(*key).integers(0, 2 ** 63 - 1))
    return torch.Generator(device=device).manual_seed(seed)


def subspace_law(dim: int, n_clusters: int, rank: int, center_std: float,
                 gen: torch.Generator) -> dict:
    """The clusters' centres ``[C, dim]`` (N(0, center_std²)) and bases
    ``[C, dim, rank]`` (N(0, 1/dim): near orthonormal columns)."""
    dev = gen.device
    centres = torch.randn((n_clusters, dim), generator=gen, device=dev) \
        * center_std
    bases = torch.randn((n_clusters, dim, rank), generator=gen, device=dev) \
        / dim ** 0.5
    return {"centres": centres, "bases": bases}


def subspace_points(law: dict, n: int, spread: float, noise: float,
                    gen: torch.Generator, assign=None) -> torch.Tensor:
    """``n`` float32 points of ``law``: centre + basis · z (z ~ N(0,
    spread²) in ``rank`` coordinates) + N(0, noise²) in every coordinate.
    ``assign`` gives each point's cluster; by default it is drawn
    uniformly."""
    centres, bases = law["centres"], law["bases"]
    C, dim, rank = bases.shape
    dev = gen.device
    if assign is None:
        assign = torch.randint(0, C, (n,), generator=gen, device=dev)
    z = torch.randn((n, rank), generator=gen, device=dev) * spread
    x = centres[assign] + torch.randn((n, dim), generator=gen,
                                      device=dev) * noise
    for j in range(rank):                 # rank gathers of [n, dim]
        x += z[:, j:j + 1] * bases[:, :, j][assign]
    return x.contiguous()

