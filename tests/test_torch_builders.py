"""The port's baseline builders against the JAX package's, on the same
corpus and parameters.

``build_knn_graph`` is exact brute force: identical lists.  The others run
``build_approx``'s machinery (or NSW's wave-batched insertion), whose kNN
bootstrap and pairwise distances take the norm identity through a matmul
that sums in another order in the two frameworks; a last-bit difference
can swap two near-tied neighbors and the refinement carries it on, so the
bar is the one ``build_emqg`` meets: ≥ 95% identical rows and the same
medoid and kind.  The nodes reachable from the medoid are the
reference's: at M = 12 its NSW repair leaves a few of the 600 nodes
unreachable (an eviction can cut a node that an earlier link had reached,
ROADMAP C.5), and the port's leaves the same ones.
"""

import numpy as np
import pytest
import torch
from repro.core import baselines as rbl
from repro.core.build_approx import _bfs_reachable as ref_bfs_reachable

from repro_torch.core import baselines as tbl
from repro_torch.core.build_approx import _bfs_reachable

from conftest import gmm

# several test workers share the host's cores; one intra-op thread each
# keeps them from oversubscribing it
torch.set_num_threads(1)

KW = {"knn": dict(k=12), "nsw": dict(max_degree=12, ef=24, wave=128)}
APPROX_KW = dict(max_degree=12, beam_width=24)


@pytest.fixture(scope="module")
def base():
    return gmm(600, 16, 8, seed=21)


@pytest.mark.parametrize("name", ["knn", "nsg", "tau_mg", "vamana", "nsw"])
def test_builder_matches_reference(base, name):
    kw = KW.get(name, APPROX_KW)
    ref = rbl.BUILDERS[name](base, **kw)
    port = tbl.BUILDERS[name](base, device="cpu", **kw)
    r_nbr, t_nbr = np.asarray(ref.neighbors), port.neighbors.numpy()
    assert t_nbr.shape == r_nbr.shape
    same = (r_nbr == t_nbr).all(1).mean()
    assert same == 1.0 if name == "knn" else same >= 0.95, same
    assert port.medoid == int(ref.medoid)
    assert (port.kind, port.delta) == (ref.kind, ref.delta)
    np.testing.assert_array_equal(
        _bfs_reachable(port.neighbors, port.medoid).numpy(),
        ref_bfs_reachable(r_nbr, int(ref.medoid)))
