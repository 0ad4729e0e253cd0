"""The port's search engines against the JAX package's, on indexes the JAX
package built and ``repro_torch.interop`` carried across.

At beam_width 1 the port meets the parity bar: ids identical, distances to
1e-4, and ``n_dist_comps``, ``n_approx_comps``, ``n_hops``,
``n_encounters``, ``final_l`` and ``saturated`` identical.  At W = 4 the
engines go through the oracle checks of ``tests/test_conformance.py``:
the (1/δ) bound on an exact Alg.-2 graph, honesty, and the metamorphic
case of a query equal to a corpus point.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.core import BuildParams as RefBuildParams
from repro.core import SearchParams as RefSearchParams
from repro.core import ags_search as ref_ags
from repro.core import build_approx as ref_build_approx
from repro.core import build_exact as ref_build_exact
from repro.core import error_bounded_probing_search as ref_eb_probing
from repro.core import error_bounded_search as ref_eb_search
from repro.core import greedy_search as ref_greedy
from repro.core import memory_footprint as ref_memory_footprint
from repro.core import probing_search as ref_probing
from repro.core import search as ref_search
from repro.core.emqg import from_graph as ref_from_graph
from repro.testing.oracle import check_delta_bound, exact_knn

from repro_torch.core import (
    SearchParams,
    ags_search,
    error_bounded_probing_search,
    error_bounded_search,
    greedy_search,
    memory_footprint,
    probing_search,
    search,
)
from repro_torch.interop import index_from_numpy

from conftest import gmm

# several test workers share the host's cores; one intra-op thread each
# keeps them from oversubscribing it
torch.set_num_threads(1)

DELTA = 0.2
K = 5
COUNTERS = ("n_dist_comps", "n_approx_comps", "n_hops", "n_encounters",
            "final_l", "saturated")


def to_port(index, device="cpu"):
    """The port's copy of a JAX-package GraphIndex or EMQGIndex."""
    g = getattr(index, "graph", index)
    fields = dict(vectors=np.asarray(g.vectors), neighbors=np.asarray(g.neighbors),
                  medoid=np.asarray(g.medoid), kind=g.kind, delta=g.delta)
    if hasattr(index, "codes"):
        c = index.codes
        fields.update(codes=np.asarray(c.codes), norms=np.asarray(c.norms),
                      ip_xo=np.asarray(c.ip_xo), rotation=np.asarray(c.rotation),
                      center=np.asarray(c.center), dim=c.dim)
    return index_from_numpy(**fields, device=device)


def params(beam_width=1, l_max=32, max_hops=256):
    kw = dict(k=K, l0=8, l_max=l_max, alpha=1.2, adaptive=True,
              max_hops=max_hops, beam_width=beam_width)
    return RefSearchParams(**kw), SearchParams(**kw)


def assert_parity(ref_res, port_res):
    np.testing.assert_array_equal(port_res.ids.numpy(), np.asarray(ref_res.ids))
    np.testing.assert_allclose(port_res.dists.numpy(), np.asarray(ref_res.dists),
                               rtol=1e-4, atol=1e-4)
    for name in COUNTERS:
        np.testing.assert_array_equal(
            getattr(port_res, name).numpy(), np.asarray(getattr(ref_res, name)),
            err_msg=name)


@pytest.fixture(scope="module")
def approx():
    """A build_approx graph and its δ-EMQG, built by the JAX package."""
    base = gmm(600, 16, 8, seed=21)
    queries = gmm(16, 16, 8, seed=22)
    g = ref_build_approx(base, RefBuildParams(max_degree=12, beam_width=24,
                                              t=12, iters=2, block=256))
    emqg = ref_from_graph(g, jax.random.PRNGKey(3))
    return {"base": base, "queries": queries, "ref": emqg,
            "port": to_port(emqg)}


def test_interop_carries_every_field(approx):
    ref, port = approx["ref"], approx["port"]
    np.testing.assert_array_equal(port.graph.neighbors.numpy(),
                                  np.asarray(ref.graph.neighbors))
    assert port.graph.medoid == int(ref.graph.medoid)
    assert port.graph.kind == ref.graph.kind
    np.testing.assert_array_equal(port.codes.codes.numpy().view(np.uint32),
                                  np.asarray(ref.codes.codes))
    assert port.codes.dim == ref.codes.dim


@pytest.mark.parametrize("faithful", [False, True])
def test_search_parity_w1(approx, faithful):
    rp, tp = params()
    q = approx["queries"]
    r = ref_search(approx["ref"].graph, jnp.asarray(q), rp,
                   faithful_prune=faithful, backend="jnp")
    t = search(approx["port"].graph, q, tp, faithful_prune=faithful,
               backend="jnp")
    assert_parity(r, t)


@pytest.mark.parametrize("backend", ["auto", "kernel", "kernel_tiled"])
def test_search_backends_agree_on_cpu(approx, backend):
    """Every backend name exists; on CPU tensors each runs the plain path."""
    _, tp = params()
    base = search(approx["port"].graph, approx["queries"], tp, backend="jnp")
    other = search(approx["port"].graph, approx["queries"], tp,
                   backend=backend)
    assert torch.equal(base.ids, other.ids)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_probing_parity_w1(approx, use_kernel):
    rp, tp = params()
    q = approx["queries"]
    r = ref_probing(approx["ref"], jnp.asarray(q), rp, use_kernel=use_kernel,
                    backend="jnp")
    t = probing_search(approx["port"], q, tp, use_kernel=use_kernel,
                       backend="jnp")
    assert_parity(r, t)


def test_ags_parity_w1(approx):
    rp, tp = params()
    q = approx["queries"]
    assert_parity(ref_ags(approx["ref"], jnp.asarray(q), rp, backend="jnp"),
                  ags_search(approx["port"], q, tp, backend="jnp"))


def test_candidates_parity(approx):
    rp, tp = params()
    q = approx["queries"]
    _, r_ids, r_d = ref_search(approx["ref"].graph, jnp.asarray(q), rp,
                               with_candidates=True, backend="jnp")
    _, t_ids, t_d = search(approx["port"].graph, q, tp, with_candidates=True,
                           backend="jnp")
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(r_ids))
    np.testing.assert_allclose(t_d.numpy(), np.asarray(r_d), rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# W = 4: the oracle checks of tests/test_conformance.py.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def exact():
    """An exact Alg.-2 δ-EMG (δ = 0.2) built by the JAX package."""
    base = gmm(400, 16, 8, seed=0)
    queries = gmm(16, 16, 8, seed=1)
    g = ref_build_exact(jnp.asarray(base), delta=DELTA)
    emqg = ref_from_graph(g)
    return {"base": base, "queries": queries, "ref": emqg,
            "port": to_port(emqg), "oracle_d": exact_knn(base, queries, K)[0]}


def _run(engine, index, q, p, backend="jnp"):
    if engine == "beam":
        return search(index.graph, q, p, backend=backend)
    if engine == "faithful":
        return search(index.graph, q, p, faithful_prune=True, backend=backend)
    if engine == "probing":
        return probing_search(index, q, p, backend=backend)
    return ags_search(index, q, p, backend=backend)


def _assert_conformant(res, base, queries, oracle_d):
    ids, dists = res.ids.numpy(), res.dists.numpy()
    assert ((ids >= 0) & (ids < base.shape[0])).all()
    for row in ids:
        assert len(set(row.tolist())) == len(row)
    assert (np.diff(dists, axis=1) >= -1e-5).all()
    true = np.linalg.norm(base[ids] - queries[:, None, :], axis=-1)
    np.testing.assert_allclose(dists, true, rtol=1e-4, atol=1e-4)
    assert check_delta_bound(dists, oracle_d, DELTA) is None


@pytest.mark.parametrize("engine", ["beam", "faithful", "probing", "ags"])
@pytest.mark.parametrize("backend", ["jnp", "kernel_tiled"])
def test_delta_bound_w4(exact, engine, backend):
    _, tp = params(beam_width=4)
    res = _run(engine, exact["port"], exact["queries"], tp, backend)
    _assert_conformant(res, exact["base"], exact["queries"], exact["oracle_d"])


@pytest.mark.parametrize("engine", ["beam", "faithful", "probing", "ags"])
def test_query_equals_corpus_point(exact, engine):
    """q ∈ corpus ⇒ the (1/δ) bound forces distance 0 at rank 1.

    Shared departure (ROADMAP C.1): the JAX package's probing engine misses
    one of these 8 queries (Alg.-5's NeedProbing rule stops before the point
    is probed).  The port reproduces the reference exactly, the miss
    included, so for ``probing`` the test asserts parity with the reference
    and that the misses are the reference's; every other engine must meet
    the bound."""
    rng = np.random.default_rng(3)
    pick = rng.choice(exact["base"].shape[0], size=8, replace=False)
    q = exact["base"][pick]
    rp, tp = params()
    res = _run(engine, exact["port"], q, tp)
    dists = res.dists.numpy()
    if engine == "probing":
        ref = ref_probing(exact["ref"], jnp.asarray(q), rp, backend="jnp")
        assert_parity(ref, res)
        missed = dists[:, 0] >= 1e-3
        assert missed.sum() == 1          # the C.1 miss, reproduced
        np.testing.assert_array_equal(missed,
                                      np.asarray(ref.dists)[:, 0] >= 1e-3)
        return
    assert (dists[:, 0] < 1e-3).all()
    _assert_conformant(res, exact["base"], q,
                       exact_knn(exact["base"], q, K)[0])


@pytest.mark.parametrize("entry", ["greedy", "error_bounded",
                                   "error_bounded_probing"])
def test_entry_point_wrappers_parity_w1(approx, entry):
    """The thin Alg.-1 / Alg.-3 / Alg.-5 wrappers build the same
    SearchParams as the reference's and meet the parity bar."""
    q = approx["queries"]
    ref, port = approx["ref"], approx["port"]
    if entry == "greedy":
        r = ref_greedy(ref.graph, jnp.asarray(q), K, 12, backend="jnp")
        t = greedy_search(port.graph, q, K, 12, backend="jnp")
    elif entry == "error_bounded":
        r = ref_eb_search(ref.graph, jnp.asarray(q), K, 1.2, l_max=32,
                          backend="jnp")
        t = error_bounded_search(port.graph, q, K, 1.2, l_max=32,
                                 backend="jnp")
    else:
        r = ref_eb_probing(ref, jnp.asarray(q), K, 1.2, l_max=32,
                           backend="jnp")
        t = error_bounded_probing_search(port, q, K, 1.2, l_max=32,
                                         backend="jnp")
    assert_parity(r, t)


def test_memory_footprint_matches_reference(approx):
    assert memory_footprint(approx["port"]) == \
        ref_memory_footprint(approx["ref"])
