"""The port's search engines against the JAX package's, on indexes the JAX
package built and ``repro_torch.interop`` carried across.

At beam_width 1 the port meets the parity bar: ids identical, distances to
1e-4, and ``n_dist_comps``, ``n_approx_comps``, ``n_hops``,
``n_encounters``, ``final_l`` and ``saturated`` identical.  At W = 4 the
engines go through the oracle checks of ``tests/test_conformance.py``:
the (1/δ) bound on an exact Alg.-2 graph, honesty, and the metamorphic
case of a query equal to a corpus point.  The Theorem-4 probes, the exact
Alg.-2 build, filtered search and MIPS search are held to the reference on
the same inputs.
"""

import importlib

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
from repro.core import local_optimum_mask as ref_local_optimum_mask
from repro.core import probing_search as ref_probing
from repro.core import search as ref_search
from repro.core import theorem4_delta_prime as ref_theorem4
from repro.core.emqg import from_graph as ref_from_graph
from repro.core.filtered import filtered_search as ref_filtered_search
from repro.core.mips import build_mips as ref_build_mips
from repro.core.mips import mips_search as ref_mips_search
from repro.testing.oracle import check_delta_bound, exact_knn

from repro_torch.core import (
    SearchParams,
    ags_search,
    build_exact,
    error_bounded_probing_search,
    error_bounded_search,
    greedy_search,
    local_optimum_mask,
    memory_footprint,
    probing_search,
    search,
    theorem4_delta_prime,
)
from repro_torch.core.filtered import filtered_search
from repro_torch.core.mips import MIPSIndex, ip_from_l2, mips_search
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


# ---------------------------------------------------------------------------
# Theorem-4 probes and the exact Alg.-2 build, on the exact fixture.
# ---------------------------------------------------------------------------

def _candidates(exact, k=K):
    p = dict(k=k, l0=k, l_max=48, alpha=2.0, adaptive=True, max_hops=512)
    q = exact["queries"]
    _, ids, dists = search(exact["port"].graph, q, SearchParams(**p),
                           with_candidates=True, backend="jnp")
    return q, ids, dists


def test_local_optimum_mask_matches_reference(exact):
    q, ids, _ = _candidates(exact)
    ids = ids.clone()
    ids[:, 3] = torch.arange(ids.shape[0], dtype=torch.int32) * 7  # any id
    ids[0, 1] = -1
    r = ref_local_optimum_mask(exact["ref"].graph, jnp.asarray(q),
                               jnp.asarray(ids.numpy()))
    t = local_optimum_mask(exact["port"].graph, q, ids, backend="jnp")
    np.testing.assert_array_equal(t.numpy(), np.asarray(r))
    assert t.any() and not t.all()


def test_theorem4_delta_prime_matches_reference(exact):
    q, ids, dists = _candidates(exact)
    r_found, r_dp = ref_theorem4(exact["ref"].graph, jnp.asarray(q),
                                 jnp.asarray(ids.numpy()),
                                 jnp.asarray(dists.numpy()), k=K, delta=DELTA)
    found, dp = theorem4_delta_prime(exact["port"].graph, q, ids, dists, k=K,
                                     delta=DELTA, backend="jnp")
    np.testing.assert_array_equal(found.numpy(), np.asarray(r_found))
    assert found.float().mean() > 0.5
    np.testing.assert_allclose(dp.numpy(), np.asarray(r_dp), rtol=1e-6)


def _without_self(nbr):
    """Neighbor rows with the row's own id removed (order kept, -1 tail)."""
    out = np.full_like(nbr, -1)
    for u, row in enumerate(nbr):
        keep = row[(row >= 0) & (row != u)]
        out[u, :keep.size] = keep
    return out


def test_build_exact_matches_reference(exact):
    """Neighbor lists identical to the reference's, apart from the
    reference's self-loops (ROADMAP C.4): it admits u into N(u) where the
    norm identity rounds d²(u, u) above 0, which depends on the last bits of
    the matmul; the port gives u the distance 0 and never admits it."""
    ref = np.asarray(exact["ref"].graph.neighbors)
    g = build_exact(exact["base"], delta=DELTA, device="cpu")
    nbr = g.neighbors.numpy()
    assert (nbr == _without_self(nbr)).all()           # no self-loops
    assert (ref != _without_self(ref)).any(1).sum() > 0
    np.testing.assert_array_equal(nbr, _without_self(ref))
    assert g.medoid == int(exact["ref"].graph.medoid)
    assert (g.kind, g.delta) == (exact["ref"].graph.kind, DELTA)


# ---------------------------------------------------------------------------
# Filtered and MIPS search on reference-built indexes (W = 1).
# ---------------------------------------------------------------------------

def test_filtered_search_parity_w1(approx):
    q = approx["queries"]
    mask = np.random.default_rng(4).random(approx["base"].shape[0]) < 0.3
    r = ref_filtered_search(approx["ref"].graph, jnp.asarray(q), mask, k=K,
                            alpha=1.2, l_max=64)
    t = filtered_search(approx["port"].graph, q, mask, k=K, alpha=1.2,
                        l_max=64, backend="jnp")
    ids = t.ids.numpy()
    assert mask[ids[ids >= 0]].all()
    np.testing.assert_array_equal(ids, np.asarray(r.ids))
    np.testing.assert_allclose(t.dists.numpy(), np.asarray(r.dists),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(t.n_hops.numpy(), np.asarray(r.n_hops))


@pytest.fixture(scope="module")
def mips_ref():
    items = gmm(500, 16, 8, seed=41)
    queries = gmm(12, 16, 8, seed=42)
    from repro.core import BuildParams as RBP
    bp = RBP(max_degree=12, beam_width=24, t=12, iters=2, block=256)
    return items, queries, {quantized: ref_build_mips(items, bp, quantized)
                            for quantized in (False, True)}


@pytest.mark.parametrize("quantized", [False, True])
def test_mips_search_parity_w1(mips_ref, quantized):
    """The augmented width d + 1 = 17 gives one code word with 17 bits set
    at most, and a ragged row for the exact tier."""
    items, queries, built = mips_ref
    ref = built[quantized]
    port = MIPSIndex(index=to_port(ref.index), radius=ref.radius,
                     dim=ref.dim)
    assert port.quantized == quantized
    r = ref_mips_search(ref, queries, k=K, alpha=1.2, l_max=64)
    t = mips_search(port, queries, k=K, alpha=1.2, l_max=64, backend="jnp")
    np.testing.assert_array_equal(t.ids.numpy(), np.asarray(r.ids))
    np.testing.assert_allclose(t.dists.numpy(), np.asarray(r.dists),
                               rtol=1e-4, atol=1e-4)
    scores = ip_from_l2(queries, t.dists, port.radius)
    want = np.take_along_axis(queries @ items.T, t.ids.numpy(), axis=1)
    np.testing.assert_allclose(scores, want, rtol=1e-3, atol=1e-2)


def test_mips_recall_at_scale_is_the_reference_level():
    """ROADMAP C.7: MIPS recall@10 falls with n, and the fall is the
    reference's.  The quantized MIPS index of the serve cell's build
    parameters, built by the JAX package, searched by both packages at the
    smoke's α = 1.2 and l_max = 256: ids identical, so recall@10 against
    brute-force inner product is equal."""
    items = gmm(2000, 32, 48, seed=7)
    queries = gmm(64, 32, 48, seed=8)
    bp = RefBuildParams(max_degree=24, beam_width=64, t=32, iters=2,
                        block=1024)
    ref = ref_build_mips(items, bp, quantized=True)
    port = MIPSIndex(index=to_port(ref.index), radius=ref.radius,
                     dim=ref.dim)
    r = ref_mips_search(ref, queries, k=10, alpha=1.2, l_max=256)
    t = mips_search(port, queries, k=10, alpha=1.2, l_max=256,
                    backend="jnp")
    np.testing.assert_array_equal(t.ids.numpy(), np.asarray(r.ids))
    gt = np.argsort(-(queries @ items.T), axis=1, kind="stable")[:, :10]

    def recall(ids):
        return sum(len(set(a) & set(b)) for a, b in zip(ids.tolist(),
                                                        gt.tolist())) / gt.size

    assert recall(t.ids.numpy()) == recall(np.asarray(r.ids))



# -- the top-C merge (kernels/topc): its plain version and the wrapper ------

def _np_stable_merge(ids_a, d2_a, vis_a, ids_b, d2_b, vis_b, cap):
    """Row by row: the new entries sorted stably, then a two-pointer merge
    that takes the buffer's entry on a tie; the first ``cap`` kept."""
    out = []
    for row in range(d2_a.shape[0]):
        order = np.argsort(d2_b[row], kind="stable")
        a = list(zip(d2_a[row], ids_a[row], vis_a[row]))
        b = [(d2_b[row][j], ids_b[row][j], vis_b[row][j]) for j in order]
        i = j = 0
        merged = []
        while len(merged) < cap and (i < len(a) or j < len(b)):
            if j == len(b) or (i < len(a) and a[i][0] <= b[j][0]):
                merged.append(a[i])
                i += 1
            else:
                merged.append(b[j])
                j += 1
        out.append(merged)
    d2, ids, vis = (np.array([[e[f] for e in r] for r in out])
                    for f in range(3))
    return ids, d2, vis


def _merge_inputs(B, C, K, seed):
    """A sorted buffer and new entries with ties across and within them,
    ±0.0, +inf pads, rows that take nothing and rows whose every new entry
    beats the buffer."""
    rng = np.random.default_rng(seed)
    grid = np.array([-0.0, 0.0, 0.25, 0.5, 1.0, 1.5, 2.0, np.inf],
                    dtype=np.float32)
    d2_a = np.sort(rng.choice(grid, (B, C)), axis=1, kind="stable")
    d2_b = rng.choice(grid, (B, K)).astype(np.float32)
    d2_b[1::4] = np.maximum(d2_b[1::4], d2_a[1::4, -1:])   # nothing enters
    d2_b[2::4] = -1.0 - rng.random((len(d2_b[2::4]), K))   # all beat it
    ids_a = rng.permutation(B * C).reshape(B, C).astype(np.int32)
    ids_b = (B * C + rng.permutation(B * K)).reshape(B, K).astype(np.int32)
    vis_a = rng.random((B, C)) < 0.5
    vis_b = rng.random((B, K)) < 0.5
    return ids_a, d2_a, vis_a, ids_b, d2_b, vis_b


MERGE_CASES = [(7, 3, 0), (5, 20, 1), (33, 1, 2), (64, 64, 3), (129, 64, 4),
               (513, 1, 5), (513, 64, 6)]


@pytest.mark.parametrize("C,K,seed", MERGE_CASES)
def test_merge_topc_ref_is_a_stable_merge(C, K, seed):
    from repro_torch.kernels.topc import ref as topc_ref

    arrays = _merge_inputs(12, C, K, seed)
    got = topc_ref.merge_topc_ref(*(torch.from_numpy(x) for x in arrays), C)
    want = _np_stable_merge(*arrays, C)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_merge_topc_on_cpu_runs_the_plain_version():
    from repro_torch.kernels.topc import ops as topc_ops
    from repro_torch.kernels.topc import ref as topc_ref

    inputs = [torch.from_numpy(x) for x in _merge_inputs(12, 33, 8, 7)]
    before = topc_ops.LAUNCHES["merge_topc"]
    got = topc_ops.merge_topc(*inputs, 33)
    assert topc_ops.LAUNCHES["merge_topc"] == before
    for g, w in zip(got, topc_ref.merge_topc_ref(*inputs, 33)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("fault", ["cap", "ids_int64", "d2_float64",
                                   "vis_uint8", "rows", "widths"])
def test_merge_topc_refuses_what_the_kernel_does_not_take(fault):
    from repro_torch.kernels.topc import ops as topc_ops

    args = [torch.from_numpy(x) for x in _merge_inputs(4, 9, 3, 8)]
    cap = 9
    if fault == "cap":
        cap = 8
    elif fault == "ids_int64":
        args[3] = args[3].long()
    elif fault == "d2_float64":
        args[1] = args[1].double()
    elif fault == "vis_uint8":
        args[5] = args[5].to(torch.uint8)
    elif fault == "rows":
        args[4] = args[4][:3]
    else:
        args[2] = args[2][:, :8]
    with pytest.raises((TypeError, ValueError)):
        topc_ops.merge_topc(*args, cap)


@pytest.mark.parametrize("engine,beam_width", [("probing", 1), ("probing", 4),
                                               ("beam", 1), ("beam", 4)])
def test_the_loops_merge_into_a_sorted_buffer(approx, monkeypatch, engine,
                                              beam_width):
    """The kernel's precondition: at every merge the buffer is ascending,
    its width is ``cap``, and the new entries are contiguous (the kernel
    takes them as they are)."""
    # the modules, not the functions that repro_torch.core exports
    search_mod = importlib.import_module("repro_torch.core.search")
    probing_mod = importlib.import_module("repro_torch.core.probing")
    calls = []

    def checked(ids_a, d2_a, vis_a, ids_b, d2_b, vis_b, cap):
        calls.append(cap)
        assert d2_a.shape[1] == cap
        assert bool((d2_a[:, 1:] >= d2_a[:, :-1]).all())
        assert all(t.is_contiguous() for t in (ids_b, d2_b, vis_b))
        return merge(ids_a, d2_a, vis_a, ids_b, d2_b, vis_b, cap)

    merge = search_mod.batch_merge_topc
    monkeypatch.setattr(search_mod, "batch_merge_topc", checked)
    monkeypatch.setattr(probing_mod, "batch_merge_topc", checked)
    _, tp = params(beam_width=beam_width)
    if engine == "probing":
        probing_search(approx["port"], approx["queries"], tp)
    else:
        search(approx["port"].graph, approx["queries"], tp)
    assert len(calls) > 2
