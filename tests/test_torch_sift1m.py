"""The paper's own regime, sift1m's ``model_cfg`` (M 64, L 1000, t 64,
build ``max_hops`` 1,024; search l_max 512, α 1.2, ``max_hops`` 4,096),
held against the JAX package step by step on the same inputs.

A whole build at these parameters costs minutes on the CPU even at
n = 1,100 (each of its n searches runs up to 1,024 hops over a beam of
1,000), so the build is checked a step at a time on one block of rows,
each step at the model's own parameters: the candidate search (some of
it cut at the hop cap, as on the card), the merge and exact re-rank, the
selection, the degree alignment; then the exact and the quantized
probing search at the model's ``SearchParams`` on one graph.  The graph
is a cheap δ-EMG from the reference (one iteration at L = 16, M = 64):
sparse, as the build's refined graphs are, so that, as on the card, some
of the L = 1,000 searches run to the hop cap (on the exact top-64 graph
every one ends at L hops).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.configs import get_arch as ref_get_arch
from repro.core import from_graph as ref_from_graph
from repro.core import probing_search as ref_probing
from repro.core import search as ref_search
from repro.core.types import GraphIndex as RefGraph

from repro_torch.configs import get_arch
from repro_torch.core import from_graph, probing_search, search
from repro_torch.core.types import GraphIndex
from repro_torch.data import clustered_vectors

rba = importlib.import_module("repro.core.build_approx")
tba = importlib.import_module("repro_torch.core.build_approx")

# several test workers share the host's cores; one intra-op thread each
# keeps them from oversubscribing it
torch.set_num_threads(1)

N, BLOCK, N_QUERIES = 2048, 32, 32       # N > L, so L stays 1,000
COUNTERS = ("n_dist_comps", "n_approx_comps", "n_hops", "n_encounters",
            "final_l", "saturated")


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def regime():
    cfg, rcfg = get_arch("sift1m").model_cfg, ref_get_arch("sift1m").model_cfg
    bp, rbp = cfg["build"], rcfg["build"]
    base = clustered_vectors(N, cfg["dim"], 48, seed=0)
    queries = clustered_vectors(N_QUERIES, cfg["dim"], 48, seed=1)
    M = bp.max_degree
    g = rba.build_approx(base, rba.BuildParams(max_degree=M, beam_width=16,
                                               t=M, iters=1, block=N))
    nbr, med = np.asarray(g.neighbors), int(g.medoid)
    ref_graph = RefGraph(jnp.asarray(base), jnp.asarray(nbr), jnp.int32(med),
                         kind="delta_emg_approx")
    graph = GraphIndex(_t(base), _t(nbr), med, kind="delta_emg_approx")
    u = np.arange(BLOCK, dtype=np.int32)   # the block: nodes 0..31
    return dict(cfg=cfg, rcfg=rcfg, bp=bp, rbp=rbp, base=base,
                queries=queries, nbr=nbr, med=med, ref_graph=ref_graph,
                graph=graph, u=u)


@pytest.fixture(scope="module")
def candidates(regime):
    """Line 6 for the block, at L = 1,000 and the build's hop cap, in both
    packages: the reference's (ids, dists, hops) and the port's (ids,
    dists, capped)."""
    bp, base, u = regime["bp"], regime["base"], regime["u"]
    L = min(bp.beam_width, N)
    rp = rba.SearchParams(k=L, l0=L, l_max=L, adaptive=False,
                          max_hops=regime["rbp"].max_hops)
    r_res, r_ids, r_d = ref_search(regime["ref_graph"], jnp.asarray(base[u]),
                                   rp, with_candidates=True)
    t_ids, t_d, capped = tba._candidate_search(regime["graph"], _t(base[u]),
                                               L, bp.max_hops)
    return dict(L=L, r_ids=np.asarray(r_ids), r_d=np.asarray(r_d),
                r_hops=np.asarray(r_res.n_hops), t_ids=t_ids, t_d=t_d,
                capped=int(capped))


def _same_up_to_ties(t_ids, t_d, r_ids, r_d):
    """Each row holds the reference's ids, distance for distance to 1e-5,
    in its order but where two distances tie to that tolerance: the
    packages sum a distance in different orders, so a near-tie may swap
    (as the index builds' bar allows)."""
    t_ids, t_d = t_ids.numpy(), t_d.numpy()
    np.testing.assert_array_equal(np.sort(t_ids, 1), np.sort(r_ids, 1))
    np.testing.assert_allclose(t_d, r_d, rtol=1e-5, atol=1e-5)


def test_model_cfg_is_the_regime(regime):
    bp, sp = regime["bp"], regime["cfg"]["search"]
    assert (bp.max_degree, bp.beam_width, bp.t, bp.iters, bp.max_hops) == \
        (64, 1000, 64, 3, 1024)
    assert (sp.k, sp.l_max, sp.alpha, sp.max_hops) == (10, 512, 1.2, 4096)


def test_candidate_search_at_l1000_matches_reference(regime, candidates):
    """Each row's 1,000 candidates are the reference's up to near-ties
    (``_same_up_to_ties``), and the same searches are cut at the
    1,024-hop cap — some are, as on the card."""
    c = candidates
    _same_up_to_ties(c["t_ids"], c["t_d"], c["r_ids"], c["r_d"])
    want = int((c["r_hops"] >= regime["bp"].max_hops).sum())
    assert c["capped"] == want > 0


@pytest.fixture(scope="module")
def merged(regime, candidates):
    """The reference's candidates of the block next to its current and
    reverse lists, (concatenated, deduplicated by the reference)."""
    nbr, u, M = regime["nbr"], regime["u"], regime["bp"].max_degree
    cat = np.concatenate([candidates["r_ids"], nbr[u],
                          rba._reverse_lists(nbr, M)[u]], 1).astype(np.int32)
    np.testing.assert_array_equal(
        tba._reverse_lists(_t(nbr), M).numpy(), rba._reverse_lists(nbr, M))
    return cat, rba._dedup_rows(cat, u)


@pytest.fixture(scope="module")
def selected(regime, candidates, merged):
    """The reference's exact re-rank to L + 1 and LocallySelectNeighbors
    at t = 64, M = 64 of the block: (ids, dists, kept, count)."""
    bp, base, u, L = regime["bp"], regime["base"], regime["u"], \
        candidates["L"]
    ids, dists = rba._prep_candidates(jnp.asarray(base), jnp.asarray(u),
                                      jnp.asarray(merged[1]), L)
    kept, cnt = rba._select_block(jnp.asarray(base), jnp.asarray(u), ids,
                                  dists, t=min(bp.t, L), rule=bp.rule,
                                  max_keep=bp.max_degree,
                                  fixed_delta=bp.delta)
    return (np.asarray(ids), np.asarray(dists), np.array(kept),
            np.array(cnt).astype(np.int32))


def test_selection_at_m64_t64_matches_reference(regime, candidates, merged,
                                                selected):
    """On the reference's candidates: the merge with the current and
    reverse lists identical, the exact re-rank to L + 1 identical up to
    near-ties, and, on the reference's re-ranked lists,
    LocallySelectNeighbors at t = 64, M = 64: every kept list and count
    identical."""
    bp, base, u, L = regime["bp"], regime["base"], regime["u"], \
        candidates["L"]
    t_merged = tba._dedup_rows(_t(merged[0]), _t(u))
    np.testing.assert_array_equal(t_merged.numpy(), merged[1])
    r_ids, r_d, r_kept, r_cnt = selected
    t_ids, t_d = tba._prep_candidates(_t(base), _t(u), t_merged, L)
    _same_up_to_ties(t_ids, t_d, r_ids, r_d)
    t_kept, t_cnt = tba._select_block(_t(base), _t(r_ids), _t(r_d),
                                      t=min(bp.t, L),
                                      rule=bp.rule, max_keep=bp.max_degree,
                                      fixed_delta=bp.delta)
    np.testing.assert_array_equal(t_kept.numpy(), r_kept)
    np.testing.assert_array_equal(t_cnt.numpy(), r_cnt)


def test_degree_alignment_at_m64_l1000_matches_reference(regime, selected):
    """Sec. 6.1 on the selected block: the binary search for t over
    [1, 1,000] and the fill to exactly M = 64, identical."""
    ids, dists, kept, cnt = selected
    M = regime["bp"].max_degree
    assert (cnt < M).sum() > 0            # the alignment has work to do
    r_nbr, r_deg = kept.copy(), cnt.copy()
    rba._align_degrees(jnp.asarray(regime["base"]), r_nbr, r_deg, ids, dists,
                       regime["rbp"])
    t_nbr, t_deg = _t(kept), _t(cnt)
    tba._align_degrees(_t(regime["base"]), t_nbr, t_deg, _t(ids), _t(dists),
                       regime["bp"])
    np.testing.assert_array_equal(t_nbr.numpy(), r_nbr)
    np.testing.assert_array_equal(t_deg.numpy(), r_deg)
    assert (t_deg == M).all()


@pytest.mark.parametrize("engine", ["search", "probing"])
def test_search_at_model_params_matches_reference(regime, engine):
    """The model's ``SearchParams`` on one graph: the exact search, and the
    quantized probing search with the reference's RaBitQ rotation carried
    across — the W = 1 parity bar: ids identical, distances to 1e-4,
    every counter identical."""
    q, sp, rsp = regime["queries"], regime["cfg"]["search"], \
        regime["rcfg"]["search"]
    if engine == "search":
        r = ref_search(regime["ref_graph"], jnp.asarray(q), rsp,
                       backend="jnp")
        t = search(regime["graph"], _t(q), sp, backend="jnp")
    else:
        ref_idx = ref_from_graph(regime["ref_graph"],
                                 key=jax.random.PRNGKey(0))
        idx = from_graph(regime["graph"],
                         rotation=np.asarray(ref_idx.codes.rotation))
        np.testing.assert_array_equal(idx.codes.codes.numpy().view(np.uint32),
                                      np.asarray(ref_idx.codes.codes))
        r = ref_probing(ref_idx, jnp.asarray(q), rsp, backend="jnp")
        t = probing_search(idx, _t(q), sp, backend="jnp")
    np.testing.assert_array_equal(t.ids.numpy(), np.asarray(r.ids))
    np.testing.assert_allclose(t.dists.numpy(), np.asarray(r.dists),
                               rtol=1e-4, atol=1e-4)
    for name in COUNTERS:
        got = getattr(t, name)
        if got is None:
            assert getattr(r, name) is None, name
            continue
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(r, name)),
                                      err_msg=name)
