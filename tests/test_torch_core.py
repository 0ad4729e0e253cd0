"""The port's core pieces against the JAX package's, on the same inputs.

Inputs are made with numpy from a seed and go through both packages.
Integer results (bitsets, ids, neighbor lists, codes) must be identical;
float results agree to the stated tolerance — float32 sums taken in
another order differ in the last bits.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.core import bitset as rbits
from repro.core import distances as rdist
from repro.core import geometry as rgeo
from repro.core import rabitq as rrq
from repro.core import types as rtypes

from repro_torch.core import bitset as tbits
from repro_torch.core import distances as tdist
from repro_torch.core import geometry as tgeo
from repro_torch.core import rabitq as trq
from repro_torch.core.types import stable_topk_smallest, topk_smallest

from conftest import gmm

# several test workers share the host's cores; one intra-op thread each
# keeps them from oversubscribing it
torch.set_num_threads(1)

# the packages re-export the function under the module's name
rba = importlib.import_module("repro.core.build_approx")
tba = importlib.import_module("repro_torch.core.build_approx")


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# Bitset.
# ---------------------------------------------------------------------------

def _unique_rows(rng, B, K, n):
    ids = np.stack([rng.choice(n, K, replace=False) for _ in range(B)])
    ids = ids.astype(np.int32)
    ids[rng.random((B, K)) < 0.2] = -1
    return ids


@pytest.mark.parametrize("n", [31, 32, 200, 1000])
def test_bitset_set_test_clear_match_reference(n):
    rng = np.random.default_rng(n)
    B, K = 5, 12
    ids = _unique_rows(rng, B, K, n)
    ids[0, 0] = 31                      # bit 31 of word 0: the int32 sign bit
    ids[0, 1] = min(n - 1, 63)
    ids[0] = np.where(np.arange(K) > 1, -1, ids[0])
    r = rbits.bitset_set(rbits.bitset_make(B, n), jnp.asarray(ids))
    t = tbits.bitset_set(tbits.bitset_make(B, n), _t(ids))
    np.testing.assert_array_equal(tbits.bitset_to_uint32(t), np.asarray(r))
    probe = _unique_rows(rng, B, K, n)
    np.testing.assert_array_equal(
        tbits.bitset_test(t, _t(probe)).numpy(),
        np.asarray(rbits.bitset_test(r, jnp.asarray(probe))))
    # set is idempotent on already-set bits, as the reference's or is
    t = tbits.bitset_set(t, _t(ids))
    np.testing.assert_array_equal(tbits.bitset_to_uint32(t), np.asarray(r))
    clr = _unique_rows(rng, B, K, n)
    r = rbits.bitset_clear(r, jnp.asarray(clr))
    t = tbits.bitset_clear(t, _t(clr))
    np.testing.assert_array_equal(tbits.bitset_to_uint32(t), np.asarray(r))


@pytest.mark.parametrize("ids,fresh", [
    ([[3, 3, 5, -1]], [[True, True, True, False]]),
    ([[9, 2, 9, 7, 2, -1, 4, 4]], [[True] * 8]),
    ([[1, 2, 3, 4], [4, 4, 4, 4]], [[True, False, True, False], [True] * 4]),
])
def test_unique_per_row_keeps_holes_in_place(ids, fresh):
    ids = np.asarray(ids, np.int32)
    fresh = np.asarray(fresh)
    expect = np.asarray(rbits.unique_per_row(jnp.asarray(ids),
                                             jnp.asarray(fresh)))
    out = tbits.unique_per_row(_t(ids), _t(fresh)).numpy()
    np.testing.assert_array_equal(out, expect)
    if ids.tolist() == [[3, 3, 5, -1]]:
        assert out.tolist() == [[3, -1, 5, -1]]


# ---------------------------------------------------------------------------
# Stable top-k, brute force, medoid.
# ---------------------------------------------------------------------------

def test_stable_topk_lower_index_wins_ties():
    x = np.array([1.0, 0.5, 0.5, 0.5, np.inf, np.inf], np.float32)
    neg, idx = jax.lax.top_k(-jnp.asarray(x), 6)
    vals, tidx = stable_topk_smallest(_t(x), 6)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx))
    assert tidx.tolist()[:4] == [1, 2, 3, 0]
    np.testing.assert_array_equal(vals.numpy(), -np.asarray(neg))


def test_wide_smallest_k_equals_full_stable_sort():
    """Rows wider than the full-sort limit go through topk + a (value,
    column) sort; with ties at the k-th value it still equals the stable
    sort (lower column first)."""
    rng = np.random.default_rng(0)
    d2 = rng.integers(0, 50, (4, tdist._FULL_SORT_COLS + 500)).astype(np.float32)
    vals, idx = tdist._smallest_k(_t(d2), 10)
    order = np.argsort(d2, axis=1, kind="stable")[:, :10]
    np.testing.assert_array_equal(idx.numpy(), order)
    np.testing.assert_array_equal(vals.numpy(),
                                  np.take_along_axis(d2, order, axis=1))


def test_topk_smallest_matches_reference():
    rng = np.random.default_rng(1)
    d = rng.integers(0, 9, (6, 40)).astype(np.float32)   # many ties
    d[0, :5] = np.inf
    ids = rng.integers(-1, 500, (6, 40)).astype(np.int32)
    r_v, r_i = rtypes.topk_smallest(jnp.asarray(d), jnp.asarray(ids), 7)
    t_v, t_i = topk_smallest(_t(d), _t(ids), 7)
    np.testing.assert_array_equal(t_v.numpy(), np.asarray(r_v))
    np.testing.assert_array_equal(t_i.numpy(), np.asarray(r_i))


@pytest.mark.parametrize("exclude_self", [False, True])
def test_brute_force_knn_matches_reference(exclude_self):
    base = gmm(700, 16, 8, seed=2)
    queries = base[:300] if exclude_self else gmm(40, 16, 8, seed=3)
    rd, ri = rdist.brute_force_knn(queries, base, 10, block=128,
                                   exclude_self=exclude_self)
    td, ti = tdist.brute_force_knn(_t(queries), _t(base), 10, block=128,
                                   exclude_self=exclude_self)
    np.testing.assert_array_equal(ti.numpy(), ri)
    np.testing.assert_allclose(td.numpy(), rd, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("allow_tf32", [False, True])
def test_pairwise_sqdist_leaves_matmul_precision_alone(allow_tf32):
    """The TF32 flag is the process's: the library reads it, never sets it
    (the entry points turn it off)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    try:
        x = _t(gmm(20, 8, 2, seed=4))
        tdist.brute_force_knn(x, x, 3)
        assert torch.backends.cuda.matmul.allow_tf32 is allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.parametrize("n", [300, 5000])
def test_medoid_matches_reference(n):
    v = gmm(n, 8, 6, seed=n)
    assert tdist.medoid(_t(v), seed=3) == rdist.medoid(v, seed=3)


# ---------------------------------------------------------------------------
# RaBitQ.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rq():
    base = gmm(500, 40, 8, seed=4)        # d = 40: two words, a ragged tail
    queries = gmm(6, 40, 8, seed=5)
    ref = rrq.fit(jnp.asarray(base), jax.random.PRNGKey(1))
    port = trq.fit(_t(base), _t(np.asarray(ref.rotation)))
    return base, queries, ref, port


def test_rabitq_codes_bit_identical(rq):
    _, _, ref, port = rq
    np.testing.assert_array_equal(port.codes.numpy().view(np.uint32),
                                  np.asarray(ref.codes))
    np.testing.assert_allclose(port.norms.numpy(), np.asarray(ref.norms),
                               rtol=1e-5)
    np.testing.assert_allclose(port.ip_xo.numpy(), np.asarray(ref.ip_xo),
                               rtol=1e-5)
    signs = trq.unpack_bits(port.codes, 40).numpy()
    np.testing.assert_array_equal(signs,
                                  np.asarray(rrq.unpack_bits(ref.codes, 40)))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_rabitq_estimates_match_reference(rq, use_kernel):
    """Batched estimates (and the bitdot plug) against the reference's
    per-query estimate_sqdist: rtol 1e-4, atol 1e-3."""
    from repro.kernels.bitdot.ops import bitdot as ref_bitdot
    from repro_torch.kernels.bitdot.ops import bitdot as port_bitdot

    _, queries, ref, port = rq
    rng = np.random.default_rng(6)
    ids = rng.integers(0, 500, (queries.shape[0], 30)).astype(np.int32)
    ids[:, -3:] = -1
    expect = np.stack([np.asarray(rrq.estimate_sqdist(
        ref, rrq.prepare_query(ref, jnp.asarray(q)), jnp.asarray(i),
        bitdot_fn=ref_bitdot if use_kernel else None))
        for q, i in zip(queries, ids)])
    ctx = trq.prepare_query(port, _t(queries))
    out = trq.estimate_sqdist(port, ctx, _t(ids),
                              bitdot_fn=port_bitdot if use_kernel else None)
    np.testing.assert_allclose(out.numpy(), expect, rtol=1e-4, atol=1e-3)
    bound = np.stack([np.asarray(rrq.estimator_error_bound(ref, jnp.asarray(i)))
                      for i in ids])
    np.testing.assert_allclose(
        trq.estimator_error_bound(port, _t(ids)).numpy(), bound, rtol=1e-5)


def test_exact_sqdist_matches_reference(rq):
    """Batched exact distances against the reference's per-query ones:
    rtol 1e-5 (the same float32 squares, summed in another order)."""
    base, queries, _, _ = rq
    ids = np.random.default_rng(7).integers(-1, 500, (6, 20)).astype(np.int32)
    expect = np.stack([np.asarray(rrq.exact_sqdist(
        jnp.asarray(base), jnp.asarray(q), jnp.asarray(i)))
        for q, i in zip(queries, ids)])
    out = trq.exact_sqdist(_t(base), _t(queries), _t(ids)).numpy()
    assert np.isinf(out[ids < 0]).all()
    np.testing.assert_allclose(out, expect, rtol=1e-5)


def test_random_rotation_is_orthogonal():
    r = trq.random_rotation(24, torch.Generator().manual_seed(0))
    torch.testing.assert_close(r @ r.T, torch.eye(24), atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# Neighbor selection and the vectorised build helpers.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cands():
    """A corpus with each node's 40 nearest candidates, ascending."""
    base = gmm(400, 16, 6, seed=8)
    rd, ri = rdist.brute_force_knn(base, base, 40, exclude_self=True)
    ri = ri.astype(np.int32)
    ri[:5, -6:] = -1                      # padded candidate lists
    rd = np.where(ri >= 0, rd, np.inf).astype(np.float32)
    return base, ri, rd


@pytest.mark.parametrize("rule,param", [
    ("delta_emg", None), ("delta_emg", 0.2), ("mrng", 0.0),
    ("vamana", 1.2), ("tau_mg", 0.1)])
def test_select_block_matches_reference(cands, rule, param):
    base, ids, dists = cands
    u = np.arange(base.shape[0], dtype=np.int32)
    r_kept, r_cnt = rba._select_block(jnp.asarray(base), jnp.asarray(u),
                                      jnp.asarray(ids), jnp.asarray(dists),
                                      t=12, rule=rule, max_keep=16,
                                      fixed_delta=param)
    t_kept, t_cnt = tba._select_block(_t(base), _t(ids), _t(dists), t=12,
                                      rule=rule, max_keep=16,
                                      fixed_delta=param)
    np.testing.assert_array_equal(t_kept.numpy(), np.asarray(r_kept))
    np.testing.assert_array_equal(t_cnt.numpy(), np.asarray(r_cnt))


def test_select_per_node_t_matches_reference(cands):
    base, ids, dists = cands
    u = np.arange(base.shape[0], dtype=np.int32)
    t_vec = np.random.default_rng(9).integers(1, 40, u.size).astype(np.int32)
    r_kept, r_cnt = rba._select_block_per_node_t(
        jnp.asarray(base), jnp.asarray(u), jnp.asarray(ids),
        jnp.asarray(dists), jnp.asarray(t_vec), rule="delta_emg", max_keep=17)
    t_kept, t_cnt = tba._select_block_per_node_t(
        _t(base), _t(ids), _t(dists), _t(t_vec), rule="delta_emg",
        max_keep=17)
    np.testing.assert_array_equal(t_kept.numpy(), np.asarray(r_kept))
    np.testing.assert_array_equal(t_cnt.numpy(), np.asarray(r_cnt))


def _random_graph(seed, n=300, M=12):
    """Adjacency with ragged rows, holes after the degree, self edges and
    repeated entries: every case the reference helpers branch on."""
    rng = np.random.default_rng(seed)
    nbr = rng.integers(0, n, (n, M)).astype(np.int32)
    deg = rng.integers(0, M + 1, n).astype(np.int32)
    nbr[np.arange(M)[None, :] >= deg[:, None]] = -1
    nbr[rng.random((n, M)) < 0.05] = -1
    nbr[7, 0] = 7
    nbr[9, :3] = 4
    return nbr, deg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_add_reverse_edges_matches_reference(seed):
    nbr, deg = _random_graph(seed)
    r_nbr, r_deg = nbr.copy(), deg.copy()
    rba._add_reverse_edges(r_nbr, r_deg, 12)
    t_nbr, t_deg = _t(nbr.copy()), _t(deg.copy())
    tba._add_reverse_edges(t_nbr, t_deg, 12)
    np.testing.assert_array_equal(t_nbr.numpy(), r_nbr)
    np.testing.assert_array_equal(t_deg.numpy(), r_deg)


@pytest.mark.parametrize("cap", [3, 12])
def test_reverse_lists_matches_reference(cap):
    nbr, _ = _random_graph(4)
    np.testing.assert_array_equal(tba._reverse_lists(_t(nbr), cap).numpy(),
                                  rba._reverse_lists(nbr, cap))


def test_dedup_and_prep_candidates_match_reference(cands):
    base, ids, _ = cands
    rng = np.random.default_rng(10)
    u = np.arange(64, dtype=np.int32)
    merged = np.concatenate([ids[:64, :20], rng.integers(-1, 400, (64, 30))],
                            axis=1).astype(np.int32)
    merged[:, 3] = u                      # self ids are dropped
    r_m = rba._dedup_rows(merged, u)
    t_m = tba._dedup_rows(_t(merged), _t(u))
    np.testing.assert_array_equal(t_m.numpy(), r_m)
    r_ids, r_d = rba._prep_candidates(jnp.asarray(base), jnp.asarray(u),
                                      jnp.asarray(r_m), 24)
    t_ids, t_d = tba._prep_candidates(_t(base), _t(u), t_m, 24)
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(r_ids))
    np.testing.assert_allclose(t_d.numpy(), np.asarray(r_d), rtol=1e-6)


def test_align_degrees_matches_reference(cands):
    base, ids, dists = cands
    n, M = base.shape[0], 16
    p_r = rba.BuildParams(max_degree=M, beam_width=39, block=128)
    p_t = tba.BuildParams(max_degree=M, beam_width=39, block=128)
    kept, cnt = rba._select_block(jnp.asarray(base),
                                  jnp.arange(n, dtype=jnp.int32),
                                  jnp.asarray(ids), jnp.asarray(dists), t=4,
                                  rule="delta_emg", max_keep=M,
                                  fixed_delta=None)
    nbr, deg = np.array(kept), np.array(cnt).astype(np.int32)
    assert (deg < M).sum() > 50           # the search has work to do
    r_nbr, r_deg = nbr.copy(), deg.copy()
    rba._align_degrees(jnp.asarray(base), r_nbr, r_deg, ids, dists, p_r)
    t_nbr, t_deg = _t(nbr.copy()), _t(deg.copy())
    tba._align_degrees(_t(base), t_nbr, t_deg, _t(ids), _t(dists), p_t)
    np.testing.assert_array_equal(t_nbr.numpy(), r_nbr)
    np.testing.assert_array_equal(t_deg.numpy(), r_deg)


def test_bfs_and_repair_match_reference(cands):
    base, ids, _ = cands
    M = 8
    nbr = ids[:, :M].copy()
    nbr[200:, :] = np.where(ids[200:, :M] < 200, -1, ids[200:, :M])
    nbr[:200, :] = np.where(ids[:200, :M] >= 200, -1, ids[:200, :M])
    nbr[150:160, :] = -1                  # rows with room for repair links
    deg = (nbr >= 0).sum(1).astype(np.int32)
    np.testing.assert_array_equal(
        tba._bfs_reachable(_t(nbr), 0).numpy(), rba._bfs_reachable(nbr, 0))
    r_nbr, r_deg = nbr.copy(), deg.copy()
    r_fixed = rba._repair_connectivity(base, r_nbr, r_deg, M, 0)
    t_nbr, t_deg = _t(nbr.copy()), _t(deg.copy())
    t_fixed = tba._repair_connectivity(_t(base), t_nbr, t_deg, M, 0)
    assert t_fixed == r_fixed > 0
    np.testing.assert_array_equal(t_nbr.numpy(), r_nbr)
    np.testing.assert_array_equal(t_deg.numpy(), r_deg)
