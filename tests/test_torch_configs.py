"""The last pieces of the reference with a counterpart in the port: the
arch registry whole (``all_archs``, ``load_all``, ``ShapeSpec.skip``, the
four LM shapes, the paper's own ``sift1m`` config), the numpy oracle
(``repro_torch.testing.oracle``), geometry's membership tests, the ANN
serve cell's call (``launch.steps.ann_serve``) and ``launch.train``'s
refusal of an ann arch — each against the JAX package on the same
inputs.  At sift1m's ``smoke_cfg`` the port's ``build_emqg`` meets the
index builds' bar against the reference's, the probing search on the
reference's index meets the W = 1 parity bar, and the build does not
depend on ``BuildParams.block`` (``chip_smoke.py``'s sift1m phase raises
it to cut host hops).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.configs import all_archs as ref_all_archs
from repro.configs import get_arch as ref_get_arch
from repro.core import build_emqg as ref_build_emqg
from repro.core import geometry as ref_geometry
from repro.core import probing_search as ref_probing
from repro.core.build_approx import _bfs_reachable as ref_bfs_reachable
from repro.testing import oracle as ref_oracle

from repro_torch.configs import all_archs, get_arch, load_all
from repro_torch.core import build_emqg, geometry, probing_search
from repro_torch.core.build_approx import _bfs_reachable
from repro_torch.core.distributed import stack_indices
from repro_torch.data import clustered_vectors
from repro_torch.launch import steps
from repro_torch.launch.train import main as train_main
from repro_torch.testing import oracle

from hypothesis_compat import given, settings, st

# several test workers share the host's cores; one intra-op thread each
# keeps them from oversubscribing it
torch.set_num_threads(1)

COUNTERS = ("n_dist_comps", "n_approx_comps", "n_hops", "n_encounters",
            "final_l", "saturated")


# ---------------------------------------------------------------------------
# The oracle: the same numpy in both packages.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exact_knn_equals_reference(seed):
    """Ids and distances, with duplicate rows: the lower id wins a tie."""
    rng = np.random.default_rng(seed)
    corpus = rng.normal(size=(120, 8)).astype(np.float32)
    corpus[60:70] = corpus[10:20]            # duplicates: exact ties
    queries = np.concatenate([rng.normal(size=(9, 8)).astype(np.float32),
                              corpus[[12, 65]]])
    d, i = oracle.exact_knn(corpus, queries, 7)
    rd, ri = ref_oracle.exact_knn(corpus, queries, 7)
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_array_equal(d, rd)
    assert d.dtype == np.float64 and i[-2, 0] == 12 and i[-2, 1] == 62
    assert i[-1, 0] == 15 and i[-1, 1] == 65
    with pytest.raises(ValueError):
        oracle.exact_knn(corpus, queries, 121)


def test_check_delta_bound_equals_reference():
    rng = np.random.default_rng(5)
    orc = rng.uniform(0.5, 2.0, size=(6, 4))
    ok = orc * 1.5
    assert oracle.check_delta_bound(ok, orc, 0.5) is None
    assert ref_oracle.check_delta_bound(ok, orc, 0.5) is None
    bad = ok.copy()
    bad[3, 2] = orc[3, 2] * 2.5             # over 1/δ = 2
    bad[1, 0] = orc[1, 0] * 2.1
    msg = oracle.check_delta_bound(bad, orc, 0.5)
    assert msg is not None and msg == ref_oracle.check_delta_bound(bad, orc,
                                                                   0.5)
    assert "2/24 entries" in msg and "query 3 rank 2" in msg
    # the α-tightened bound, and the same refusals
    assert oracle.check_delta_bound(ok, orc, 0.5, alpha=1.5) == \
        ref_oracle.check_delta_bound(ok, orc, 0.5, alpha=1.5)
    for args in ((ok, orc, 0.0), (ok[:, :3], orc, 0.5)):
        with pytest.raises(ValueError):
            oracle.check_delta_bound(*args)


def test_recall_at_k_equals_reference():
    rng = np.random.default_rng(6)
    got = rng.integers(0, 30, size=(8, 5))
    want = rng.integers(0, 30, size=(8, 5))
    assert oracle.recall_at_k(got, want) == \
        ref_oracle.recall_at_k(got, want)
    unique = np.stack([rng.permutation(30)[:5] for _ in range(8)])
    assert oracle.recall_at_k(unique, unique) == 1.0


# ---------------------------------------------------------------------------
# Geometry's membership tests.
# ---------------------------------------------------------------------------

def _points(seed, n=400, d=6):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(n, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("delta", [0.05, 0.3, 0.8])
def test_membership_equals_reference(delta):
    """Booleans of both functions on seeded points, away from exact ties
    (points within 1e-4 of a boundary are left out: the two frameworks
    round the squared distances differently)."""
    a, b, c = _points(int(delta * 100))
    t = [torch.from_numpy(x) for x in (a, b, c)]
    j = [jnp.asarray(x) for x in (a, b, c)]
    ball = geometry.in_navigable_ball(*t, delta).numpy()
    r_ball = np.asarray(ref_geometry.in_navigable_ball(*j, delta))
    d2_qv = ((a - c) ** 2).sum(-1)
    d2_qu = ((a - b) ** 2).sum(-1)
    far = np.abs(d2_qv - delta * delta * d2_qu) > 1e-4
    np.testing.assert_array_equal(ball[far], r_ball[far])
    assert 0 < ball.sum() < ball.size or delta < 0.1

    # x near the segment from u = b to v = c, where the region lies
    rng = np.random.default_rng(7)
    span = np.linalg.norm(c - b, axis=-1, keepdims=True)
    x = (b + (c - b) * rng.uniform(0.1, 0.9, size=(len(b), 1))
         + 0.2 * span * rng.normal(size=b.shape) / np.sqrt(b.shape[1])
         ).astype(np.float32)
    occ = geometry.in_occlusion_region(torch.from_numpy(x), t[1], t[2],
                                       delta).numpy()
    r_occ = np.asarray(ref_geometry.in_occlusion_region(
        jnp.asarray(x), j[1], j[2], delta))
    d2_xu = ((x - b) ** 2).sum(-1)
    d2_xv = ((x - c) ** 2).sum(-1)
    d2_uv = ((b - c) ** 2).sum(-1)
    margin = np.minimum(
        np.abs(d2_uv - d2_xu),
        np.abs(d2_uv - d2_xv - 2 * delta * np.sqrt(d2_uv * d2_xu)))
    far = margin > 1e-4
    np.testing.assert_array_equal(occ[far], r_occ[far])
    assert far.mean() > 0.95 and 0 < occ.sum() < occ.size


def test_membership_keeps_the_device_and_broadcasts():
    q = torch.zeros(3, 2)
    u = torch.tensor([[1.0, 0.0]])
    v = torch.tensor([[0.1, 0.0], [0.9, 0.0], [0.0, 0.5]])
    assert geometry.in_navigable_ball(q, u, v, 0.5).tolist() == \
        [True, False, False]
    assert geometry.in_occlusion_region(v, torch.zeros(2), u[0], 0.1
                                        ).tolist() == [True, True, False]


@settings(max_examples=200, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), d=st.integers(2, 16),
       delta=st.floats(0.01, 0.9))
def test_lemma1_occluder_always_progresses(seed, d, delta):
    """``tests/test_geometry.py``'s Lemma-1 property on the port's
    functions: for w ∈ Occlusionδ(u,v) and any q with d(q,v) < δ·d(q,u),
    d(q,w) < d(q,u)."""
    rng = np.random.default_rng(seed)

    def vec(scale=1.0):
        return rng.normal(size=(d,)).astype(np.float32) * scale

    u = vec()
    v = u + vec(0.7) + 1e-2
    d_uv = float(np.linalg.norm(u - v))
    w = None
    for _ in range(300):
        cand = u + (v - u) * rng.uniform(0.1, 0.9) + vec(0.2 * d_uv)
        if bool(geometry.in_occlusion_region(
                torch.from_numpy(cand), torch.from_numpy(u),
                torch.from_numpy(v), delta)):
            w = cand
            break
    if w is None:
        return  # region too small at this δ/geometry — vacuous draw
    c = u + (v - u) / (1 - delta**2)
    R = delta * d_uv / (1 - delta**2)
    dirn = vec()
    dirn /= np.linalg.norm(dirn) + 1e-12
    q = (c + dirn * R * rng.uniform(0.0, 0.999)).astype(np.float32)
    if not bool(geometry.in_navigable_ball(
            torch.from_numpy(q), torch.from_numpy(u), torch.from_numpy(v),
            delta)):
        return
    assert np.linalg.norm(q - w) < np.linalg.norm(q - u) + 1e-6


# ---------------------------------------------------------------------------
# The registry.
# ---------------------------------------------------------------------------

REF_IDS = [a.id for a in ref_all_archs()]


@pytest.mark.parametrize("arch_id", REF_IDS)
def test_arch_matches_reference(arch_id):
    ref, port = ref_get_arch(arch_id), get_arch(arch_id)
    assert (port.id, port.family, port.source) == \
        (ref.id, ref.family, ref.source)
    assert list(port.shapes) == list(ref.shapes)
    for name, s in ref.shapes.items():
        p = port.shapes[name]
        assert (p.name, p.kind, p.dims, p.skip, p.accum_steps) == \
            (s.name, s.kind, s.dims, s.skip, s.accum_steps), name


def test_all_archs_is_the_reference_registry():
    load_all()
    assert sorted(a.id for a in all_archs()) == sorted(REF_IDS)
    assert {a.family for a in all_archs()} == {"lm", "gnn", "recsys", "ann"}
    long = {a.id: a.shapes["long_500k"].skip is None
            for a in all_archs() if a.family == "lm"}
    assert long == {"moonshot-v1-16b-a3b": False,
                    "llama4-maverick-400b-a17b": True,
                    "internlm2-20b": False, "phi3-mini-3.8b": False,
                    "smollm-135m": False}
    with pytest.raises(KeyError):
        get_arch("sift10m")


@pytest.mark.parametrize("which", ["model_cfg", "smoke_cfg"])
def test_sift1m_params_match_reference(which):
    ref = getattr(ref_get_arch("sift1m"), which)
    port = getattr(get_arch("sift1m"), which)
    assert (port["n"], port["dim"]) == (ref["n"], ref["dim"])
    for key in ("build", "search"):
        r, p = dataclasses.asdict(ref[key]), dataclasses.asdict(port[key])
        # two reference fields have no counterpart in the port: the
        # build's checkpoint_dir (sift1m leaves it unset) and
        # SearchParams.rerank, which no reference code reads
        assert {k: v for k, v in r.items() if k not in p} == \
            {"build": {"checkpoint_dir": None},
             "search": {"rerank": True}}[key], key
        assert p == {k: r[k] for k in p}, key


# ---------------------------------------------------------------------------
# sift1m at its smoke_cfg: build, search, block, the serve cell.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sift():
    cfg = get_arch("sift1m").smoke_cfg
    rcfg = ref_get_arch("sift1m").smoke_cfg
    base = clustered_vectors(cfg["n"], cfg["dim"], 16, seed=0)
    queries = clustered_vectors(24, cfg["dim"], 16, seed=1)
    ref = ref_build_emqg(base, rcfg["build"], key=jax.random.PRNGKey(0))
    port = build_emqg(base, cfg["build"],
                      rotation=np.asarray(ref.codes.rotation), device="cpu")
    return dict(cfg=cfg, rcfg=rcfg, base=base, queries=queries, ref=ref,
                port=port)


def test_sift1m_build_matches_reference(sift):
    """The index builds' bar: ≥ 95% of rows identical, the same medoid, the
    same nodes reachable from it, the same codes."""
    ref, port = sift["ref"], sift["port"]
    r_nbr, t_nbr = np.asarray(ref.graph.neighbors), port.graph.neighbors.numpy()
    same = (r_nbr == t_nbr).all(1).mean()
    assert same >= 0.95, same
    assert port.graph.medoid == int(ref.graph.medoid)
    np.testing.assert_array_equal(
        _bfs_reachable(port.graph.neighbors, port.graph.medoid).numpy(),
        ref_bfs_reachable(r_nbr, int(ref.graph.medoid)))
    np.testing.assert_array_equal(port.codes.codes.numpy().view(np.uint32),
                                  np.asarray(ref.codes.codes))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_sift1m_probing_parity_w1(sift, use_kernel):
    """The W = 1 parity bar on the reference's index carried across:
    ids identical, dists to 1e-4, every counter identical."""
    from test_torch_search import to_port

    idx = to_port(sift["ref"])
    q = sift["queries"]
    r = ref_probing(sift["ref"], jnp.asarray(q), sift["rcfg"]["search"],
                    use_kernel=use_kernel, backend="jnp")
    t = probing_search(idx, q, sift["cfg"]["search"], use_kernel=use_kernel,
                       backend="jnp")
    np.testing.assert_array_equal(t.ids.numpy(), np.asarray(r.ids))
    np.testing.assert_allclose(t.dists.numpy(), np.asarray(r.dists),
                               rtol=1e-4, atol=1e-4)
    for name in COUNTERS:
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(r, name)),
                                      err_msg=name)


def assert_block_free(params, base, built, rotation=None) -> None:
    """Each block's searches read the graph frozen at the start of its
    iteration, and every later step is per node: ``block=64`` and
    ``block=n`` give the same neighbours and codes, bit for bit, and the
    same graph as ``built``, the build at ``params``'s own block."""
    n = base.shape[0]
    a, b = [build_emqg(base, dataclasses.replace(params, block=blk),
                       rotation=rotation, device="cpu") for blk in (64, n)]
    assert torch.equal(a.graph.neighbors, b.graph.neighbors)
    assert a.graph.medoid == b.graph.medoid
    for f in ("codes", "norms", "ip_xo", "rotation", "center"):
        assert torch.equal(getattr(a.codes, f), getattr(b.codes, f)), f
    assert torch.equal(a.graph.neighbors, built.graph.neighbors)


def test_build_does_not_depend_on_block(sift):
    """``block=64`` and ``block=n`` build the same index as sift1m's
    smoke_cfg block (the reference's parity build): what licenses the
    smoke's and the benchmark's larger blocks (``tests/test_torch_d960.py``
    holds d = 960 to it too)."""
    assert_block_free(sift["cfg"]["build"], sift["base"], sift["port"])


def test_ann_serve_is_probing_search_at_one_shard(sift):
    arch = get_arch("sift1m")
    small = dataclasses.replace(arch, model_cfg=sift["cfg"])
    port = sift["port"]
    sidx = stack_indices([port], [0], sift["cfg"]["n"],
                         sizes=[sift["cfg"]["n"]])
    run = steps.ann_serve(small, arch.shapes["serve_online"], sidx)
    stats = {}
    ids, dists = run(sift["queries"], stats)
    want = probing_search(port, sift["queries"], sift["cfg"]["search"])
    assert torch.equal(ids, want.ids)
    torch.testing.assert_close(dists, want.dists, rtol=1e-6, atol=1e-6)
    assert torch.equal(stats["n_hops"][0], want.n_hops)
    with pytest.raises(ValueError):
        steps.ann_serve(get_arch("smollm-135m"),
                        get_arch("smollm-135m").shapes["prefill_32k"], sidx)


@pytest.mark.parametrize("shape", ["serve_batch", "serve_online"])
def test_ann_model_flops_is_the_reference_formula(sift, shape):
    """B · S · l_max · 2 · dim, as ``_ann_serve_cell`` counts it, with S
    the served index's shards."""
    arch = get_arch("sift1m")
    s = arch.shapes[shape]
    n = sift["cfg"]["n"]
    sidx = stack_indices([sift["port"]] * 4, [0, n, 2 * n, 3 * n], 4 * n,
                         sizes=[n] * 4)
    want = s.dims["batch"] * 4 * 512 * 2.0 * 128
    assert steps._ann_model_flops(arch, s, sidx) == want


def test_launch_train_refuses_an_ann_arch():
    with pytest.raises(SystemExit, match="ann"):
        train_main(["--arch", "sift1m", "--device", "cpu", "--smoke"])
