"""The port's recsys substrate (``repro_torch.models.recsys``, the GRU and
MLP of ``models.common``, ``data``'s recsys batches, ``launch.steps``,
``interop.recsys_params_*``, the recsys configs) against the JAX
package's, on the CPU, on numpy-seeded inputs and the reference's own
parameters carried across with ``interop.recsys_params_from_numpy``.

Tolerances, each the same f32 math summed in another order by another
BLAS: forward outputs, losses and metrics to rtol 1e-5 (atol 1e-7 for
values near 0); gradients to 1e-4 of the largest per-leaf ‖Δ‖ / ‖ref‖;
one AdamW step's parameters to atol 1e-6 (an update moves each weight by
at most ~lr = 1e-3, and m / √v of a gradient amplifies its rounding only
where the gradient is near eps); the synthetic batches bit for bit;
retrieval ids identical (exact ties lowest index first, as
``jax.lax.top_k`` orders them) and scores to rtol 1e-5.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.configs.base import get_arch as ref_get_arch
from repro.data import synthetic as ref_synthetic
from repro.launch import steps as ref_steps
from repro.models import common as ref_common
from repro.models import recsys as ref_rs
from repro.optim import OptConfig as RefOptConfig
from repro.train import TrainState as RefTrainState
from repro.train import make_train_step as ref_make_train_step

from repro_torch.configs import get_arch
from repro_torch.data import recsys_ctr_batch, recsys_seq_batch
from repro_torch.interop import (recsys_params_from_numpy,
                                 recsys_params_to_numpy)
from repro_torch.launch import steps
from repro_torch.launch import train as launch_train
from repro_torch.models import common
from repro_torch.models import recsys as rs
from repro_torch.optim import OptConfig
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train import TrainState, make_train_step

torch.set_num_threads(1)

ARCHS = ("fm", "dcn-v2", "dien", "mind")
RTOL, ATOL = 1e-5, 1e-7
GRAD_TOL = 1e-4
B = 16


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def carried(arch_id, seed=0):
    """(smoke config, reference params, the port's params from them)."""
    ref_cfg = ref_get_arch(arch_id).smoke_cfg
    params = ref_steps._RECSYS_INIT[arch_id](ref_cfg, jax.random.PRNGKey(seed))
    cfg = get_arch(arch_id).smoke_cfg
    return cfg, params, recsys_params_from_numpy(cfg, _np(params),
                                                 device="cpu")


def batches(arch_id, cfg, step=0):
    """(reference batch of jnp arrays, the port's batch of CPU tensors)."""
    port = steps.recsys_batch(arch_id, cfg, B, step=step, device="cpu")
    return {k: jnp.asarray(v.numpy()) for k, v in port.items()}, port


def close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=msg)


def rel_leaf_errors(port_tree, ref_tree) -> list:
    """‖port − ref‖ / ‖ref‖ of each leaf, in jax's leaf order."""
    out = []
    for a, w in zip(jax.tree.leaves(recsys_params_to_numpy(port_tree)),
                    jax.tree.leaves(_np(ref_tree))):
        a, w = np.asarray(a, np.float64), np.asarray(w, np.float64)
        out.append(np.linalg.norm(a - w) / max(np.linalg.norm(w), 1e-30))
    return out


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------

@pytest.mark.parametrize("batch,step,seed", [(8, 0, 0), (16, 3, 1), (5, 7, 2)])
def test_recsys_ctr_batch_is_the_reference(batch, step, seed):
    for kw in ({}, {"n_sparse": 39, "rows": 512}):
        a = recsys_ctr_batch(batch, step, seed=seed, **kw)
        w = ref_synthetic.recsys_ctr_batch(batch, step, seed=seed, **kw)
        assert set(a) == set(w)
        for k in w:
            assert a[k].dtype == w[k].dtype
            np.testing.assert_array_equal(a[k], w[k])


@pytest.mark.parametrize("batch,step,seed", [(8, 0, 0), (16, 3, 1), (5, 7, 2)])
def test_recsys_seq_batch_is_the_reference(batch, step, seed):
    for kw in ({"n_items": 1000}, {"n_items": 2048, "n_cats": 64,
                                   "seq_len": 12, "n_neg": 4}):
        a = recsys_seq_batch(batch, step, seed=seed, **kw)
        w = ref_synthetic.recsys_seq_batch(batch, step, seed=seed, **kw)
        assert set(a) == set(w)
        for k in w:
            assert a[k].dtype == w[k].dtype
            np.testing.assert_array_equal(a[k], w[k])


# --------------------------------------------------------------------------
# GRU, MLP, the embedding substrate
# --------------------------------------------------------------------------

def _gru(d_in=6, d_h=5, seed=0):
    ref = ref_common.gru_init(jax.random.PRNGKey(seed), d_in, d_h)
    ref = {k: v + 0.1 * jnp.arange(v.size, dtype=v.dtype).reshape(v.shape)
           / v.size for k, v in ref.items()}          # a non-zero bias
    return ref, {k: _t(v) for k, v in _np(ref).items()}


@pytest.mark.parametrize("with_att", [False, True])
def test_gru_cell_matches_reference(with_att):
    ref, port = _gru()
    rng = np.random.default_rng(1)
    h = rng.normal(size=(4, 5)).astype(np.float32)
    x = rng.normal(size=(4, 6)).astype(np.float32)
    att = rng.random(4).astype(np.float32) if with_att else None
    want = ref_common.gru_cell(ref, jnp.asarray(h), jnp.asarray(x),
                               None if att is None else jnp.asarray(att))
    got = common.gru_cell(port, _t(h), _t(x), None if att is None else _t(att))
    close(got, want)


@pytest.mark.parametrize("with_att", [False, True])
def test_gru_scan_matches_reference(with_att):
    ref, port = _gru()
    rng = np.random.default_rng(2)
    xs = rng.normal(size=(3, 7, 6)).astype(np.float32)
    atts = rng.random((3, 7)).astype(np.float32) if with_att else None
    hs, hT = ref_common.gru_scan(
        ref, jnp.asarray(xs), atts=None if atts is None else jnp.asarray(atts))
    states, final = common.gru_scan(port, _t(xs),
                                    atts=None if atts is None else _t(atts))
    assert tuple(states.shape) == (3, 7, 5)
    close(states, hs)
    close(final, hT)
    dropped, final2 = common.gru_scan(port, _t(xs), keep_states=False,
                                      atts=None if atts is None else _t(atts))
    assert dropped is None and torch.equal(final2, final)


def test_gru_scan_one_row_of_inputs_against_many_states():
    """DIEN's retrieval: one user's inputs against C rows of state, as the
    reference's scan over inputs broadcast to C rows."""
    ref, port = _gru(5, 5)
    rng = np.random.default_rng(3)
    xs = rng.normal(size=(1, 6, 5)).astype(np.float32)
    atts = rng.random((9, 6)).astype(np.float32)
    _, want = ref_common.gru_scan(ref, jnp.broadcast_to(jnp.asarray(xs),
                                                        (9, 6, 5)),
                                  atts=jnp.asarray(atts))
    _, got = common.gru_scan(port, _t(xs), h0=torch.zeros(9, 5),
                             atts=_t(atts), keep_states=False)
    close(got, want)


@pytest.mark.parametrize("final_act", [False, True])
def test_mlp_apply_matches_reference(final_act):
    ref = ref_common.mlp_init(jax.random.PRNGKey(4), [7, 9, 3])
    ref = {k: v - 0.05 for k, v in ref.items()}        # some negative outputs
    port = {k: _t(v) for k, v in _np(ref).items()}
    x = np.random.default_rng(5).normal(size=(6, 7)).astype(np.float32)
    want = ref_common.mlp_apply(ref, jnp.asarray(x), 2, final_act=final_act)
    got = common.mlp_apply(port, _t(x), 2, final_act=final_act)
    close(got, want)
    assert bool((got < 0).any()) != final_act


def test_field_lookup_flat_clips_out_of_range_ids():
    rng = np.random.default_rng(6)
    table = rng.normal(size=(3 * 10, 4)).astype(np.float32)
    ids = np.array([[0, 9, 3], [-5, 10, 99], [2, -1, 12]], np.int32)
    want = ref_rs.field_lookup_flat(jnp.asarray(table), jnp.asarray(ids), 10)
    got = rs.field_lookup_flat(_t(table), _t(ids), 10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[1, 0].numpy(), table[0])
    np.testing.assert_array_equal(got[1, 1].numpy(), table[19])


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_matches_reference(mode):
    rng = np.random.default_rng(7)
    table = rng.normal(size=(20, 5)).astype(np.float32)
    ids = rng.integers(-3, 25, (4, 6)).astype(np.int32)
    mask = rng.random((4, 6)) < 0.6
    mask[2] = False                                    # an empty bag
    want = ref_rs.embedding_bag(jnp.asarray(table), jnp.asarray(ids),
                                jnp.asarray(mask), mode)
    got = rs.embedding_bag(_t(table), _t(ids), _t(mask), mode)
    close(got, want)
    assert not bool(got[2].any())


# --------------------------------------------------------------------------
# The four archs on their smoke configs
# --------------------------------------------------------------------------

REF_FORWARD = {
    "fm": lambda cfg, p, b: ref_rs.fm_forward(cfg, p, b["sparse_ids"]),
    "dcn-v2": lambda cfg, p, b: ref_rs.dcn_forward(cfg, p, b["dense"],
                                                   b["sparse_ids"]),
    "dien": lambda cfg, p, b: ref_rs.dien_forward(cfg, p, b),
    "mind": lambda cfg, p, b: ref_rs.mind_user_interests(
        cfg, p, b["hist_items"], b["hist_mask"]),
}


@pytest.mark.parametrize("arch_id", ARCHS)
def test_forward_matches_reference(arch_id):
    cfg, ref_p, port_p = carried(arch_id)
    rb, pb = batches(arch_id, cfg)
    want = REF_FORWARD[arch_id](ref_get_arch(arch_id).smoke_cfg, ref_p, rb)
    got = steps._RECSYS_SERVE[arch_id](cfg, port_p, pb)
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    close(got, want)


def test_mind_serve_scores_match_reference():
    cfg, ref_p, port_p = carried("mind")
    rb, pb = batches("mind", cfg)
    cand = np.random.default_rng(8).integers(
        0, cfg.n_items + 100, (B, 30)).astype(np.int32)
    want = ref_rs.mind_serve_scores(ref_get_arch("mind").smoke_cfg, ref_p,
                                    rb["hist_items"], rb["hist_mask"],
                                    jnp.asarray(cand))
    got = rs.mind_serve_scores(cfg, port_p, pb["hist_items"], pb["hist_mask"],
                               _t(cand))
    close(got, want)


@pytest.mark.parametrize("arch_id", ARCHS)
def test_loss_and_metrics_match_reference(arch_id):
    cfg, ref_p, port_p = carried(arch_id)
    rb, pb = batches(arch_id, cfg)
    wl, wm = ref_steps._RECSYS_LOSS[arch_id](ref_get_arch(arch_id).smoke_cfg,
                                             ref_p, rb)
    gl, gm = steps._RECSYS_LOSS[arch_id](cfg, port_p, pb)
    close(gl, wl)
    assert set(gm) == set(wm) == {"acc"}
    close(gm["acc"], wm["acc"])


@pytest.mark.parametrize("arch_id", ARCHS)
def test_gradients_match_reference(arch_id):
    cfg, ref_p, port_p = carried(arch_id)
    rb, pb = batches(arch_id, cfg)
    ref_cfg = ref_get_arch(arch_id).smoke_cfg
    want = jax.grad(lambda p: ref_steps._RECSYS_LOSS[arch_id](
        ref_cfg, p, rb)[0])(ref_p)
    from repro_torch.optim.adamw import tree_leaves, tree_unflatten

    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(port_p)]
    loss, _ = steps._RECSYS_LOSS[arch_id](cfg, tree_unflatten(port_p, leaves),
                                          pb)
    grads = tree_unflatten(port_p, list(torch.autograd.grad(loss, leaves)))
    errs = rel_leaf_errors(grads, want)
    assert len(errs) == len(jax.tree.leaves(want))
    assert max(errs) <= GRAD_TOL, errs


@pytest.mark.parametrize("arch_id", ARCHS)
def test_train_step_matches_reference(arch_id):
    """One ``make_train_step`` step (AdamW, the reference smoke test's
    OptConfig) in each package from the same parameters and batch."""
    cfg, ref_p, port_p = carried(arch_id)
    rb, pb = batches(arch_id, cfg)
    ref_cfg = ref_get_arch(arch_id).smoke_cfg
    rstep = jax.jit(ref_make_train_step(
        lambda p, b: ref_steps._RECSYS_LOSS[arch_id](ref_cfg, p, b),
        RefOptConfig(lr=1e-3, total_steps=10)))
    opt = OptConfig(lr=1e-3, total_steps=10)
    pstep = make_train_step(
        lambda p, b: steps._RECSYS_LOSS[arch_id](cfg, p, b), opt)
    rstate, rm = rstep(RefTrainState.create(ref_p, RefOptConfig(
        lr=1e-3, total_steps=10)), rb)
    pstate, pm = pstep(TrainState.create(port_p, opt), pb)
    assert set(pm) == set(rm)
    for k in rm:
        close(pm[k], rm[k], msg=k)
    for a, w in zip(jax.tree.leaves(recsys_params_to_numpy(pstate.params)),
                    jax.tree.leaves(_np(rstate.params))):
        np.testing.assert_allclose(a, w, rtol=0, atol=1e-6)
    assert int(pstate.step) == int(rstate.step) == 1


# --------------------------------------------------------------------------
# Retrieval
# --------------------------------------------------------------------------

def _retrieve(arch_id, cand, k):
    """(reference (scores, ids), the port's) of the arch's retrieval for
    one user (sample 0 of the batch) over candidate ids ``cand``."""
    cfg, ref_p, port_p = carried(arch_id)
    ref_cfg = ref_get_arch(arch_id).smoke_cfg
    rb, pb = batches(arch_id, cfg, step=1)
    rb = {k_: v[:1] for k_, v in rb.items()}
    pb = {k_: v[:1] for k_, v in pb.items()}
    rc = jnp.asarray(cand)
    if arch_id == "fm":
        want = ref_rs.fm_retrieval(ref_cfg, ref_p, rb["sparse_ids"][:, 1:],
                                   rc, k=k)
    elif arch_id == "dcn-v2":
        want = ref_rs.dcn_retrieval(ref_cfg, ref_p, rb["dense"],
                                    rb["sparse_ids"][:, 1:], rc, k=k)
    elif arch_id == "dien":
        want = ref_rs.dien_retrieval(ref_cfg, ref_p, rb, rc, k=k)
    else:
        want = ref_rs.mind_retrieval(ref_cfg, ref_p, rb["hist_items"],
                                     rb["hist_mask"], rc, k=k)
    return want, steps._RECSYS_RETRIEVAL[arch_id](cfg, port_p, pb, _t(cand),
                                                  k)


def _past_rows(arch_id) -> int:
    """Candidates past the arch's rows / items, which clip onto one row
    (dien's onto one item and category per residue mod n_cats): exact
    ties."""
    cfg = get_arch(arch_id).smoke_cfg
    return cfg.rows if arch_id in ("fm", "dcn-v2") else cfg.n_items


def _check_retrieval(want, got, k):
    (ws, wi), (gs, gi) = want, got
    assert tuple(gs.shape) == tuple(gi.shape) == (1, k)
    assert gs.dtype == torch.float32 and gi.dtype == torch.int32
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    close(gs, ws)


@pytest.mark.parametrize("arch_id", ARCHS)
def test_retrieval_matches_reference(arch_id):
    cand = np.arange(_past_rows(arch_id), dtype=np.int32)
    want, got = _retrieve(arch_id, cand, k=20)
    _check_retrieval(want, got, 20)


@pytest.mark.parametrize("arch_id", ARCHS)
def test_retrieval_ties_in_top_k_order(arch_id):
    """The last 8 in-range candidates and 300 past the rows, 64 apart (so
    dien's category, id mod n_cats, is one too): the 300 clip onto one row
    and tie exactly with the in-range candidate of that row.  Every
    candidate is returned; the tied ones must come lowest index first, as
    ``jax.lax.top_k`` orders them, and the ids equal the reference's."""
    past = _past_rows(arch_id)
    cand = np.concatenate([np.arange(past - 8, past),
                           past + 64 * np.arange(300)]).astype(np.int32)
    want, got = _retrieve(arch_id, cand, k=len(cand))
    _check_retrieval(want, got, len(cand))
    ids, scores = got[1][0].numpy(), got[0][0].numpy()
    # fm returns positions in cand: candidate `past` is position 8
    first = ids.tolist().index(8 if arch_id == "fm" else past)
    tied = np.flatnonzero(scores == scores[first])
    # the in-range candidate of the clipped row ties too, but in dien its
    # category (past − 1 mod n_cats) is another
    assert len(tied) == (300 if arch_id == "dien" else 301)
    assert (np.diff(tied) == 1).all() and (np.diff(ids[tied]) > 0).all()


@pytest.mark.parametrize("ndim", [2, 3])
def test_retrieval_scores_exact_matches_reference(ndim):
    rng = np.random.default_rng(9)
    items = rng.normal(size=(300, 8)).astype(np.float32)
    items[200:260] = items[7]                     # exact ties with row 7
    q = rng.normal(size=(3, 4, 8) if ndim == 3 else (3, 8)).astype(np.float32)
    q[0] = items[7] if ndim == 2 else items[7][None]   # row 7's group on top
    ws, wi = ref_rs.retrieval_scores_exact(jnp.asarray(q), jnp.asarray(items),
                                           k=40)
    gs, gi = rs.retrieval_scores_exact(_t(q), _t(items), k=40)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    close(gs, ws)
    assert gi[0, :5].tolist() == [7, 200, 201, 202, 203]


# --------------------------------------------------------------------------
# Configs, shapes, counts, interop, devices, the launcher
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch_id", ARCHS)
def test_config_is_the_reference(arch_id):
    ref, port = ref_get_arch(arch_id), get_arch(arch_id)
    assert (port.id, port.family, port.source) == (ref.id, ref.family,
                                                   ref.source)
    for which in ("model_cfg", "smoke_cfg"):
        a, w = getattr(port, which), getattr(ref, which)
        assert type(a).__name__ == type(w).__name__
        fields = [f.name for f in dataclasses.fields(w)]
        assert fields == [f.name for f in dataclasses.fields(a)]
        for f in fields:
            if f == "dtype":
                assert str(a.dtype).split(".")[-1] == jnp.dtype(w.dtype).name
            else:
                assert getattr(a, f) == getattr(w, f), (which, f)
    assert list(port.shapes) == list(ref.shapes)
    for name, s in ref.shapes.items():
        p = port.shapes[name]
        assert (p.name, p.kind, p.dims, p.accum_steps) == \
            (s.name, s.kind, s.dims, s.accum_steps)


@pytest.mark.parametrize("arch_id", ARCHS)
def test_init_shapes_are_the_reference(arch_id):
    """The port's init gives ``jax.eval_shape``'s shapes and dtypes, for
    the full config (on the meta device: nothing allocated) and the smoke
    config (on the CPU)."""
    ref, port = ref_get_arch(arch_id), get_arch(arch_id)
    init = steps._RECSYS_INIT[arch_id]
    for which, dev in (("model_cfg", "meta"), ("smoke_cfg", "cpu")):
        want = jax.eval_shape(lambda: ref_steps._RECSYS_INIT[arch_id](
            getattr(ref, which), jax.random.PRNGKey(0)))
        got = init(getattr(port, which), device=dev)
        wl = jax.tree_util.tree_leaves_with_path(want)
        gl = jax.tree_util.tree_leaves_with_path(
            jax.tree.map(lambda t: jax.ShapeDtypeStruct(
                tuple(t.shape), str(t.dtype).split(".")[-1]), got,
                is_leaf=lambda x: isinstance(x, torch.Tensor)))
        assert [(p, s.shape, s.dtype) for p, s in gl] == \
            [(p, s.shape, s.dtype) for p, s in wl]


@pytest.mark.parametrize("arch_id", ARCHS)
@pytest.mark.parametrize("B_", [512, 262144])
def test_model_flops_are_the_reference(arch_id, B_):
    assert steps._recsys_model_flops(get_arch(arch_id), B_) == \
        ref_steps._recsys_model_flops(ref_get_arch(arch_id), B_)


@pytest.mark.parametrize("arch_id", ARCHS)
def test_interop_round_trips_and_refuses(arch_id):
    cfg, ref_p, port_p = carried(arch_id)
    back = recsys_params_to_numpy(port_p)
    assert jax.tree.structure(back) == jax.tree.structure(_np(ref_p))
    for a, w in zip(jax.tree.leaves(back), jax.tree.leaves(_np(ref_p))):
        assert a.dtype == w.dtype and a.shape == w.shape
        np.testing.assert_array_equal(a, w)
    tree = _np(ref_p)
    extra = dict(tree, stray=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="stray"):
        recsys_params_from_numpy(cfg, extra, device="cpu")
    missing = {k: v for k, v in tree.items() if k != sorted(tree)[0]}
    with pytest.raises(ValueError, match="not the config's"):
        recsys_params_from_numpy(cfg, missing, device="cpu")
    key = sorted(k for k, v in tree.items() if not isinstance(v, dict))[0]
    wrong = dict(tree, **{key: np.zeros(np.shape(tree[key]) + (2,),
                                        np.float32)})
    with pytest.raises(ValueError, match="shape"):
        recsys_params_from_numpy(cfg, wrong, device="cpu")
    other = get_arch("mind" if arch_id != "mind" else "fm").smoke_cfg
    with pytest.raises(ValueError):
        recsys_params_from_numpy(other, tree, device="cpu")


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_arch("fm").smoke_cfg
    for arch_id, init in steps._RECSYS_INIT.items():
        with pytest.raises(RuntimeError, match="cuda"):
            init(get_arch(arch_id).smoke_cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        steps.recsys_batch("fm", cfg, 4)
    _, ref_p, _ = carried("fm")
    with pytest.raises(RuntimeError, match="cuda"):
        recsys_params_from_numpy(cfg, _np(ref_p))
    assert rs.fm_init(cfg, device="cpu")["emb"].device.type == "cpu"


@pytest.mark.parametrize("arch_id", ARCHS)
def test_launch_train_refuses_a_recsys_arch(arch_id, tmp_path, capsys):
    """``launch.train`` refuses a recsys arch's full config off the card;
    ``--smoke --device cpu`` trains it for 12 steps, leaving its checkpoint
    at step 10, and the same run again resumes from it to a state equal
    bit for bit to an uninterrupted run's."""
    with pytest.raises(SystemExit, match="on the card"):
        launch_train.main(["--arch", arch_id, "--device", "cpu"])
    d = str(tmp_path / "a")
    assert launch_train.main(["--arch", arch_id, "--smoke", "--steps", "12",
                              "--ckpt-dir", d, "--device", "cpu"]) == 0
    assert os.listdir(d) == ["step_000000010"]
    arch = get_arch(arch_id)
    resumed = launch_train.recsys_loop(arch, 12, d, smoke=True, device="cpu")
    assert "[train] resumed from step 10" in capsys.readouterr().out
    whole = launch_train.recsys_loop(arch, 12, str(tmp_path / "b"),
                                     smoke=True, device="cpu")
    assert int(resumed.step) == int(whole.step) == 12
    leaves = lambda s: tree_leaves([s.params, s.opt_state, s.step])  # noqa
    for a, w in zip(leaves(resumed), leaves(whole)):
        assert torch.equal(a, w)
