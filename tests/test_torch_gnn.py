"""The port's GNN slice (``repro_torch.data``'s graphs and sampler,
``models.gnn``, ``configs.gat_cora``, ``interop.gnn_params_*``,
``launch.steps``'s GNN cell, ``launch.train``'s GAT loop) against the JAX
package's, on the CPU, on numpy-seeded inputs and the reference's own
parameters carried across with ``interop.gnn_params_from_numpy``.

Tolerances: the graph data and the sampler bit for bit (the same numpy
code); the GAT's logits, loss and readout to rtol 1e-5 (atol 1e-7 near
0), its accuracy exactly, its gradients to 1e-5 of each leaf's ‖ref‖ (the
same f32 math summed in another order; the readings are ≈ 1e-6); edge
chunks against the one-piece path to 1e-6 of ‖·‖ (the same per-edge
values added to the nodes in another grouping); one AdamW step's
parameters to atol 1e-6 at lr 1e-2 (an update moves each weight by at
most ~lr; m / √v amplifies a gradient's rounding only near eps).  The
launcher's runs against themselves are bitwise.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.configs.base import get_arch as ref_get_arch
from repro.data import sampler as ref_sampler
from repro.data import synthetic as ref_synthetic
from repro.launch import steps as ref_steps
from repro.launch.mesh import make_host_mesh
from repro.models import gnn as ref_gnn
from repro.optim import OptConfig as RefOptConfig
from repro.train import TrainState as RefTrainState
from repro.train import make_train_step as ref_make_train_step

from repro_torch.configs import get_arch
from repro_torch.data import CSRGraph, fanout_sample, molecule_batch, sbm_graph
from repro_torch.interop import gnn_params_from_numpy, gnn_params_to_numpy
from repro_torch.launch import steps
from repro_torch.launch import train as launch_train
from repro_torch.models import gnn
from repro_torch.optim import OptConfig
from repro_torch.optim.adamw import tree_leaves, tree_unflatten
from repro_torch.train import TrainState, make_train_step

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-7
GRAD_TOL = 1e-5
CHUNK_TOL = 1e-6
KINDS = ("full", "sampled", "molecule")
CHUNKS = (None, 1, 7, 50, 100_000)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def ref_cfg(kind):
    cfg = ref_get_arch("gat-cora").smoke_cfg
    return dataclasses.replace(cfg, readout="mean") if kind == "molecule" \
        else cfg


def port_cfg(kind):
    cfg = get_arch("gat-cora").smoke_cfg
    return dataclasses.replace(cfg, readout="mean") if kind == "molecule" \
        else cfg


def carried(kind, seed=0):
    """(reference params, the port's params from them)."""
    params = ref_gnn.init(ref_cfg(kind), jax.random.PRNGKey(seed))
    return params, gnn_params_from_numpy(port_cfg(kind), _np(params),
                                         device="cpu")


def graph(kind, seed=0) -> dict:
    """A numpy batch of the smoke config (16 features, 4 classes): a full
    ``sbm_graph`` with every node labelled, a ``fanout_sample`` of a
    larger one padded past its size (padded edges, src = -1) with its seed
    nodes labelled, or a ``molecule_batch`` (labels per graph)."""
    if kind == "molecule":
        b = molecule_batch(6, 7, 12, 16, 4, step=seed)
        b["label_mask"] = np.ones(6, bool)
        b["n_graphs"] = 6
        return b
    if kind == "full":
        g = sbm_graph(80, 4, 16, avg_degree=3.0, seed=seed)
        return {"x": g["x"], "src": g["src"], "dst": g["dst"],
                "labels": g["labels"], "label_mask": np.ones(80, bool)}
    g = sbm_graph(400, 4, 16, avg_degree=4.0, seed=seed)
    csr = CSRGraph.from_edges(g["src"], g["dst"], 400, device="cpu")
    b = fanout_sample(csr, g["x"], g["labels"], np.arange(8) * 7, (4, 3),
                      seed=seed, pad_nodes=160, pad_edges=160)
    assert b["n_sub_edges"] < 160 and b["n_sub_nodes"] < 160
    return {k: v for k, v in b.items() if not k.startswith("n_sub")}


def _ref_loss(kind, b):
    cfg = ref_cfg(kind)
    return lambda p: ref_gnn.loss_fn(
        cfg, p, jnp.asarray(b["x"]), jnp.asarray(b["src"]),
        jnp.asarray(b["dst"]), jnp.asarray(b["labels"]),
        jnp.asarray(b["label_mask"]),
        graph_ids=None if "graph_ids" not in b else jnp.asarray(b["graph_ids"]),
        n_graphs=b.get("n_graphs", 0),
        node_mask=None if "node_mask" not in b else jnp.asarray(b["node_mask"]))


def _port_batch(b):
    return {k: (_t(v) if isinstance(v, np.ndarray) else v)
            for k, v in b.items()}


def port_loss_and_grads(kind, params, b, chunk):
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, aux = steps.gnn_loss(port_cfg(kind), chunk)(
        tree_unflatten(params, leaves), _port_batch(b))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), aux, tree_unflatten(params, grads)


def rel_leaf_errors(port_tree, ref_tree) -> list:
    """‖port − ref‖ / ‖ref‖ of each leaf, in jax's leaf order."""
    out = []
    for a, w in zip(jax.tree.leaves(gnn_params_to_numpy(port_tree)),
                    jax.tree.leaves(_np(ref_tree))):
        a, w = np.asarray(a, np.float64), np.asarray(w, np.float64)
        out.append(np.linalg.norm(a - w) / max(np.linalg.norm(w), 1e-30))
    return out


def close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=msg)


# --------------------------------------------------------------------------
# data and sampler
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,comms,d_feat,deg,seed", [
    (100, 7, 5, 4.0, 0), (300, 4, 16, 2.5, 3), (64, 8, 8, 1.0, 1)])
def test_sbm_graph_is_the_reference(n, comms, d_feat, deg, seed):
    want = ref_synthetic.sbm_graph(n, comms, d_feat, deg, seed=seed)
    got = sbm_graph(n, comms, d_feat, deg, seed=seed)
    assert set(got) == set(want) and got["n_classes"] == want["n_classes"]
    for k in ("x", "src", "dst", "labels"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("batch,nodes,edges,d_feat,classes,step", [
    (4, 6, 10, 16, 4, 0), (128, 30, 64, 32, 2, 5)])
def test_molecule_batch_is_the_reference(batch, nodes, edges, d_feat,
                                         classes, step):
    want = ref_synthetic.molecule_batch(batch, nodes, edges, d_feat, classes,
                                        step)
    got = molecule_batch(batch, nodes, edges, d_feat, classes, step)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def _edges(case):
    rng = np.random.default_rng(case)
    if case == 0:
        g = sbm_graph(500, 5, 8, 6.0, seed=2)
        return g["src"], g["dst"], 500
    if case == 1:                   # no edges
        return np.zeros(0, np.int32), np.zeros(0, np.int32), 500
    if case == 2:                   # 7 destinations, long ties
        return (rng.integers(0, 500, 5000).astype(np.int32),
                rng.integers(0, 7, 5000).astype(np.int32), 500)
    # int64 ids, isolated nodes at both ends
    return (rng.integers(0, 500, 3000),
            rng.integers(100, 400, 3000), 500)


@pytest.mark.parametrize("case", [0, 1, 2, 3])
def test_csr_from_edges_is_the_reference(case):
    src, dst, n = _edges(case)
    want = ref_sampler.CSRGraph.from_edges(src, dst, n)
    got = CSRGraph.from_edges(src, dst, n, device="cpu")
    assert got.n_nodes == want.n_nodes == 500
    for k in ("indptr", "indices"):
        assert getattr(got, k).dtype == getattr(want, k).dtype
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))


@pytest.mark.parametrize("fanouts,pads,seed", [
    ((5, 3), (None, None), 0), ((4, 4), (600, 900), 1),
    ((10, 10), (50, 70), 2)])          # the last pads cut the subgraph
def test_fanout_sample_is_the_reference(fanouts, pads, seed):
    g = sbm_graph(700, 5, 12, 5.0, seed=seed)
    seeds = np.random.default_rng(seed).choice(700, 24, replace=False)
    args = (g["x"], g["labels"], seeds, fanouts)
    kw = dict(seed=seed, pad_nodes=pads[0], pad_edges=pads[1])
    want = ref_sampler.fanout_sample(
        ref_sampler.CSRGraph.from_edges(g["src"], g["dst"], 700), *args, **kw)
    got = fanout_sample(CSRGraph.from_edges(g["src"], g["dst"], 700, "cpu"), *args,
                        **kw)
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype
            np.testing.assert_array_equal(got[k], v)
        else:
            assert got[k] == v
    if pads[0] == 50:
        assert got["n_sub_edges"] > 70 and got["n_sub_nodes"] > 50
        shape = dataclasses.replace(
            get_arch("gat-cora").shapes["minibatch_lg"],
            dims={"pad_nodes": 50, "pad_edges": 70})
        with pytest.raises(RuntimeError, match="cut it"):
            steps.check_untruncated(got, shape)


# --------------------------------------------------------------------------
# the GAT
# --------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("kind", KINDS)
def test_forward_matches_reference(kind, chunk):
    ref_p, port_p = carried(kind)
    b = graph(kind)
    want = ref_gnn.forward(ref_cfg(kind), ref_p, jnp.asarray(b["x"]),
                           jnp.asarray(b["src"]), jnp.asarray(b["dst"]))
    got = gnn.forward(port_cfg(kind), port_p, _t(b["x"]), _t(b["src"]),
                      _t(b["dst"]), edge_chunk=chunk)
    close(got, want)
    if kind == "molecule":
        args = (jnp.asarray(b["graph_ids"]), b["n_graphs"],
                jnp.asarray(b["node_mask"]))
        close(gnn.graph_readout(got, _t(b["graph_ids"]), b["n_graphs"],
                                _t(b["node_mask"])),
              ref_gnn.graph_readout(want, *args))


def test_graph_readout_leaves_masked_nodes_out():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(12, 3)).astype(np.float32)
    gid = np.repeat(np.arange(4), 3).astype(np.int32)
    mask = rng.random(12) < 0.6
    mask[9:] = False                        # graph 3 has no node left
    want = ref_gnn.graph_readout(jnp.asarray(logits), jnp.asarray(gid), 4,
                                 jnp.asarray(mask))
    got = gnn.graph_readout(_t(logits), _t(gid), 4, _t(mask))
    close(got, want)
    assert float(got[3].abs().sum()) == 0.0


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("kind", KINDS)
def test_loss_and_gradients_match_reference(kind, chunk):
    """``loss_fn``, its accuracy and every gradient leaf against
    ``jax.value_and_grad`` of the reference's ``loss_fn``."""
    ref_p, port_p = carried(kind)
    b = graph(kind)
    (rloss, raux), rgrads = jax.value_and_grad(
        _ref_loss(kind, b), has_aux=True)(ref_p)
    loss, aux, grads = port_loss_and_grads(kind, port_p, b, chunk)
    close(loss, rloss)
    assert float(aux["acc"]) == float(raux["acc"])
    errs = rel_leaf_errors(grads, rgrads)
    assert max(errs) <= GRAD_TOL, errs


@pytest.mark.parametrize("chunk", [1, 3, 16, 61])
def test_chunked_equals_one_piece(chunk):
    """Chunks that split a destination's in-edges (checked) against the
    one-piece path: logits, loss and gradients."""
    _, port_p = carried("full")
    b = graph("full")
    part = np.arange(b["dst"].size) // chunk
    first = np.full(80, part.max() + 1)
    np.minimum.at(first, b["dst"], part)
    last = np.full(80, -1)
    np.maximum.at(last, b["dst"], part)
    assert (last > first).any(), "no chunk splits a destination's in-edges"
    want = port_loss_and_grads("full", port_p, b, None)
    got = port_loss_and_grads("full", port_p, b, chunk)
    close(got[0], want[0], rtol=CHUNK_TOL)
    for a, w in zip(tree_leaves(got[2]), tree_leaves(want[2])):
        assert float((a - w).norm()) <= CHUNK_TOL * max(float(w.norm()),
                                                        1e-30)


@pytest.mark.parametrize("kind", KINDS)
def test_train_step_matches_reference(kind):
    """One ``make_train_step`` step (AdamW at the reference smoke test's lr
    1e-2) in each package from the same parameters and batch."""
    ref_p, port_p = carried(kind)
    b = graph(kind)
    ropt = RefOptConfig(lr=1e-2, total_steps=10)
    rstep = jax.jit(ref_make_train_step(
        lambda p, _b: _ref_loss(kind, b)(p), ropt))
    rstate, rm = rstep(RefTrainState.create(ref_p, ropt), {})
    opt = OptConfig(lr=1e-2, total_steps=10)
    pstate, pm = make_train_step(steps.gnn_loss(port_cfg(kind), 7), opt)(
        TrainState.create(port_p, opt), _port_batch(b))
    assert set(pm) == set(rm)
    for k in rm:
        close(pm[k], rm[k], msg=k)
    for a, w in zip(jax.tree.leaves(gnn_params_to_numpy(pstate.params)),
                    jax.tree.leaves(_np(rstate.params))):
        np.testing.assert_allclose(a, w, rtol=0, atol=1e-6)
    assert int(pstate.step) == int(rstate.step) == 1


# --------------------------------------------------------------------------
# config, interop, the cell
# --------------------------------------------------------------------------

def _same_cfg(a, w, what):
    assert type(a).__name__ == type(w).__name__
    fields = [f.name for f in dataclasses.fields(w)]
    assert fields == [f.name for f in dataclasses.fields(a)]
    for f in fields:
        if f == "dtype":
            assert str(a.dtype).split(".")[-1] == jnp.dtype(w.dtype).name
        else:
            assert getattr(a, f) == getattr(w, f), (what, f)
    assert a.layer_dims == w.layer_dims


def test_config_is_the_reference():
    ref, port = ref_get_arch("gat-cora"), get_arch("gat-cora")
    assert (port.id, port.family, port.source) == (ref.id, ref.family,
                                                   ref.source)
    assert list(port.model_cfg) == list(ref.model_cfg)
    for name, w in ref.model_cfg.items():
        _same_cfg(port.model_cfg[name], w, name)
    _same_cfg(port.smoke_cfg, ref.smoke_cfg, "smoke")
    assert list(port.shapes) == list(ref.shapes)
    for name, s in ref.shapes.items():
        p = port.shapes[name]
        assert (p.name, p.kind, p.dims, p.accum_steps) == \
            (s.name, s.kind, s.dims, s.accum_steps)


@pytest.mark.parametrize("shape_name", ["full_graph_sm", "minibatch_lg",
                                        "ogb_products", "molecule"])
def test_init_flops_and_batch_are_the_cell(shape_name):
    """At each cell: the port's init gives ``jax.eval_shape``'s shapes (on
    the meta device), ``_gnn_model_flops`` the reference cell's count, and
    the batch's sizes those the cell declares (made here for the small
    cells; at ogb_products and minibatch_lg ``_gnn_sizes`` against the
    declaration)."""
    ref, port = ref_get_arch("gat-cora"), get_arch("gat-cora")
    cell = ref_steps._gnn_cell(ref, ref.shapes[shape_name], make_host_mesh())
    want = jax.eval_shape(lambda: ref_gnn.init(ref.model_cfg[shape_name],
                                               jax.random.PRNGKey(0)))
    got = gnn.init(port.model_cfg[shape_name], device="meta")
    assert jax.tree.map(lambda s: s.shape, want) == \
        jax.tree.map(lambda t: tuple(t.shape), got,
                     is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert steps._gnn_model_flops(port, shape_name) == cell.model_flops
    declared = {k: (v.shape, np.dtype(v.dtype).name)
                for k, v in cell.args[1].items()}
    n_nodes, n_edges, n_graphs = steps._gnn_sizes(port.shapes[shape_name])
    assert (declared["x"][0][0], declared["src"][0][0]) == (n_nodes, n_edges)
    assert declared["labels"][0][0] == (n_graphs or n_nodes)
    if shape_name in ("full_graph_sm", "molecule"):
        b = steps.gnn_batch(port, shape_name, step=1, device="cpu")
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in b.items() if isinstance(v, torch.Tensor)} \
            == {k: (tuple(s), d) for k, (s, d) in declared.items()}
        assert bool(b["label_mask"].all())


def test_gnn_batch_samples_the_minibatch_cell(monkeypatch):
    """The minibatch cell at a cut size: the seed nodes drawn by the step,
    ``fanout_sample`` of the cell's graph padded to the pads, the sizes
    before the pads and the seed nodes labelled; the full-graph cells'
    ``sbm_graph`` has exactly the cell's edges."""
    arch = get_arch("gat-cora")
    shape = arch.shapes["minibatch_lg"]
    dims = dict(shape.dims, n_nodes=3000, n_edges=24000, batch_nodes=16,
                fanout=(5, 3), pad_nodes=400, pad_edges=400)
    small = dataclasses.replace(arch, shapes={
        "minibatch_lg": dataclasses.replace(shape, dims=dims)})
    b1 = steps.gnn_batch(small, "minibatch_lg", step=1, device="cpu")
    b2 = steps.gnn_batch(small, "minibatch_lg", step=2, device="cpu")
    g = sbm_graph(3000, 41, 602, steps.sbm_avg_degree(3000, 24000), seed=0)
    assert g["src"].size == 24000
    seeds = np.random.default_rng((0, 1)).choice(3000, 16, replace=False)
    want = ref_sampler.fanout_sample(
        ref_sampler.CSRGraph.from_edges(g["src"], g["dst"], 3000), g["x"],
        g["labels"], seeds, (5, 3), seed=1, pad_nodes=400, pad_edges=400)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(b1[k].numpy(), v)
        else:
            assert b1[k] == v
    steps.check_untruncated(b1, small.shapes["minibatch_lg"])
    assert int(b1["label_mask"].sum()) == 16
    assert not torch.equal(b1["src"], b2["src"])
    assert b2["graph_s"] == b1["graph_s"] and b2["csr_s"] == b1["csr_s"]


def test_interop_round_trips_and_refuses():
    ref_p, port_p = carried("full")
    back = gnn_params_to_numpy(port_p)
    assert jax.tree.structure(back) == jax.tree.structure(_np(ref_p))
    for a, w in zip(jax.tree.leaves(back), jax.tree.leaves(_np(ref_p))):
        assert a.dtype == w.dtype and a.shape == w.shape
        np.testing.assert_array_equal(a, w)
    cfg = port_cfg("full")
    tree = _np(ref_p)
    with pytest.raises(ValueError, match="stray"):
        gnn_params_from_numpy(cfg, dict(tree, stray=np.zeros(3)),
                              device="cpu")
    wrong = {**tree, "layer0": dict(tree["layer0"],
                                    w=np.zeros((3, 3), np.float32))}
    with pytest.raises(ValueError, match="shape"):
        gnn_params_from_numpy(cfg, wrong, device="cpu")
    with pytest.raises(ValueError):
        gnn_params_from_numpy(get_arch("gat-cora").model_cfg["molecule"],
                              tree, device="cpu")


def test_plan_edge_chunk():
    """ogb_products does not fit an 80 GB card in one piece: chunks of a
    multiple of 2¹⁶ edges; the other cells do; a card too small for the
    node tensors is refused."""
    arch = get_arch("gat-cora")
    card = 80 * 10**9
    for name in arch.shapes:
        n_nodes, n_edges, _ = steps._gnn_sizes(arch.shapes[name])
        chunk = gnn.plan_edge_chunk(arch.model_cfg[name], n_nodes, n_edges,
                                    card)
        if name == "ogb_products":
            assert chunk is not None and chunk % (1 << 16) == 0
            assert 1 << 20 <= chunk < n_edges
        else:
            assert chunk is None, name
    with pytest.raises(SystemExit, match="node tensors"):
        gnn.plan_edge_chunk(arch.model_cfg["ogb_products"], 2_449_029,
                            61_859_140, 8 * 10**9)


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arch = get_arch("gat-cora")
    with pytest.raises(RuntimeError, match="cuda"):
        gnn.init(arch.smoke_cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        steps.gnn_batch(arch, "molecule", 0)
    ref_p, _ = carried("full")
    with pytest.raises(RuntimeError, match="cuda"):
        gnn_params_from_numpy(arch.smoke_cfg, _np(ref_p))
    with pytest.raises(SystemExit, match="on the card"):
        launch_train.main(["--arch", "gat-cora", "--shape", "molecule",
                           "--device", "cpu"])
    assert gnn.init(arch.smoke_cfg, device="cpu")["layer0"]["w"].device.type \
        == "cpu"


def _state_leaves(state):
    return tree_leaves([state.params, state.opt_state, state.step])


def test_launch_train_gnn_smoke_resumes_bitwise(tmp_path, capsys):
    """``--arch gat-cora --smoke --device cpu`` for 12 steps leaves its
    checkpoint at step 10; the same run again resumes from it to a state
    equal bit for bit to an uninterrupted run's, whose loss fell."""
    d = str(tmp_path / "a")
    assert launch_train.main(["--arch", "gat-cora", "--smoke", "--steps",
                              "12", "--ckpt-dir", d, "--device", "cpu"]) == 0
    assert os.listdir(d) == ["step_000000010"]
    arch = get_arch("gat-cora")
    resumed = launch_train.gnn_loop(arch, "full_graph_sm", 12, d, smoke=True,
                                    device="cpu")
    assert "[train] resumed from step 10" in capsys.readouterr().out
    whole = launch_train.gnn_loop(arch, "full_graph_sm", 12,
                                  str(tmp_path / "b"), smoke=True,
                                  device="cpu")
    assert int(resumed.step) == int(whole.step) == 12
    for a, w in zip(_state_leaves(resumed), _state_leaves(whole)):
        assert torch.equal(a, w)
    b = launch_train._smoke_graph(arch.smoke_cfg, "cpu")
    loss = steps.gnn_loss(arch.smoke_cfg)
    start = gnn.init(arch.smoke_cfg, torch.Generator().manual_seed(0),
                     device="cpu")
    assert float(loss(whole.params, b)[0]) < float(loss(start, b)[0])
