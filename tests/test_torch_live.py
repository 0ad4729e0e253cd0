"""The port's checkpoint manager, live updates (insert / delete /
consolidate, ``search_live``), write-ahead log and recovery, and graph
auditor against the JAX package's.

The contract: the same files on disk (a checkpoint or a journal either
package wrote restores and recovers in the other to the same arrays), the
same arrays out of every op on the same graph (neighbours, tombstones,
medoid and vectors identical, not close: each op's building blocks are
bit-identical, ``tests/test_torch_core.py``), ``search_live`` ids equal at
W = 1, the reference's crash-point sweep recovering bit-identically, and
audit reports equal to the reference's on each corrupted graph of
``tests/test_verify.py``.  Fault-injection tests carry the ``faults``
marker where their counterparts do.
"""

import dataclasses
import importlib
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.checkpoint import restore_latest as ref_restore
from repro.checkpoint import save_checkpoint as ref_save
from repro.core import updates as RU
from repro.core import verify as RV
from repro.core.build_approx import BuildParams as RefBuildParams
from repro.core.build_approx import build_approx as ref_build_approx

from repro_torch.checkpoint import (
    CheckpointManager,
    list_steps,
    restore_latest,
    save_checkpoint,
)
from repro_torch.core import updates as U
from repro_torch.core import verify as V
from repro_torch.core.build_approx import BuildParams
from repro_torch.testing import (
    SimulatedCrash,
    crash_at,
    flip_bits,
    make_torn_tmp,
    tamper_array,
    tear_checkpoint,
    torn_wal_record,
)

from conftest import gmm
from test_torch_search import to_port

torch.set_num_threads(1)

BP = dict(max_degree=10, beam_width=20, t=10, iters=1, block=128)
CRASH_POINTS = ("before_journal", "torn_journal", "after_journal",
                "mid_splice")
D = 16
# audit violations of a corrupted structure (reachability and monotone
# descent are properties of this small corpus's graph, as in the reference)
STRUCTURAL = ("out of range", "self-loop", "duplicate", "isolated",
              "tombstoned")


@pytest.fixture(scope="module")
def ref_graph():
    return ref_build_approx(gmm(480, D, 10, seed=3), RefBuildParams(**BP))


def _lives(ref_graph):
    return (RU.as_live(ref_graph, RefBuildParams(**BP)),
            U.as_live(to_port(ref_graph), BuildParams(**BP)))


def _batch(seed, m=24):
    return gmm(m, D, 10, seed=seed)


def _arrays(live):
    """(vectors, neighbors, medoid, tombstones) of either package's
    LiveIndex, as numpy."""
    g = live.graph
    tomb = live.tombstones
    tomb = tomb.numpy() if isinstance(tomb, torch.Tensor) else tomb
    return (np.asarray(g.vectors), np.asarray(g.neighbors),
            int(np.asarray(g.medoid)), np.asarray(tomb))


def assert_same(a, b):
    va, na, ma, ta = _arrays(a)
    vb, nb, mb, tb = _arrays(b)
    np.testing.assert_array_equal(va, vb)
    np.testing.assert_array_equal(na, nb)
    assert ma == mb
    np.testing.assert_array_equal(ta, tb)
    assert ta.dtype == tb.dtype == np.bool_


# ---------------------------------------------------------------------------
# Checkpoint files, both ways.
# ---------------------------------------------------------------------------


def _tree(offset=0.0):
    rng = np.random.default_rng(int(offset))
    return {"w": (rng.normal(size=(3, 4)) + offset).astype(np.float32),
            "layers": [{"b": np.arange(4, dtype=np.int32) + int(offset)},
                       {"b": np.ones(2, np.bool_)}],
            "a": np.float32(offset)}


def _template():
    return {"w": np.zeros((3, 4), np.float32),
            "layers": [{"b": np.zeros(4, np.int32)},
                       {"b": np.zeros(2, np.bool_)}],
            "a": np.float32(0)}


def _step(d, step):
    return os.path.join(d, f"step_{step:09d}")


def _assert_tree(got, want):
    np.testing.assert_array_equal(np.asarray(got["w"]), want["w"])
    for g, w in zip(got["layers"], want["layers"]):
        np.testing.assert_array_equal(np.asarray(g["b"]), w["b"])
    assert float(np.asarray(got["a"])) == float(want["a"])


def test_checkpoint_files_are_the_reference_files(tmp_path):
    """The same tree saved by each package: the same manifest JSON and the
    same arrays in the same npz order."""
    ref_dir, port_dir = str(tmp_path / "r"), str(tmp_path / "t")
    tree = _tree(1.0)
    ref_save(ref_dir, 7, {k: (jnp.asarray(v) if k == "w" else v)
                          for k, v in tree.items()})
    save_checkpoint(port_dir, 7, {**tree, "w": torch.from_numpy(tree["w"])})
    with open(os.path.join(_step(ref_dir, 7), "manifest.json")) as f:
        r_man = f.read()
    with open(os.path.join(_step(port_dir, 7), "manifest.json")) as f:
        t_man = f.read()
    assert t_man == r_man
    assert json.loads(t_man)["keys"] == ["a", "layers/0/b", "layers/1/b", "w"]
    with np.load(os.path.join(_step(ref_dir, 7), "arrays.npz")) as r, \
            np.load(os.path.join(_step(port_dir, 7), "arrays.npz")) as t:
        assert t.files == r.files
        for k in r.files:
            np.testing.assert_array_equal(t[k], r[k])
            assert t[k].dtype == r[k].dtype


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_restores_in_the_other_package(tmp_path, writer):
    d = str(tmp_path)
    save = ref_save if writer == "reference" else save_checkpoint
    save(d, 100, _tree(0.0))
    save(d, 200, _tree(2.0))
    if writer == "reference":
        step, got = restore_latest(d, _template(), device="cpu")
        assert isinstance(got["w"], torch.Tensor)
        assert got["layers"][1]["b"].dtype == torch.bool
    else:
        step, got = ref_restore(d, _template())
    assert step == 200
    _assert_tree(got, _tree(2.0))


@pytest.mark.faults
@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("damage", ["flip_bits", "tear_manifest"])
def test_checkpoint_walk_back_across_packages(tmp_path, writer, damage):
    """A step the other package wrote, bit-flipped or with its manifest
    torn, is skipped: the restore walks back to the older step."""
    d = str(tmp_path)
    save = ref_save if writer == "reference" else save_checkpoint
    save(d, 100, _tree(0.0))
    save(d, 200, _tree(2.0))
    if damage == "flip_bits":
        flip_bits(os.path.join(_step(d, 200), "arrays.npz"), n_bits=16, seed=3)
    else:
        tear_checkpoint(_step(d, 200))
    step_t, got_t = restore_latest(d, _template(), device="cpu")
    step_r, got_r = ref_restore(d, _template())
    assert step_t == step_r == 100
    _assert_tree(got_t, _tree(0.0))
    _assert_tree(got_r, _tree(0.0))


@pytest.mark.faults
def test_checksum_mismatch_and_torn_tmp_walk_back(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 100, _tree(0.0))
    save_checkpoint(d, 200, _tree(2.0))
    tamper_array(_step(d, 200))
    make_torn_tmp(d, 300)
    assert list_steps(d) == [100, 200]
    step, got = restore_latest(d, _template(), device="cpu")
    assert step == 100
    _assert_tree(got, _tree(0.0))
    step_nv, _ = restore_latest(d, _template(), device="cpu", verify=False)
    assert step_nv == 200
    save_checkpoint(d, 400, _tree(4.0), keep=2)   # prunes the torn .tmp
    assert sorted(os.listdir(d)) == ["step_000000200", "step_000000400"]


def test_checkpoint_restores_onto_template_devices_and_dtypes(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, {"x": torch.arange(6, dtype=torch.int32),
                           "y": np.ones(3, np.float64)})
    step, got = restore_latest(
        d, {"x": torch.zeros(6, dtype=torch.int64), "y": np.zeros(3, np.float32)},
        device="cpu")
    assert step == 1
    assert got["x"].dtype == torch.int64 and got["y"].dtype == torch.float32
    assert got["x"].tolist() == list(range(6))
    # bf16 is stored as its raw 16 bits (numpy |V2, manifest "bfloat16")
    # and restored to bf16 bit for bit
    x = torch.tensor([1.0, -2.5, 3.1415, 1e-20]).to(torch.bfloat16)
    save_checkpoint(d, 2, {"x": x})
    step, got = restore_latest(d, {"x": torch.zeros(4, dtype=torch.bfloat16)},
                               device="cpu")
    assert step == 2 and got["x"].dtype == torch.bfloat16
    assert torch.equal(got["x"].view(torch.int16), x.view(torch.int16))


def test_checkpoint_manager_saves_host_copies(tmp_path):
    mgr = CheckpointManager(str(tmp_path), every=2, keep=2)
    x = torch.zeros(4)
    assert not mgr.maybe_save(1, {"x": x})
    assert mgr.maybe_save(2, {"x": x})
    x += 5.0                                     # after the copy: not saved
    mgr.wait()
    step, got = mgr.restore({"x": torch.zeros(4)}, device="cpu")
    assert step == 2 and got["x"].tolist() == [0.0] * 4


# ---------------------------------------------------------------------------
# Live ops against the reference.
# ---------------------------------------------------------------------------


def test_insert_delete_consolidate_match_reference(ref_graph):
    """Two inserts, deletes and a consolidate give the reference's arrays.
    The dead set iterates out of ascending order, and some live nodes have
    two or more dead out-neighbours, so the batched consolidate must follow
    the reference's per-pair order."""
    rl, tl = _lives(ref_graph)
    for seed in (11, 12):
        rl = RU.insert(rl, _batch(seed))
        tl = U.insert(tl, _batch(seed))
        assert_same(rl, tl)
    n = rl.graph.n
    dead = np.random.default_rng(4).choice(
        np.setdiff1d(np.arange(n), [int(np.asarray(rl.graph.medoid))]),
        int(0.1 * n), replace=False)
    rl, tl = RU.delete(rl, dead), U.delete(tl, dead)
    assert_same(rl, tl)
    order = list(set(np.where(rl.tombstones)[0].tolist()))
    assert order != sorted(order)
    nbr = np.asarray(rl.graph.neighbors)
    n_dead_out = (rl.tombstones[np.maximum(nbr, 0)] & (nbr >= 0)).sum(1)
    assert (n_dead_out[~rl.tombstones] >= 2).sum() > 0
    rl, tl = RU.consolidate(rl), U.consolidate(tl)
    assert_same(rl, tl)
    assert tl.graph.n == n - dead.size
    rl = RU.insert(rl, _batch(13))
    tl = U.insert(tl, _batch(13))
    assert_same(rl, tl)


def test_insert_into_rows_with_holes_matches_reference(ref_graph):
    """A row with a -1 hole inside (as a consolidate leaves one whose merge
    was empty): the reverse-edge loop appends at the row's valid count,
    over a valid entry, and a full row then reads id -1, which numpy takes
    for the last vector; the port does as the reference does."""
    nbr = np.asarray(ref_graph.neighbors).copy()
    nbr[::3, 2] = -1
    graph = dataclasses.replace(ref_graph, neighbors=jnp.asarray(nbr))
    rl, tl = _lives(graph)
    for seed in (21, 22):
        rl = RU.insert(rl, _batch(seed, m=40))
        tl = U.insert(tl, _batch(seed, m=40))
        assert_same(rl, tl)
    got = np.asarray(rl.graph.neighbors)[:480:3]
    assert ((got[:, :-1] < 0) & (got[:, 1:] >= 0)).any()     # holes stay


def test_repair_matches_reference_at_full_width():
    """The connectivity repair every insert runs, at d = 128 with full
    rows hit several times in one chunk: its edge lengths are summed in
    numpy as the reference's, so the same edge is evicted."""
    from repro.core.distances import brute_force_knn as ref_knn

    # the modules, not the functions the packages export under their name
    rba = importlib.import_module("repro.core.build_approx")
    tba = importlib.import_module("repro_torch.core.build_approx")

    base = gmm(700, 128, 8, seed=9)
    # two halves, each a full 12-NN graph of its own: the second is cut off
    nbr = np.concatenate([
        np.asarray(ref_knn(h, h, 12, exclude_self=True)[1]) + off
        for h, off in ((base[:350], 0), (base[350:], 350))]).astype(np.int32)
    deg = np.full(700, 12, np.int32)
    r_nbr, r_deg = nbr.copy(), deg.copy()
    r_fixed = rba._repair_connectivity(base, r_nbr, r_deg, 12, 0)
    t_nbr, t_deg = torch.from_numpy(nbr.copy()), torch.from_numpy(deg.copy())
    t_fixed = tba._repair_connectivity(torch.from_numpy(base), t_nbr, t_deg,
                                       12, 0)
    assert t_fixed == r_fixed > 350
    np.testing.assert_array_equal(t_nbr.numpy(), r_nbr)
    np.testing.assert_array_equal(t_deg.numpy(), r_deg)


def test_search_live_matches_reference(ref_graph):
    rl, tl = _lives(ref_graph)
    dead = np.arange(0, 480, 7)
    rl, tl = RU.delete(rl, dead), U.delete(tl, dead)
    queries = gmm(32, D, 10, seed=8)
    r = RU.search_live(rl, queries, 10)
    t = U.search_live(tl, queries, 10)
    np.testing.assert_array_equal(t.ids.numpy(), np.asarray(r.ids))
    np.testing.assert_allclose(t.dists.numpy(), np.asarray(r.dists),
                               rtol=1e-4, atol=1e-4)
    got = t.ids.numpy()
    assert not tl.tombstones.numpy()[got[got >= 0]].any()


# ---------------------------------------------------------------------------
# Journals across packages; the crash-point sweep in the port.
# ---------------------------------------------------------------------------


def _stream(j, seed=0):
    j.insert(_batch(seed + 1))
    j.delete(np.arange(5, 200, 9))
    j.insert(_batch(seed + 2))
    j.consolidate()
    j.insert(_batch(seed + 3))


def test_journal_times_its_stages(ref_graph, tmp_path):
    """With a metrics registry the journal observes each insert's and
    consolidate's stages into ``live_stage_seconds`` {op, stage}, once an
    op, and its arrays stay the reference's."""
    from repro_torch.obs import MetricsRegistry

    rl, tl = _lives(ref_graph)
    reg = MetricsRegistry()
    rj = RU.JournaledLiveIndex.create(rl, str(tmp_path / "r"))
    tj = U.JournaledLiveIndex.create(tl, str(tmp_path / "t"), metrics=reg)
    _stream(rj)
    _stream(tj)
    assert_same(rj.live, tj.live)
    for op, stages, runs in (
            ("insert", ("search", "select", "reverse_edges", "repair"), 3),
            ("consolidate", ("merge", "select", "compact"), 1)):
        for st in stages:
            h = reg.histogram("live_stage_seconds", {"op": op, "stage": st})
            assert h.count == runs and h.sum >= 0.0, (op, st)


@pytest.mark.faults
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_journal_recovers_in_the_other_package(ref_graph, tmp_path, writer):
    """A journal either package wrote (with an automatic checkpoint in the
    middle) recovers in the other to the writer's arrays."""
    rl, tl = _lives(ref_graph)
    d = str(tmp_path)
    if writer == "reference":
        j = RU.JournaledLiveIndex.create(rl, d, checkpoint_every_bytes=4000)
    else:
        j = U.JournaledLiveIndex.create(tl, d, checkpoint_every_bytes=4000)
    _stream(j)
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    assert set(meta["params"]) == set(dataclasses.asdict(RefBuildParams()))
    if writer == "reference":
        j2, info = U.recover(d, device="cpu")
    else:
        j2, info = RU.recover(d)
    assert info["torn_seq"] is None and 0 < info["checkpoint_step"] < 5
    assert j2.seq == j.seq == 5
    assert j2.checkpoint_every_bytes == 4000
    assert_same(j2.live, j.live)


@pytest.mark.faults
@pytest.mark.parametrize("point,op", [
    (p, op) for op in ("insert", "delete") for p in CRASH_POINTS
    if (op, p) != ("delete", "mid_splice")])
def test_crash_point_sweep(ref_graph, tmp_path, point, op):
    """The reference's sweep in the port: a crash at ``point`` during op 2
    recovers to the state with op 2 iff its record was committed, bit for
    bit, and the recovered journal goes on."""
    _, base = _lives(ref_graph)
    d = str(tmp_path)
    j = U.JournaledLiveIndex.create(base, d)
    j.insert(_batch(1))
    pre = j.live
    payload = _batch(8) if op == "insert" else [3, 5]
    oracle = U.insert(pre, payload) if op == "insert" else U.delete(pre, payload)
    j.fault_hook = crash_at(point)
    with pytest.raises(SimulatedCrash):
        (j.insert if op == "insert" else j.delete)(payload)
    del j
    j2, info = U.recover(d, device="cpu")
    committed = point in ("after_journal", "mid_splice")
    assert info["replayed"] == j2.seq == (2 if committed else 1)
    assert_same(j2.live, oracle if committed else pre)
    if point == "torn_journal":
        assert info["torn_seq"] == 2
        with pytest.raises(U.WalCorruptError):
            U.wal_read(j2.wal_dir, 2)
    assert not [v for v in V.audit_live(j2.live).violations
                if any(k in v for k in STRUCTURAL)]
    j2.insert(_batch(13))
    j3, _ = U.recover(d, device="cpu")
    assert_same(j2.live, j3.live)


@pytest.mark.faults
@pytest.mark.parametrize("mode", ["truncate", "checksum"])
def test_torn_record_stops_replay(ref_graph, tmp_path, mode):
    _, base = _lives(ref_graph)
    d = str(tmp_path)
    j = U.JournaledLiveIndex.create(base, d)
    j.insert(_batch(1))
    after_one = j.live
    j.delete([2, 6])
    torn_wal_record(j.wal_dir, 2, mode=mode)
    j2, info = U.recover(d, device="cpu")
    assert info["replayed"] == 1 and info["torn_seq"] == 2
    assert_same(j2.live, after_one)


@pytest.mark.faults
def test_auto_consolidate_and_walk_back_replay(ref_graph, tmp_path):
    """Deletes past ``consolidate_frac`` journal a consolidate of their own;
    a flipped newest checkpoint walks back and replays to the same state,
    as the reference's recover does on the same directory."""
    _, base = _lives(ref_graph)
    d = str(tmp_path)
    j = U.JournaledLiveIndex.create(base, d, consolidate_frac=0.1)
    j.insert(_batch(1))
    for chunk in np.array_split(np.arange(10, 130, 2), 2):
        j.delete(chunk)
    ops = [U.wal_read(j.wal_dir, s)[0] for s in U.wal_seqs(j.wal_dir)]
    assert "consolidate" in ops and j.live.frac_deleted <= 0.1
    j.checkpoint()
    j.insert(_batch(2))
    newest = max(list_steps(j.ckpt_dir))
    flip_bits(os.path.join(j.ckpt_dir, f"step_{newest:09d}", "arrays.npz"),
              n_bits=16, seed=1)
    j2, info = U.recover(d, device="cpu")
    assert info["checkpoint_step"] < newest
    assert_same(j2.live, j.live)
    j3, _ = RU.recover(d)
    assert_same(j3.live, j.live)


# ---------------------------------------------------------------------------
# The auditor against the reference, on test_verify.py's corruptions.
# ---------------------------------------------------------------------------


def _corrupt(graph, kind):
    """(neighbors, tombstones) of one of test_verify.py's cases."""
    nbr = np.asarray(graph.neighbors).copy()
    n = nbr.shape[0]
    med = int(np.asarray(graph.medoid))
    tomb = None
    if kind == "out_of_range":
        nbr[3, 0] = n + 50
    elif kind == "self_loop_and_duplicate":
        nbr[4, 0] = 4
        nbr[5, 1] = nbr[5, 0]
    elif kind == "unreachable":
        nbr[nbr == (med + 1) % n] = -1
    elif kind == "isolated":
        victim = (med + 1) % n
        nbr[victim, :] = -1
        nbr[nbr == victim] = -1
    elif kind == "tombstoned_medoid":
        tomb = np.zeros(n, bool)
        tomb[med] = True
    elif kind == "bitmap_shape":
        tomb = np.zeros(n - 1, bool)
    elif kind == "bitmap_dtype":
        tomb = np.zeros(n, np.int8)
    elif kind == "broken_routing":
        nbr = np.full_like(nbr, -1)
        hubs = [med, (med + 1) % n]
        for i in range(n):
            nbr[i, 0] = hubs[0] if i != hubs[0] else hubs[1]
            nbr[i, 1] = hubs[1] if i != hubs[1] else (hubs[1] + 1) % n
        nbr[hubs[0], :graph.max_degree] = \
            [i for i in range(n) if i != hubs[0]][:graph.max_degree]
    return nbr, tomb


@pytest.fixture(scope="module")
def verify_graph():
    rng = np.random.default_rng(5)
    return ref_build_approx(rng.standard_normal((200, 10)).astype(np.float32),
                            RefBuildParams(max_degree=10, beam_width=20, t=10,
                                           iters=2, block=128))


def _reports_equal(r, t):
    assert (t.n, t.n_live) == (r.n, r.n_live)
    assert t.violations == r.violations
    assert t.warnings == r.warnings
    assert t.metrics == r.metrics
    assert t.summary() == r.summary()


@pytest.mark.parametrize("kind", [
    "clean", "out_of_range", "self_loop_and_duplicate", "unreachable",
    "isolated", "tombstoned_medoid", "bitmap_shape", "bitmap_dtype",
    "broken_routing"])
def test_audit_equals_reference(verify_graph, kind):
    nbr, tomb = _corrupt(verify_graph, kind)
    r_graph = dataclasses.replace(verify_graph, neighbors=jnp.asarray(nbr))
    t_graph = to_port(r_graph)
    r = RV.audit(r_graph, tombstones=tomb, sample=48)
    t = V.audit(t_graph, tombstones=tomb, sample=48)
    _reports_equal(r, t)
    assert r.ok == (kind == "clean")


def test_audit_live_equals_reference_after_ops(verify_graph):
    bp = dict(max_degree=10, beam_width=20, t=10, iters=2, block=128)
    rl = RU.as_live(verify_graph, RefBuildParams(**bp))
    tl = U.as_live(to_port(verify_graph), BuildParams(**bp))
    new = np.random.default_rng(6).standard_normal((15, 10)).astype(np.float32)
    rl = RU.delete(RU.insert(rl, new), [2, 8, 31])
    tl = U.delete(U.insert(tl, new), [2, 8, 31])
    r, t = RV.audit_live(rl, sample=64), V.audit_live(tl, sample=64)
    _reports_equal(r, t)
    assert t.ok and t.n_live == 212
