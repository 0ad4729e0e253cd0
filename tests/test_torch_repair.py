"""Self-healing shard repair in the port (``repro_torch.core.repair``),
mirroring ``tests/test_repair.py`` case for case on the CPU, plus the
store format across packages.

Pinned here:

* after injected shard deaths with auto-repair, coverage returns to 1.0
  with no operator ``mark_live`` / ``revive_shard`` call;
* a crash mid-install never flips the participation mask;
* the repaired slot is **bit-identical** (``torch.equal``) to a
  from-scratch rebuild and to the slot ``build_sharded`` produced: the
  store snapshots the exact padded rows and ``build_shard`` derives the
  same per-shard seed, RaBitQ rotation included;
* a store either package creates is the other's file for file, and loads
  and rebuilds there.

The controller runs in-process on the CPU (store, registry and
``host_reference_merge`` are host-side).  Fault-injection tests carry
``@pytest.mark.faults`` as their counterparts do.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
from repro.core import SearchParams as RefSearchParams
from repro.core import search as ref_search
from repro.core.build_approx import BuildParams as RefBuildParams
from repro.core.distributed import build_shard as ref_build_shard
from repro.core.repair import ShardVectorStore as RefStore

from repro_torch.core import BuildParams, SearchParams, search
from repro_torch.core.distributed import (
    ShardHealthRegistry,
    build_replicated,
    build_shard,
    build_sharded,
    host_reference_merge,
)
from repro_torch.core.repair import (
    RepairConfig,
    RepairController,
    ShardSourceCorruptError,
    ShardVectorStore,
)
from repro_torch.obs import MetricsRegistry, snapshot
from repro_torch.serve import ResilienceConfig, ShardedResilientAnnServer
from repro_torch.testing import (
    RepairFaultPlan,
    SimulatedCrash,
    corrupt_shard_source,
    indexes_equal,
)

from test_torch_search import to_port

torch.set_num_threads(1)

pytestmark = pytest.mark.faults

# the reference test's parameters: every rebuilt shard passes the audit gate
BP_KW = dict(max_degree=12, beam_width=24, t=10, iters=3, block=128,
             delta=0.5)
BP = BuildParams(**BP_KW)
N, DIM, S, SEED = 509, 12, 4, 3


@pytest.fixture(scope="module")
def corpus():
    return np.random.default_rng(0).standard_normal((N, DIM)).astype(
        np.float32)


@pytest.fixture(scope="module")
def built(corpus):
    return build_sharded(corpus, S, BP, seed=SEED, device="cpu")


@pytest.fixture(scope="module")
def store(corpus, tmp_path_factory):
    d = tmp_path_factory.mktemp("shard_store")
    return ShardVectorStore.create(str(d), corpus, S, params=BP, seed=SEED)


def _controller(store, sidx, registry=None, **kw):
    """(controller, registry, holder, clock) over a mutable index holder;
    ``install_slot`` is functional, so the module's ``built`` is never
    changed."""
    t = {"now": 0.0}
    reg = registry or ShardHealthRegistry(S, clock=lambda: t["now"])
    holder = {"sidx": sidx}
    ctl = RepairController(store, reg,
                           get_sidx=lambda: holder["sidx"],
                           set_sidx=lambda x: holder.__setitem__("sidx", x),
                           clock=lambda: t["now"], **kw)
    return ctl, reg, holder, t


def _assert_sidx_equal(a, b):
    assert (a.offsets, a.sizes, a.n_total) == (b.offsets, b.sizes, b.n_total)
    assert len(a.slots) == len(b.slots)
    for x, y in zip(a.slots, b.slots):
        assert indexes_equal(x, y)


# ---------------------------------------------------------------------------
# Happy path: coverage restored, bit-identical, fully observable
# ---------------------------------------------------------------------------


def test_repair_restores_coverage_bit_identically(store, built):
    m = MetricsRegistry()
    ctl, reg, holder, t = _controller(store, built, metrics=m)
    reg.mark_dead(1)
    reg.mark_dead(3)
    assert reg.coverage() == 0.5

    out1 = ctl.sweep()                      # default budget: one per sweep
    assert [o.status for o in out1] == ["succeeded"]
    assert out1[0].shard == 1 and out1[0].attempt == 1
    assert reg.coverage() == 0.75
    out2 = ctl.sweep()
    assert [(o.shard, o.status) for o in out2] == [(3, "succeeded")]
    assert reg.coverage() == 1.0            # no operator mark_live anywhere

    _assert_sidx_equal(holder["sidx"], built)
    assert indexes_equal(holder["sidx"].slots[3],
                         store.build_shard(3, device="cpu"))
    assert holder["sidx"].slots[0] is built.slots[0]   # untouched slots kept

    assert (ctl.n_repaired, ctl.n_failed, ctl.n_sweeps) == (2, 0, 2)
    snap = snapshot(m)
    assert snap["counters"]["repair_started_total"] == 2
    assert snap["counters"]["repair_succeeded_total"] == 2
    assert "repair_failed_total" not in snap["counters"]
    assert snap["gauges"]['shard_under_repair{shard="1"}'] == 0.0
    assert snap["gauges"]['shard_under_repair{shard="3"}'] == 0.0
    assert snap["histograms"]["repair_duration_seconds"]["count"] == 2
    done = [e for e in snap["events"] if e["name"] == "repair_succeeded"]
    assert sorted(e["shard"] for e in done) == [1, 3]


def test_repair_prioritizes_coverage_holes(store, corpus):
    """A shard with NO live replica is repaired before a dead replica of a
    covered shard — with budget 1 the hole closes in sweep one."""
    t_reg = {"now": 0.0}
    reg = ShardHealthRegistry(S, n_replicas=2, clock=lambda: t_reg["now"])
    rep = build_replicated(corpus, S, n_replicas=2, params=BP, seed=SEED,
                           device="cpu")
    ctl, reg, holder, t = _controller(store, rep, registry=reg)
    reg.mark_dead(0, 0)                     # covered: (0, 1) still lives
    reg.mark_dead(2, 0)                     # hole: both replicas dead
    reg.mark_dead(2, 1)
    assert reg.coverage() == 0.75
    assert ctl.pending() == [(2, 0), (2, 1), (0, 0)]

    out = ctl.sweep()
    assert [(o.shard, o.replica) for o in out] == [(2, 0)]
    assert reg.coverage() == 1.0            # hole closed first
    ctl.sweep()
    ctl.sweep()
    assert ctl.pending() == []
    _assert_sidx_equal(holder["sidx"], rep)


# ---------------------------------------------------------------------------
# Contained failures: retry with exponential backoff, no regression
# ---------------------------------------------------------------------------


def test_rebuild_failures_back_off_and_retry(store, built):
    m = MetricsRegistry()
    hook = RepairFaultPlan(fail_rebuilds=2).hook()
    ctl, reg, holder, t = _controller(store, built, metrics=m,
                                      fault_hook=hook)
    reg.mark_dead(2)

    out = ctl.sweep()                       # attempt 1 fails → backoff 0.5 s
    assert [o.status for o in out] == ["failed"]
    assert "RepairFault" in out[0].error
    assert holder["sidx"] is built          # contained: index untouched
    assert not reg.participation()[2]
    t["now"] = 0.25
    assert ctl.sweep() == []                # still inside the backoff window
    t["now"] = 0.6
    out = ctl.sweep()                       # attempt 2 fails → backoff 1.0 s
    assert [(o.status, o.attempt) for o in out] == [("failed", 2)]
    t["now"] = 1.0
    assert ctl.sweep() == []
    t["now"] = 2.0
    out = ctl.sweep()
    assert [(o.status, o.attempt) for o in out] == [("succeeded", 3)]
    assert reg.coverage() == 1.0
    _assert_sidx_equal(holder["sidx"], built)
    assert hook.visits["rebuild"] == 3
    assert (ctl.n_repaired, ctl.n_failed) == (1, 2)
    snap = snapshot(m)
    assert snap["counters"]["repair_started_total"] == 3
    assert snap["counters"]["repair_failed_total"] == 2
    assert snap["counters"]["repair_succeeded_total"] == 1
    fails = [e for e in snap["events"] if e["name"] == "repair_failed"]
    assert [e["retry_in_s"] for e in fails] == [0.5, 1.0]


def test_corrupted_source_fails_cleanly_then_recovers(tmp_path, corpus,
                                                      built):
    """Both corruption modes are caught by verify-on-read: the repair fails
    (no install, no mask flip); once the source is re-replicated the same
    controller heals on the next eligible sweep."""
    d = str(tmp_path / "store")
    st = ShardVectorStore.create(d, corpus, S, params=BP, seed=SEED)
    corrupt_shard_source(d, 1, mode="truncate")
    corrupt_shard_source(d, 2, mode="checksum")
    for shard in (1, 2):
        with pytest.raises(ShardSourceCorruptError):
            st.load_shard(shard)

    ctl, reg, holder, t = _controller(store=st, sidx=built,
                                      config=RepairConfig(budget_per_sweep=2))
    reg.mark_dead(1)
    reg.mark_dead(2)
    out = ctl.sweep()
    assert [o.status for o in out] == ["failed", "failed"]
    assert all("ShardSourceCorruptError" in o.error for o in out)
    assert holder["sidx"] is built
    assert not reg._live[1, 0] and not reg._live[2, 0]

    ShardVectorStore.create(d, corpus, S, params=BP, seed=SEED)
    t["now"] = 10.0
    out = ctl.sweep()
    assert [o.status for o in out] == ["succeeded", "succeeded"]
    assert reg.coverage() == 1.0
    _assert_sidx_equal(holder["sidx"], built)


# ---------------------------------------------------------------------------
# Install crashes: the atomic-install rule
# ---------------------------------------------------------------------------


def test_crash_before_install_leaves_index_and_mask_untouched(store, built):
    hook = RepairFaultPlan(crash_point="before_install").hook()
    ctl, reg, holder, t = _controller(store, built, fault_hook=hook)
    reg.mark_dead(2)
    with pytest.raises(SimulatedCrash):
        ctl.sweep()
    assert holder["sidx"] is built          # nothing installed
    assert not reg._live[2, 0]              # mask never flipped
    ctl2, _, _, _ = _controller(store, holder["sidx"], registry=reg)
    assert [o.status for o in ctl2.sweep()] == ["succeeded"]
    assert reg.coverage() == 1.0


def test_crash_mid_install_never_flips_participation_mask(store, built):
    """The verified index may land but the mask flips only after it: dying
    between the two leaves a dead slot serving nothing."""
    hook = RepairFaultPlan(crash_point="mid_install").hook()
    ctl, reg, holder, t = _controller(store, built, fault_hook=hook)
    reg.mark_dead(2)
    with pytest.raises(SimulatedCrash):
        ctl.sweep()
    assert not reg._live[2, 0]
    assert reg.coverage() == 0.75
    assert holder["sidx"] is not built
    _assert_sidx_equal(holder["sidx"], built)   # what landed was verified
    ctl2, _, holder2, _ = _controller(store, holder["sidx"], registry=reg)
    assert [o.status for o in ctl2.sweep()] == ["succeeded"]
    assert reg.coverage() == 1.0
    _assert_sidx_equal(holder2["sidx"], built)


def test_crash_after_install_is_fully_recovered(store, built):
    hook = RepairFaultPlan(crash_point="after_install").hook()
    ctl, reg, holder, t = _controller(store, built, fault_hook=hook)
    reg.mark_dead(3)
    with pytest.raises(SimulatedCrash):
        ctl.sweep()
    assert reg.coverage() == 1.0
    _assert_sidx_equal(holder["sidx"], built)
    ctl2, _, _, _ = _controller(store, holder["sidx"], registry=reg)
    assert ctl2.pending() == [] and ctl2.sweep() == []


# ---------------------------------------------------------------------------
# Verification gate and validation
# ---------------------------------------------------------------------------


def test_audit_gate_rejects_defective_rebuild(store, built, monkeypatch):
    """A rebuild with one node orphaned (no in-edges, unreachable from the
    medoid) fails the audit gate: nothing installs, the mask stays down.
    Once rebuilds are healthy again the same controller heals."""
    import repro_torch.core.repair as repair_mod

    def sabotaged_build(rows, shard, params=None, quantized=False, seed=0,
                        device="cuda"):
        g = build_shard(rows, shard, params, quantized, seed, device)
        victim = (g.medoid + 1) % g.n
        nbrs = g.neighbors.clone()
        nbrs[nbrs == victim] = -1
        return dataclasses.replace(g, neighbors=nbrs)

    monkeypatch.setattr(repair_mod, "build_shard", sabotaged_build)
    ctl, reg, holder, t = _controller(store, built)
    reg.mark_dead(2)
    out = ctl.sweep()
    assert [o.status for o in out] == ["failed"]
    assert "RepairError" in out[0].error and "audit" in out[0].error
    assert holder["sidx"] is built and not reg._live[2, 0]

    monkeypatch.undo()
    t["now"] = 10.0
    assert [o.status for o in ctl.sweep()] == ["succeeded"]
    _assert_sidx_equal(holder["sidx"], built)


def test_last_rebuild_keeps_what_the_gate_refused(store, built, monkeypatch):
    """``last_rebuild`` holds the newest rebuild whatever its fate: the
    orphaned graph the audit refused, then the healthy one it installed,
    which is bitwise the build's slot; ``indexes_equal`` tells the two
    apart."""
    import repro_torch.core.repair as repair_mod

    def orphaning_build(rows, shard, *a):
        g = build_shard(rows, shard, *a)
        nbrs = g.neighbors.clone()
        nbrs[nbrs == (g.medoid + 1) % g.n] = -1
        return dataclasses.replace(g, neighbors=nbrs)

    monkeypatch.setattr(repair_mod, "build_shard", orphaning_build)
    ctl, reg, holder, t = _controller(store, built)
    assert ctl.last_rebuild is None
    reg.mark_dead(2)
    assert [o.status for o in ctl.sweep()] == ["failed"]
    shard, replica, refused = ctl.last_rebuild
    assert (shard, replica) == (2, 0)
    assert not indexes_equal(refused, built.slots[2])
    monkeypatch.undo()
    t["now"] = 10.0
    assert [o.status for o in ctl.sweep()] == ["succeeded"]
    assert ctl.last_rebuild[2] is holder["sidx"].slots[2]
    assert indexes_equal(ctl.last_rebuild[2], built.slots[2])


def test_indexes_equal_sees_one_flipped_bit_and_a_dtype(built):
    """One bit of one vector, or the same values in another dtype, makes
    two indexes unequal; a copy that owns its tensors is equal."""
    a = built.slots[1]
    assert indexes_equal(a, dataclasses.replace(a, vectors=a.vectors.clone()))
    flipped = a.vectors.clone()
    flipped.view(torch.int32)[3, 5] ^= 1
    assert not indexes_equal(a, dataclasses.replace(a, vectors=flipped))
    assert not indexes_equal(
        a, dataclasses.replace(a, vectors=a.vectors.double()))
    assert not indexes_equal(a, dataclasses.replace(a, delta=a.delta + 1.0))


def test_spot_check_rejects_a_wrong_slot(store, built, monkeypatch):
    """A rebuild that passes the audit but serves another shard's rows
    (shard 0's graph in slot 2) fails the spot-check's self-probes."""
    import repro_torch.core.repair as repair_mod

    monkeypatch.setattr(repair_mod, "build_shard",
                        lambda rows, shard, *a: built.slots[0])
    ctl, reg, holder, t = _controller(store, built)
    reg.mark_dead(2)
    out = ctl.sweep()
    assert [o.status for o in out] == ["failed"]
    assert "self-probes" in out[0].error
    assert holder["sidx"] is built and not reg._live[2, 0]


def test_repair_plan_and_controller_validation(built, corpus, tmp_path):
    with pytest.raises(ValueError, match="crash_point"):
        RepairFaultPlan(crash_point="rebuild")      # contained phase: no-op
    st2 = ShardVectorStore.create(str(tmp_path / "s2"), corpus, 2,
                                  params=BP, seed=SEED)
    with pytest.raises(ValueError, match="shards"):
        RepairController(st2, ShardHealthRegistry(S),
                         get_sidx=lambda: built, set_sidx=lambda _: None)
    with pytest.raises(ValueError, match="unknown mode"):
        corrupt_shard_source(str(tmp_path / "s2"), 0, mode="flip")


# ---------------------------------------------------------------------------
# The store across packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quantized", [False, True], ids=["graph", "emqg"])
def test_store_files_equal_the_reference_stores(corpus, tmp_path, quantized):
    """The same vectors, shards and parameters: every file of the port's
    store equals the reference's byte for byte (``meta.json`` with the
    reference's ``checkpoint_dir`` field included)."""
    a, b = tmp_path / "port", tmp_path / "ref"
    ShardVectorStore.create(str(a), corpus, S, params=BP, quantized=quantized,
                            seed=SEED)
    RefStore.create(str(b), corpus, S, params=RefBuildParams(**BP_KW),
                    quantized=quantized, seed=SEED)
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and len(names) == 2 * S + 1
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


@pytest.mark.parametrize("quantized", [False, True], ids=["graph", "emqg"])
def test_reference_store_loads_and_rebuilds_in_the_port(corpus, tmp_path,
                                                        quantized):
    """A store the reference created loads in the port (its params'
    ``checkpoint_dir`` ignored) and rebuilds each shard bit for bit as the
    port builds it; the rebuilt graph serves its own rows."""
    d = str(tmp_path / "ref_store")
    RefStore.create(d, corpus, S, params=RefBuildParams(**BP_KW),
                    quantized=quantized, seed=SEED)
    st = ShardVectorStore(d)
    assert st.params == BP and st.quantized == quantized
    assert (st.n_shards, st.n_total, st.seed) == (S, N, SEED)
    rows, n_real = st.load_shard(3)
    assert n_real == N - 3 * 128 and rows.shape == (128, DIM)
    local = st.build_shard(3, device="cpu")
    want = build_sharded(corpus, S, BP, quantized=quantized, seed=SEED,
                         device="cpu")
    assert indexes_equal(local, want.slots[3])
    reg = ShardHealthRegistry(S)
    ids, _ = host_reference_merge(want, reg, corpus[384:388],
                                  SearchParams(k=1, l0=16, l_max=32),
                                  quantized=quantized)
    assert ids[:, 0].tolist() == [384, 385, 386, 387]


def test_port_store_loads_and_rebuilds_in_the_reference(corpus, tmp_path):
    """A store the port created loads in the reference (its
    ``checkpoint_dir`` is ``None``) and the reference rebuilds a shard
    exactly as its own ``build_shard`` does on the same rows; the port
    searches that graph carried across with the reference's ids."""
    d = str(tmp_path / "port_store")
    ShardVectorStore.create(d, corpus, S, params=BP, seed=SEED)
    ref = RefStore(d)
    assert ref.params == RefBuildParams(**BP_KW)
    rows, n_real = ref.load_shard(1)
    np.testing.assert_array_equal(rows, corpus[128:256])
    got = ref.build_shard(1)
    want = ref_build_shard(rows, 1, RefBuildParams(**BP_KW), seed=SEED)
    np.testing.assert_array_equal(np.asarray(got.neighbors),
                                  np.asarray(want.neighbors))
    kw = dict(k=5, l0=16, l_max=32, adaptive=False, max_hops=256)
    want_ids = np.asarray(ref_search(got, rows[:8], RefSearchParams(**kw)).ids)
    port_ids = search(to_port(got), rows[:8], SearchParams(**kw)).ids
    np.testing.assert_array_equal(port_ids.numpy(), want_ids)


# ---------------------------------------------------------------------------
# End to end: kill shards under load, auto-repair heals the server
# ---------------------------------------------------------------------------


def test_chaos_shard_deaths_self_heal_under_load(fault_seed, tmp_path):
    """Heartbeat silence kills two shards mid-stream; the server's repair
    sweep (after the health check, before dispatch) restores coverage to
    1.0 with no operator call.  Post-repair responses equal the healthy
    baseline and the host oracle, the healed index equals a from-scratch
    build, and no dead row is served while degraded."""
    rng = np.random.default_rng(fault_seed)
    X = rng.standard_normal(size=(512, 8)).astype(np.float32)
    Q = rng.standard_normal(size=(12, 8)).astype(np.float32)
    bp = BuildParams(max_degree=12, beam_width=24, t=10, iters=3, block=128,
                     delta=0.5)
    sidx = build_sharded(X, 4, bp, seed=7, device="cpu")
    store = ShardVectorStore.create(str(tmp_path / "store"), X, 4, params=bp,
                                    seed=7)
    params = SearchParams(k=5, l0=16, l_max=32, adaptive=False, max_hops=256,
                          beam_width=1)
    t = {"now": 0.0}
    m = MetricsRegistry()
    srv = ShardedResilientAnnServer(
        sidx, params, config=ResilienceConfig(backoff_s=0.0),
        clock=lambda: t["now"], health_deadline_s=5.0, metrics=m,
        auto_repair=RepairConfig(budget_per_sweep=1), vector_store=store,
        device="cpu")

    def ids_dists(rs):
        return np.stack([r.ids for r in rs]), np.stack([r.dists for r in rs])

    srv.submit_many(Q)
    rs0 = srv.drain()
    assert all(r.ok and r.coverage == 1.0 for r in rs0)
    base_ids, base_d = ids_dists(rs0)

    t["now"] = 4.0                          # shards 1, 2 go silent …
    for s in (0, 3):
        srv.heartbeat(s)
    t["now"] = 7.0                          # … and age past the deadline
    srv.submit_many(Q)
    rs1 = srv.drain()                       # checker kills both, a budget-1
    assert srv.health_checker.n_killed == 2  # sweep repairs one (shard 1)
    assert all(r.ok and abs(r.coverage - 3 / 4) < 1e-9 for r in rs1)
    ids1, _ = ids_dists(rs1)
    assert not ((ids1 >= 256) & (ids1 < 384)).any()

    srv.submit_many(Q)
    rs2 = srv.drain()
    assert all(r.ok and r.coverage == 1.0 for r in rs2)
    assert srv.repair.n_repaired == 2
    snap = snapshot(m)
    assert snap["counters"]["repair_succeeded_total"] == 2
    assert snap["counters"]["shard_marked_dead_total"] == 2

    ids2, d2 = ids_dists(rs2)
    assert np.array_equal(ids2, base_ids) and np.array_equal(d2, base_d)
    hr_ids, _ = host_reference_merge(srv.index, srv.registry, Q, params)
    assert np.array_equal(ids2, hr_ids)
    _assert_sidx_equal(srv.index, build_sharded(X, 4, bp, seed=7,
                                                device="cpu"))


def test_repair_gate_rejects_what_the_build_leaves_defective(tmp_path):
    """A reference fault the port keeps: the gate audits a rebuild as
    strictly as a fresh build, and a δ-EMQG build at these parameters
    fails the audit (monotone descent here; nodes cut off from the medoid
    at scale, ROADMAP C.5), so the bit-identical rebuild of every shard is
    rejected in both packages and self-repair never heals them."""
    from repro.core.distributed import ShardHealthRegistry as RefRegistry
    from repro.core.distributed import build_sharded as ref_build_sharded
    from repro.core.repair import RepairConfig as RefConfig
    from repro.core.repair import RepairController as RefController

    from repro_torch.data import clustered_vectors

    kw = dict(max_degree=8, beam_width=16, t=8, iters=2, block=512,
              align_degree=True)
    X = clustered_vectors(1024, 16, 16, seed=0)
    outcomes = []
    for pkg, build, store_cls, reg_cls, ctl_cls, cfg_cls, bp in (
            ("port", lambda: build_sharded(X, 4, BuildParams(**kw),
                                           quantized=True, device="cpu"),
             ShardVectorStore, ShardHealthRegistry, RepairController,
             RepairConfig, BuildParams(**kw)),
            ("ref", lambda: ref_build_sharded(X, 4, RefBuildParams(**kw),
                                              quantized=True),
             RefStore, RefRegistry, RefController, RefConfig,
             RefBuildParams(**kw))):
        store = store_cls.create(str(tmp_path / pkg), X, 4, bp,
                                 quantized=True)
        holder = {"sidx": build()}
        reg = reg_cls(4)
        ctl = ctl_cls(store, reg, get_sidx=lambda h=holder: h["sidx"],
                      set_sidx=lambda x, h=holder: h.__setitem__("sidx", x),
                      config=cfg_cls(budget_per_sweep=4))
        for s in range(4):
            reg.mark_dead(s)
        outcomes.append([(o.shard, o.status, o.error.split("[")[0])
                         for o in ctl.sweep()])
        assert reg.coverage() == 0.0
    assert outcomes[0] == outcomes[1] == [
        (s, "failed", f"RepairError: shard {s}: rebuilt graph failed audit: ")
        for s in range(4)]
