"""The port's sharded index (``repro_torch.core.distributed``) against the
JAX package's ``repro.core.distributed``.

On reference-built shards carried across (``interop.sharded_from_numpy``),
both merges and both index kinds at W = 1 give the reference's
``host_reference_merge``: ids identical, distances to 1e-4.  The ring's
order on exact ties is pinned against the reference's ``shard_map`` ring
on a forced four-device mesh (a subprocess, as ``tests/test_distributed.py``
runs it).  The SPMD transport (one gloo process a shard on the CPU) equals
the single-controller search.  The host logic (health registry, deadline
checker) follows the reference's schedules on the same injected clock, and
the sharded resilient server and the serve CLI's sharded mode run end to
end.  Corpora are the reference tests' sizes (n ≈ 512, d ≤ 24).

Fault-injection tests carry ``@pytest.mark.faults`` as their counterparts
in ``tests/test_distributed.py`` do.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from repro.core import BuildParams as RefBuildParams
from repro.core import SearchParams as RefSearchParams
from repro.core.distributed import DeadlineHealthChecker as RefChecker
from repro.core.distributed import ShardHealthRegistry as RefRegistry
from repro.core.distributed import build_replicated as ref_build_replicated
from repro.core.distributed import build_sharded as ref_build_sharded
from repro.core.distributed import host_reference_merge as ref_host_merge
from repro.obs import MetricsRegistry as RefMetrics
from repro.obs import snapshot as ref_snapshot

from repro_torch.core import BuildParams, SearchParams
from repro_torch.core.distributed import (
    DeadlineHealthChecker,
    FaultTolerantShardedSearch,
    ShardHealthRegistry,
    build_replicated,
    build_sharded,
    host_reference_merge,
    make_sharded_search,
    spmd_search,
)
from repro_torch.interop import sharded_from_numpy
from repro_torch.launch import serve as port_serve
from repro_torch.obs import MetricsRegistry, Tracer, snapshot
from repro_torch.serve import ResilienceConfig, ShardedResilientAnnServer
from repro_torch.testing import (
    FaultPlan,
    ShardDeathPlan,
    inject_search_faults,
    inject_shard_deaths,
)

from test_torch_search import to_port

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
BP = dict(max_degree=12, beam_width=24, t=8, iters=1, block=512)
KW = dict(k=5, l0=8, l_max=32, adaptive=False, max_hops=256, beam_width=1)
MERGES = ("all_gather", "ring")


def carry(ref_sidx, device="cpu"):
    """The port's copy of a reference ``ShardedIndex`` (stacked leaves)."""
    idx = ref_sidx.index
    g = getattr(idx, "graph", idx)
    kw = dict(vectors=np.asarray(g.vectors), neighbors=np.asarray(g.neighbors),
              medoid=np.asarray(g.medoid), kind=g.kind, delta=g.delta)
    if hasattr(idx, "codes"):
        c = idx.codes
        kw.update(codes=np.asarray(c.codes), norms=np.asarray(c.norms),
                  ip_xo=np.asarray(c.ip_xo), rotation=np.asarray(c.rotation),
                  center=np.asarray(c.center), dim=c.dim)
    return sharded_from_numpy(
        np.asarray(ref_sidx.offsets), ref_sidx.n_total,
        None if ref_sidx.sizes is None else np.asarray(ref_sidx.sizes),
        **kw, device=device)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(1)
    X = rng.normal(size=(509, 16)).astype(np.float32)   # 4 × 128: 3 pads
    Q = rng.normal(size=(12, 16)).astype(np.float32)
    return X, Q


@pytest.fixture(scope="module")
def ref_built(data):
    """Reference-built shards: (layout, quantized) → (ref sidx, port copy,
    replicas)."""
    X, _ = data
    out = {}
    for quantized in (False, True):
        bp = RefBuildParams(**BP, align_degree=quantized)
        s = ref_build_sharded(X, 4, bp, quantized=quantized)
        out[("sharded", quantized)] = (s, carry(s), 1)
        r = ref_build_replicated(X, 4, 2, bp, quantized=quantized)
        out[("replicated", quantized)] = (r, carry(r), 2)
    return out


def _ref_registry(n_shards, n_replicas, dead=()):
    reg = RefRegistry(n_shards, n_replicas)
    for s, r in dead:
        reg.mark_dead(s, r)
    return reg


@pytest.mark.parametrize("merge", MERGES)
@pytest.mark.parametrize("quantized", [False, True], ids=["graph", "emqg"])
@pytest.mark.parametrize("layout", ["sharded", "replicated"])
def test_sharded_search_matches_reference(ref_built, data, layout, quantized,
                                          merge):
    """Both merges on reference-built shards equal the reference's host
    merge over the participating slots: ids identical, dists to 1e-4 (with
    replicas, one replica a shard participates; a dead primary and a dead
    shard included)."""
    ref, port, R = ref_built[(layout, quantized)]
    _, Q = data
    deads = [()] + ([((1, 0),), ((1, 0), (1, 1))] if R == 2 else [((2, 0),)])
    for dead in deads:
        fts = FaultTolerantShardedSearch(port, merge=merge, quantized=quantized,
                                         n_replicas=R)
        for s, r in dead:
            fts.registry.mark_dead(s, r)
        got = fts(Q, SearchParams(**KW))
        want_i, want_d = ref_host_merge(ref, _ref_registry(4, R, dead), Q,
                                        RefSearchParams(**KW),
                                        quantized=quantized)
        np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want_i))
        np.testing.assert_allclose(got.dists.numpy(), np.asarray(want_d),
                                   rtol=1e-4, atol=1e-4)
        mine_i, mine_d = host_reference_merge(port, fts.registry, Q,
                                              SearchParams(**KW), quantized)
        np.testing.assert_array_equal(mine_i, np.asarray(want_i))


@pytest.mark.parametrize("backend", ["auto", "jnp"])
@pytest.mark.parametrize("quantized", [False, True], ids=["graph", "emqg"])
def test_lockstep_slots_equal_one_at_a_time(ref_built, data, quantized,
                                            backend):
    """The single controller's lock-step search over every participating
    slot's rows at once gives, bit for bit, each slot's list from its own
    search (``_local_search``), with slots left out and with adaptive
    widths, W = 2 and uneven hop counts across slots; the stack is made
    once an index, and ``around`` is entered for each live slot in
    order."""
    import contextlib

    from repro_torch.core.distributed import _local_search, _lockstep_search

    _, port, R = ref_built[("replicated", quantized)]
    _, Q = data
    q = torch.as_tensor(Q)
    for kw in (KW, dict(KW, adaptive=True, alpha=1.2, l_max=48,
                        beam_width=2)):
        params = SearchParams(**kw)
        for live in (list(range(8)), [0, 2, 3, 5, 6, 7], [6]):
            got = _lockstep_search(port, live, q, params, quantized, backend)
            for slot, (ids, dists) in zip(live, got):
                want = _local_search(port.slots[slot], q, params, quantized,
                                     backend)
                assert torch.equal(ids, want.ids)
                assert torch.equal(dists.view(torch.int32),
                                   want.dists.view(torch.int32))
    stack = port.__dict__["_stack"]
    make_sharded_search("all_gather", quantized, backend)(port, Q, params)
    assert port.__dict__["_stack"] is stack
    seen = []

    def around(slot):
        seen.append(slot)
        return contextlib.nullcontext()

    valid = [True, False, True, True, False, True, True, True]
    make_sharded_search("ring", quantized, backend)(port, Q, params,
                                                   valid=valid, around=around)
    assert seen == [i for i in range(8) if valid[i]]


@pytest.mark.parametrize("quantized", [False, True], ids=["graph", "emqg"])
def test_lockstep_bitsets_are_a_slot_wide(ref_built, data, quantized,
                                          monkeypatch):
    """The lock-step search's visited bitsets cover one slot's rows a
    query row, S·B rows of ⌈N_slot/32⌉ words, not the stack's S·N_slot:
    their memory grows with S, not S²."""
    import importlib

    from repro_torch.core.distributed import _graph, _lockstep_search

    port_search = importlib.import_module("repro_torch.core.search")
    port_probing = importlib.import_module("repro_torch.core.probing")

    _, port, _ = ref_built[("replicated", quantized)]
    _, Q = data
    made, real = [], port_search.bitset_make

    def spy(batch, n, device=None):
        made.append((batch, n))
        return real(batch, n, device)

    monkeypatch.setattr(port_search, "bitset_make", spy)
    monkeypatch.setattr(port_probing, "bitset_make", spy)
    live = [0, 2, 3, 7]
    _lockstep_search(port, live, torch.as_tensor(Q), SearchParams(**KW),
                     quantized)
    assert made == [(len(live) * len(Q), _graph(port.slots[0]).n)]


def test_carried_slots_equal_per_slot_copies(ref_built):
    """``sharded_from_numpy`` gives slot s the arrays of the reference's
    slot s, bit for bit, and the reference's offsets, sizes and n_total."""
    import jax

    ref, port, _ = ref_built[("replicated", True)]
    assert port.n_shards == 8 and port.n_total == ref.n_total == 509
    assert port.offsets == tuple(np.asarray(ref.offsets).tolist())
    assert port.sizes == (128,) * 6 + (125, 125)
    assert port.dim == ref.dim == 16 and port.delta == ref.delta
    for s in (0, 7):
        one = to_port(jax.tree.map(lambda x, s=s: x[s], ref.index))
        for a, b in ((port.slots[s].graph.vectors, one.graph.vectors),
                     (port.slots[s].graph.neighbors, one.graph.neighbors),
                     (port.slots[s].codes.codes, one.codes.codes)):
            assert torch.equal(a, b)
        assert port.slots[s].graph.medoid == one.graph.medoid


def test_pad_rows_never_leak_global_ids(data):
    """The last shard's pad rows (wrapped copies of its first row) tie the
    pad-source row at distance 0 for a query ON it; both merges and the host
    reference mask them: every id in [0, n_total), unique per row, and the
    source row itself returned."""
    X, _ = data
    rng = np.random.default_rng(5)
    sidx = build_sharded(X, 4, BuildParams(**BP), device="cpu")
    assert sidx.sizes == (128, 128, 128, 125)
    params = SearchParams(k=8, l0=16, l_max=32, adaptive=False, max_hops=256)
    Q = np.concatenate([X[384:385], X[384:385] + 0.01 * rng.normal(
        size=(3, 16)).astype(np.float32)])

    def check(ids):
        ids = np.asarray(ids)
        assert ids.max() < sidx.n_total, ids.max()
        for row in ids:
            valid = row[row >= 0]
            assert len(set(valid.tolist())) == len(valid), row
        assert (ids[0] == 384).any()

    for merge in MERGES:
        check(make_sharded_search(merge)(sidx, Q, params)[0])
    check(host_reference_merge(sidx, ShardHealthRegistry(4), Q, params)[0])


@pytest.mark.faults
@pytest.mark.parametrize("merge", MERGES)
def test_dead_shard_masked_merge_matches_survivor_reference(data, merge,
                                                            fault_seed):
    """One of S shards killed: coverage (S-1)/S, max_missed = min(k, its
    size), no id of its range, ids equal to the host merge over the
    survivors."""
    X, Q = data
    rng = np.random.default_rng(fault_seed)
    sidx = build_sharded(X[:512], 4, BuildParams(**BP), device="cpu")
    params = SearchParams(**KW)
    dead = int(rng.integers(0, 4))
    offs = np.append(np.asarray(sidx.offsets), sidx.n_total)
    fts = FaultTolerantShardedSearch(sidx, merge=merge)
    fts.registry.mark_dead(dead)
    r = fts(Q, params)
    assert abs(r.coverage - 3 / 4) < 1e-9
    assert r.live_shards == 3 and r.n_shards == 4
    assert r.max_missed == min(params.k, int(offs[dead + 1] - offs[dead]))
    ids = r.ids.numpy()
    assert not ((ids >= offs[dead]) & (ids < offs[dead + 1])).any()
    ref_i, ref_d = host_reference_merge(sidx, fts.registry, Q, params)
    np.testing.assert_array_equal(ids, ref_i)
    np.testing.assert_allclose(r.dists.numpy(), ref_d, rtol=1e-6)


@pytest.mark.faults
def test_replica_failover_restores_full_coverage(data):
    """A lost primary with a live replica fails over (coverage 1.0, the same
    ids); losing both degrades coverage; reviving restores it.  Each
    replica owns a copy of its shard's tensors."""
    X, Q = data
    sidx = build_replicated(X[:512], 4, 2, BuildParams(**BP), device="cpu")
    assert sidx.n_shards == 8 and sidx.offsets[2:4] == (128, 128)
    a, b = sidx.slots[2].vectors, sidx.slots[3].vectors
    assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    params = SearchParams(**KW)
    fts = FaultTolerantShardedSearch(sidx, n_replicas=2)
    r0 = fts(Q, params)
    assert r0.coverage == 1.0 and r0.failover == 0
    fts.registry.mark_dead(1, replica=0)
    r1 = fts(Q, params)
    assert r1.coverage == 1.0 and r1.failover == 1 and r1.max_missed == 0
    assert torch.equal(r0.ids, r1.ids)
    fts.registry.mark_dead(1, replica=1)
    r2 = fts(Q, params)
    assert abs(r2.coverage - 3 / 4) < 1e-9 and r2.max_missed == 5
    fts.registry.mark_live(1, replica=0)
    r3 = fts(Q, params)
    assert r3.coverage == 1.0 and r3.failover == 0
    assert torch.equal(r3.ids, r0.ids)
    fts.registry.mark_dead(0, 0)
    fts.registry.mark_dead(0, 1)
    for s in (1, 2, 3):
        fts.registry.mark_dead(s, 0)
        fts.registry.mark_dead(s, 1)
    with pytest.raises(RuntimeError, match="no live shard"):
        fts(Q, params)


def _schedule(registry_cls, checker_cls, metrics_cls, snap):
    """The reference test's deadline schedule; every observable step."""
    t = {"now": 0.0}
    reg = registry_cls(4, n_replicas=2, clock=lambda: t["now"])
    m = metrics_cls()
    hc = checker_cls(reg, deadline_s=5.0, metrics=m)
    out = [hc.check()]
    t["now"] = 3.0
    for s in range(4):
        for r in range(2):
            if (s, r) != (1, 1):
                reg.heartbeat(s, r)
    t["now"] = 7.0
    out += [hc.check(), reg.coverage(), hc.n_killed, reg.participation()]
    t["now"] = 10.0
    out += [hc.check(), reg.coverage(), reg.dead_shards()]
    z = registry_cls(2, clock=lambda: t["now"])
    zc = checker_cls(z, deadline_s=1.0)
    t["now"] = 12.0
    out.append(zc.check())
    z.heartbeat(0)                            # a zombie's beat: no revival
    out += [z.dead_shards(), zc.check()]
    z.mark_live(0)                            # explicit revival refreshes
    out += [z.live_shards(), zc.check(), z.n_failover]
    s = snap(m)
    for e in s["events"]:
        e.pop("t_mono")
    return out, s


@pytest.mark.faults
def test_registry_and_checker_follow_reference_schedule():
    """Registry and deadline checker on the same injected clock: the same
    kills, coverage, participation masks, counters, gauges and events."""
    got, gs = _schedule(ShardHealthRegistry, DeadlineHealthChecker,
                        MetricsRegistry, snapshot)
    want, ws = _schedule(RefRegistry, RefChecker, RefMetrics, ref_snapshot)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert got[1] == [(1, 1)] and len(got[5]) == 7
    assert gs == ws
    with pytest.raises(ValueError):
        DeadlineHealthChecker(ShardHealthRegistry(2), deadline_s=0.0)


_RING_TIES = """
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, "src")
import numpy as np, jax, jax.numpy as jnp
from repro.core import BuildParams, SearchParams
from repro.core.distributed import build_sharded, make_sharded_search
rng = np.random.default_rng(0)
B = rng.normal(size=(128, 16)).astype(np.float32)
X = np.concatenate([B, B, B, B])          # every row in every shard: ties
Q = rng.normal(size=(8, 16)).astype(np.float32)
sidx = build_sharded(X, 4, BuildParams(max_degree=12, beam_width=24, t=8,
                                       iters=1, block=512))
mesh = jax.make_mesh((4,), ("data",))
p = SearchParams(k=8, l0=16, l_max=32, adaptive=False, max_hops=256)
out = {}
for m in ("all_gather", "ring"):
    ids, d = make_sharded_search(mesh, merge=m)(sidx, jnp.asarray(Q), p)
    out[m] = np.asarray(ids).tolist()
g = sidx.index
np.savez(sys.argv[1], Q=Q, offsets=np.asarray(sidx.offsets),
         sizes=np.asarray(sidx.sizes), vectors=np.asarray(g.vectors),
         neighbors=np.asarray(g.neighbors), medoid=np.asarray(g.medoid),
         delta=g.delta)
print(json.dumps(out))
"""


def test_ring_tie_order_matches_reference_mesh(tmp_path):
    """Four identical shards tie every distance four ways.  The reference's
    ``shard_map`` merges on a forced four-device mesh; its all_gather keeps
    slot order on ties and its ring gives rank 0's order (0, 3, 2, 1).  The
    port, on the same shards, gives both exactly."""
    npz = tmp_path / "shards.npz"
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", _RING_TIES, str(npz)],
                          capture_output=True, text=True, timeout=300,
                          cwd=ROOT, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    z = np.load(npz)
    port = sharded_from_numpy(z["offsets"], 512, z["sizes"], z["vectors"],
                              z["neighbors"], z["medoid"],
                              kind="delta_emg_approx", delta=float(z["delta"]),
                              device="cpu")
    p = SearchParams(k=8, l0=16, l_max=32, adaptive=False, max_hops=256)
    got = {m: make_sharded_search(m)(port, z["Q"], p)[0].tolist()
           for m in MERGES}
    assert got == want
    assert got["ring"] != got["all_gather"]     # the tie order is pinned
    row = got["ring"][0]
    assert [i // 128 for i in row[:4]] == [0, 3, 2, 1]


@pytest.mark.parametrize("valid", [None, [True, False, True, True]],
                         ids=["all-live", "slot-1-dead"])
def test_spmd_transport_equals_single_controller(data, valid):
    """One gloo process a shard on the CPU (4 ranks; a dead slot in one
    case), both merges: every rank's merged ids and dists equal the
    single-controller search's (no exact ties here, so every rank
    agrees)."""
    X, Q = data
    sidx = build_sharded(X, 4, BuildParams(**BP), quantized=True,
                         device="cpu")
    params = SearchParams(**KW)
    outs = spmd_search(sidx, Q, params, quantized=True, valid=valid,
                       timeout_s=120)
    assert len(outs) == 4
    for merge in MERGES:
        ids, d = make_sharded_search(merge, quantized=True)(sidx, Q, params,
                                                            valid=valid)
        for rank in outs:
            np.testing.assert_array_equal(rank[merge][0], ids.numpy())
            np.testing.assert_array_equal(rank[merge][1], d.numpy())


def _server(sidx, **kw):
    return ShardedResilientAnnServer(
        sidx, SearchParams(**KW), config=ResilienceConfig(backoff_s=0.0),
        device="cpu", **kw)


@pytest.mark.faults
def test_sharded_resilient_server_degrades_explicitly(data):
    """Shard death degrades coverage per response (never a breaker move), a
    merge-tier fault falls back to the other exact merge (counted once),
    revival restores coverage; the breaker holds only the two merges."""
    X, Q = data
    sidx = build_sharded(X[:512], 4, BuildParams(**BP), device="cpu")
    srv = _server(sidx)
    assert [t.name for t in srv.breaker.tiers] == \
        ["sharded/all_gather", "sharded/ring"]
    srv.submit_many(Q)
    rs = srv.drain()
    assert all(r.ok and r.coverage == 1.0 and r.max_missed == 0
               and r.tier == "sharded/all_gather" for r in rs)
    want_i, _ = host_reference_merge(sidx, srv.registry, Q, SearchParams(**KW))
    np.testing.assert_array_equal(np.stack([r.ids for r in rs]), want_i)

    srv.kill_shard(2)
    srv.submit_many(Q)
    rs = srv.drain()
    assert all(r.ok and abs(r.coverage - 3 / 4) < 1e-9 and r.max_missed == 5
               and r.tier == "sharded/all_gather" for r in rs)
    assert not any(((r.ids >= 256) & (r.ids < 384)).any() for r in rs)
    assert srv.stats.n_fallback == 0

    srv.revive_shard(2)
    with inject_search_faults(srv, FaultPlan(
            fail_first=10**6, match_backend="all_gather")) as inj:
        srv.submit_many(Q)
        rs = srv.drain()
    assert inj.n_failed == 3
    assert all(r.ok and r.tier == "sharded/ring" and r.coverage == 1.0
               for r in rs)
    assert srv.stats.n_fallback == 1
    np.testing.assert_array_equal(np.stack([r.ids for r in rs]), want_i)


@pytest.mark.faults
def test_shard_death_plan_and_health_deadline(data):
    """A ``ShardDeathPlan`` kills and revives slots between batches; the
    deadline checker auto-kills a silent shard before the next dispatch."""
    X, Q = data
    sidx = build_replicated(X[:512], 4, 2, BuildParams(**BP), device="cpu")
    srv = _server(sidx, n_replicas=2)
    plan = ShardDeathPlan(kill={(3, 0): 1, (3, 1): 1}, revive={(3, 1): 2})
    cov = []
    with inject_shard_deaths(srv, plan) as inj:
        for _ in range(3):
            srv.submit_many(Q[:4])
            cov.append([r.coverage for r in srv.drain()])
    assert inj.n_calls == 3
    assert cov == [[1.0] * 4, [0.75] * 4, [1.0] * 4]
    assert srv.registry.n_failover == 1

    t = {"now": 0.0}
    m = MetricsRegistry()
    srv = _server(build_sharded(X[:512], 4, BuildParams(**BP), device="cpu"),
                  clock=lambda: t["now"], health_deadline_s=5.0, metrics=m)
    t["now"] = 4.0
    for s in (0, 1, 3):
        srv.heartbeat(s)
    t["now"] = 7.0
    srv.submit_many(Q)
    rs = srv.drain()
    assert srv.health_checker.n_killed == 1
    assert all(r.ok and abs(r.coverage - 3 / 4) < 1e-9 for r in rs)
    snap = snapshot(m)
    assert snap["counters"]["shard_marked_dead_total"] == 1
    assert snap["gauges"]['shard_live{shard="2"}'] == 0.0
    srv.revive_shard(2)
    srv.submit_many(Q)
    assert all(r.ok and r.coverage == 1.0 for r in srv.drain())


@pytest.mark.faults
def test_shard_spans_time_each_slot_search(data):
    """The fanout span holds one ``shard`` child per logical shard: a live
    shard's child spans the search its slot took part in (the single
    controller searches every live slot in one lock-step loop, so the
    live children are opened in slot order, all cover that one search and
    close in reverse order, inside the fanout), a dead shard's child is
    empty and says so."""
    X, Q = data
    sidx = build_replicated(X[:512], 4, 2, BuildParams(**BP), device="cpu")
    tr = Tracer()
    srv = _server(sidx, n_replicas=2, tracer=tr)
    srv.kill_shard(1, 0)
    srv.kill_shard(2, 0)
    srv.kill_shard(2, 1)
    srv.submit_many(Q[:8])
    assert all(r.ok for r in srv.drain())
    (fanout,) = tr.by_name("serve.shard_fanout")
    kids = tr.children_of(fanout)
    assert sorted(c.attrs["shard"] for c in kids) == [0, 1, 2, 3]
    (dead,) = [c for c in kids if not c.attrs["live"]]
    assert dead.attrs["shard"] == 2 and dead.duration_s < 1e-3
    live = sorted((c for c in kids if c.attrs["live"]),
                  key=lambda c: c.start)
    assert [(c.attrs["shard"], c.attrs["replica"]) for c in live] == \
        [(0, 0), (1, 1), (3, 0)]
    assert all(c.duration_s > 0 for c in live)
    assert all(a.start <= b.start and b.end <= a.end
               for a, b in zip(live, live[1:]))
    assert fanout.start <= live[0].start and live[0].end <= fanout.end
    assert fanout.attrs["coverage"] == 0.75


def test_launch_serve_sharded_runs_on_cpu(capsys, tmp_path):
    """The serve CLI's sharded mode end to end on the CPU: four shards,
    shard 1 killed after the first stage and rebuilt from the vector
    store before the next batch."""
    assert port_serve.main([
        "--n", "600", "--dim", "16", "--queries", "48", "--beam", "24",
        "--max-degree", "12", "--device", "cpu", "--shards", "4",
        "--kill-shards", "1", "--auto-repair",
        "--store-dir", str(tmp_path / "store")]) == 0
    out = capsys.readouterr().out
    assert "killed shards [1] (coverage now 0.75)" in out
    assert "coverage trajectory [1.0, 1.0, 1.0]" in out
    assert "repair: 1 repaired, 0 failed attempts, 3 sweeps; final " \
           "coverage 1.00" in out
    assert (tmp_path / "store" / "shard_0003.npz").exists()
