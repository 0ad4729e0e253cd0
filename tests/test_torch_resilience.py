"""The port's resilience layer against the JAX package's: the same request
stream through both ``ResilientAnnServer``s, on the same graph, with the
same injectable breaker clock and the same fault plans, gives the same
per-request outcomes — statuses, rungs, δ bounds, tiers, errors — the same
``ServeStats`` counters and metric counters, and at W = 1 the same ids
(distances to 1e-4).  Plus the building blocks: ``validate_query``, the
degradation ladder, the circuit breaker and the default tier chain.

Fault-injection tests carry ``@pytest.mark.faults`` as their counterparts
in ``tests/test_resilience.py`` do.
"""

import dataclasses
import math
import time

import numpy as np
import pytest
import torch
from repro.core import SearchParams as RefSearchParams
from repro.core import build_exact as ref_build_exact
from repro.obs import MetricsRegistry as RefRegistry
from repro.obs import snapshot as ref_snapshot
from repro.serve import CircuitBreaker as RefBreaker
from repro.serve import DegradationLadder as RefLadder
from repro.serve import ResilienceConfig as RefConfig
from repro.serve import ResilientAnnServer as RefServer
from repro.serve import validate_query as ref_validate
from repro.serve.resilience import default_tiers as ref_default_tiers
from repro.testing import FaultPlan as RefPlan
from repro.testing import inject_search_faults as ref_inject

from repro_torch.core import SearchParams
from repro_torch.obs import MetricsRegistry, snapshot
from repro_torch.serve import (
    CircuitBreaker,
    DegradationLadder,
    ResilienceConfig,
    ResilientAnnServer,
    default_tiers,
    validate_query,
)
from repro_torch.testing import FaultPlan, inject_search_faults

from test_torch_search import to_port

torch.set_num_threads(1)

KW = dict(k=5, l0=8, l_max=64, alpha=1.4, adaptive=True, max_hops=512,
          beam_width=1)
STATS = ("n_requests", "n_batches", "n_rejected", "n_shed", "n_degraded",
         "n_retried", "n_fallback", "n_deadline_missed", "n_failed")


@pytest.fixture(scope="module")
def tiny():
    rng = np.random.default_rng(7)
    base = rng.normal(size=(300, 16)).astype(np.float32)
    with pytest.warns(UserWarning):          # degree cap on a dense corpus
        ref = ref_build_exact(base, delta=0.15, max_degree=12)
    queries = rng.normal(size=(64, 16)).astype(np.float32)
    return {"ref": ref, "port": to_port(ref), "queries": queries}


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _servers(tiny, cfg: dict, clock=None, **kw):
    clock = clock or FakeClock()
    r_reg, t_reg = RefRegistry(), MetricsRegistry()
    r = RefServer(tiny["ref"], RefSearchParams(**KW),
                  config=RefConfig(backoff_s=0.0, **cfg), clock=clock,
                  metrics=r_reg, **kw)
    t = ResilientAnnServer(tiny["port"], SearchParams(**KW),
                           config=ResilienceConfig(backoff_s=0.0, **cfg),
                           clock=clock, metrics=t_reg, device="cpu", **kw)
    return r, t, r_reg, t_reg, clock


def assert_same_outcomes(r_srv, t_srv, r_rs, t_rs, r_reg, t_reg):
    assert len(t_rs) == len(r_rs)
    for a, b in zip(r_rs, t_rs):
        assert (b.seq, b.status, b.rung, b.tier, b.error) == \
            (a.seq, a.status, a.rung, a.tier, a.error)
        assert b.delta_bound == a.delta_bound
        assert (b.saturated, b.deadline_missed) == (a.saturated,
                                                    a.deadline_missed)
        if a.ok:
            np.testing.assert_array_equal(b.ids, np.asarray(a.ids))
            np.testing.assert_allclose(b.dists, np.asarray(a.dists),
                                       rtol=1e-4, atol=1e-4)
    for name in STATS:
        assert getattr(t_srv.stats, name) == getattr(r_srv.stats, name), name
    assert t_srv.rung == r_srv.rung
    assert snapshot(t_reg)["counters"] == ref_snapshot(r_reg)["counters"]


def _drain(srv, queries):
    srv.submit_many(queries)
    return srv.drain()


# ---------------------------------------------------------------------------
# Building blocks.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("query", [
    np.zeros(16, np.float32), np.zeros(16, np.int32), np.zeros(7, np.float32),
    np.zeros((2, 16), np.float32), np.array([np.nan] * 16, np.float32),
    np.array([np.inf] + [0.0] * 15, np.float32), ["a"] * 16,
    np.array([1 + 2j] * 16)], ids=range(8))
def test_validate_query_reasons_equal_reference(query):
    assert validate_query(query, 16) == ref_validate(query, 16)


@pytest.mark.parametrize("adaptive,delta", [(True, 0.2), (False, 0.2),
                                            (True, 0.0)])
def test_ladder_equals_reference(adaptive, delta):
    kw = dict(KW, adaptive=adaptive, beam_width=8, l_max=200)
    r = RefLadder(RefSearchParams(**kw), delta=delta, n_rungs=5)
    t = DegradationLadder(SearchParams(**kw), delta=delta, n_rungs=5)
    assert len(t) == len(r) == 5
    for rung in range(-1, 7):
        got = dataclasses.asdict(t.params(rung))     # the port's fields
        want = dataclasses.asdict(r.params(rung))
        assert got == {k: want[k] for k in got}
        b = t.delta_bound(rung)
        assert b == r.delta_bound(rung) or (math.isinf(b) and delta == 0.0)


def test_breaker_walk_equals_reference():
    clock = FakeClock()
    r = RefBreaker([("beam", "auto"), ("beam", "jnp")], threshold=2,
                   cooldown_s=10.0, clock=clock)
    t = CircuitBreaker([("auto",), ("jnp",)], threshold=2, cooldown_s=10.0,
                       clock=clock)
    script = ["f0", "f0", "t5", "t11", "f0", "t25", "s0", "f1", "f1", "f1"]
    for step in script:
        if step[0] == "f":
            r.record_failure(int(step[1:])), t.record_failure(int(step[1:]))
        elif step[0] == "s":
            r.record_success(int(step[1:])), t.record_success(int(step[1:]))
        else:
            clock.t = float(step[1:])
        assert t.current()[0] == r.current()[0]
        assert [(x.name, x.failures, x.open_until) for x in t.tiers] == \
            [(x.name, x.failures, x.open_until) for x in r.tiers]


@pytest.mark.parametrize("backend", ["auto", "jnp", "kernel",
                                     "kernel_tiled"])
def test_default_tiers_equal_reference(backend):
    """Off the card the chain is the reference's beam chain; on the card a
    kernel backend stands alone, with no plain tier behind it."""
    assert default_tiers(backend, "cpu") == \
        [(b, w) for _, b, w in ref_default_tiers("beam", backend)]
    card = default_tiers(backend, torch.device("cuda"))
    if backend == "jnp":
        assert card == default_tiers(backend, "cpu")
    else:
        assert card == [(backend, None)]


# ---------------------------------------------------------------------------
# The whole server, request for request.
# ---------------------------------------------------------------------------


def test_overload_ladder_matches_reference(tiny):
    """A 128-deep burst walks the ladder down and light traffic walks it
    back up, at the same batches in both packages."""
    r, t, r_reg, t_reg, _ = _servers(
        tiny, dict(degrade_depth=8, recover_depth=2, n_rungs=4),
        max_batch=8, buckets=(8,))
    burst = np.repeat(tiny["queries"], 2, axis=0)
    r_rs, t_rs = _drain(r, burst), _drain(t, burst)
    assert t.stats.n_degraded > 0 and t.rung > 0
    for _ in range(4):
        r_rs += _drain(r, tiny["queries"][:1])
        t_rs += _drain(t, tiny["queries"][:1])
    assert t.rung == 0
    assert_same_outcomes(r, t, r_rs, t_rs, r_reg, t_reg)


def test_validation_and_shedding_match_reference(tiny):
    r, t, r_reg, t_reg, _ = _servers(tiny, dict(max_queue=12), max_batch=8,
                                     buckets=(8,))
    qs = list(tiny["queries"][:16])
    qs[2] = np.array([np.nan] * 16, np.float32)
    qs[5] = np.zeros(7, np.float32)
    qs[9] = np.array([np.inf] * 16, np.float32)
    r_terminal = [r.submit(q) for q in qs]
    t_terminal = [t.submit(q) for q in qs]
    assert [x and x.status for x in t_terminal] == \
        [x and x.status for x in r_terminal]
    assert_same_outcomes(r, t, r.drain(), t.drain(), r_reg, t_reg)
    assert (t.stats.n_rejected, t.stats.n_shed) == (3, 1)


def test_expired_deadlines_match_reference(tiny):
    r, t, r_reg, t_reg, _ = _servers(tiny, dict(deadline_s=0.0), max_batch=8,
                                     buckets=(8,))
    r.submit_many(tiny["queries"][:8])
    t.submit_many(tiny["queries"][:8])
    time.sleep(0.01)
    r_rs, t_rs = r.drain(), t.drain()
    assert all(x.status == "deadline" for x in t_rs)
    assert_same_outcomes(r, t, r_rs, t_rs, r_reg, t_reg)


@pytest.mark.faults
@pytest.mark.parametrize("case", ["transient", "persistent_auto", "all_dead",
                                  "latency_spike"])
def test_injected_faults_match_reference(tiny, case):
    cfg, plan = {
        "transient": ({}, dict(fail_first=1)),
        "persistent_auto": (dict(breaker_threshold=2),
                            dict(fail_first=10**6, match_backend="auto")),
        "all_dead": (dict(breaker_threshold=2, max_retries=1),
                     dict(fail_first=10**6)),
        "latency_spike": (dict(deadline_s=0.05), dict(latency_s=0.12)),
    }[case]
    r, t, r_reg, t_reg, _ = _servers(tiny, cfg, max_batch=8, buckets=(8,))
    qs = tiny["queries"][:16]
    with ref_inject(r, RefPlan(**plan)) as r_inj:
        r_rs = _drain(r, qs)
    with inject_search_faults(t, FaultPlan(**plan)) as t_inj:
        t_rs = _drain(t, qs)
    assert all(e == "beam" for e, _, _ in r_inj.tier_log)
    assert t_inj.tier_log == [(b, w) for _, b, w in r_inj.tier_log]
    assert (t_inj.n_calls, t_inj.n_failed) == (r_inj.n_calls, r_inj.n_failed)
    assert_same_outcomes(r, t, r_rs, t_rs, r_reg, t_reg)
    if case == "persistent_auto":
        assert all(x.tier == "beam/jnp" for x in t_rs)
    if case == "all_dead":
        assert all(x.status == "failed" for x in t_rs)
        assert t_inj.tier_log[-1] == ("jnp", 1)


@pytest.mark.faults
def test_breaker_half_open_recovery_matches_reference(tiny):
    """The primary tier fails twice, opens, the batches fall back; once the
    injectable clock passes the cooldown the primary is probed again and
    closes — the same transitions, in the same batches, in both."""
    r, t, r_reg, t_reg, clock = _servers(
        tiny, dict(breaker_threshold=2, breaker_cooldown_s=10.0),
        max_batch=8, buckets=(8,))
    plan = dict(fail_calls=(0, 1), match_backend="auto")
    r_rs, t_rs = [], []
    with ref_inject(r, RefPlan(**plan)), inject_search_faults(
            t, FaultPlan(**plan)):
        for step, q in enumerate(np.split(tiny["queries"][:32], 4)):
            clock.t = 0.0 if step < 2 else 11.0
            r_rs += _drain(r, q)
            t_rs += _drain(t, q)
    assert [x.tier for x in t_rs[::8]] == ["beam/jnp", "beam/jnp",
                                           "beam/auto", "beam/auto"]
    assert_same_outcomes(r, t, r_rs, t_rs, r_reg, t_reg)
