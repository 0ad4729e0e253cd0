"""The port's spans in the probing loop, the sharded search and the build
(``repro_torch.obs.Tracer`` threaded as ``tracer=``), on the CPU.

Tracing is observation only: with a tracer the search and the build give
the same answers, counters, graph and codes bit for bit.  The spans form
the documented tree (``repro_torch/obs/__init__.py``), the loop's
``probe.iter`` spans count the rows still searching, and
``stats["iterations"]`` counts the passes that searched.  The tracer's
ring counts what it drops and carries the clock anchors that map spans
onto a profiler's timeline.
"""

import importlib

import numpy as np
import pytest
import torch

from repro_torch.core import BuildParams, SearchParams
from repro_torch.core.build_approx import build_approx
from repro_torch.core.distributed import build_sharded, make_sharded_search
from repro_torch.core.emqg import build_emqg
from repro_torch.core.probing import probing_search
from repro_torch.obs import MetricsRegistry, Tracer, maybe_span

N, D = 420, 16
BP = BuildParams(max_degree=8, beam_width=16, t=4, iters=2, block=160,
                 align_degree=True)
SP = SearchParams(k=5, l0=5, l_max=32, alpha=1.2, adaptive=True,
                  max_hops=300)
LOOP = ("probe.sync", "probe.select", "probe.exact", "probe.select",
        "probe.dedup", "probe.estimate", "probe.merge", "probe.transition")
COUNTERS = ("n_dist_comps", "n_approx_comps", "n_hops", "final_l",
            "saturated", "n_encounters")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(29)
    return (rng.standard_normal((N, D)).astype(np.float32),
            rng.standard_normal((24, D)).astype(np.float32))


@pytest.fixture(scope="module")
def emqg(data):
    return build_emqg(data[0], BP, device="cpu")


@pytest.fixture(scope="module")
def sharded(data):
    return {s: build_sharded(data[0], s, BP, quantized=True, device="cpu")
            for s in (1, 2)}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _traced_search(how, emqg, sharded, Q, tracer):
    """(answers, counters) of one search, ``tracer`` given or not."""
    if how == "probing":
        r = probing_search(emqg, Q, SP, tracer=tracer)
        return [r.ids, r.dists], [getattr(r, c) for c in COUNTERS]
    merge, shards = how.split("-")
    stats = {}
    ids, dists = make_sharded_search(merge, quantized=True)(
        sharded[int(shards)], Q, SP, stats=stats, tracer=tracer)
    return [ids, dists], [*stats["n_hops"].values(), stats["iterations"]]


@pytest.mark.parametrize("how", ["probing", "all_gather-1", "all_gather-2",
                                 "ring-2"])
def test_tracing_changes_no_answer_or_counter(emqg, sharded, data, how):
    off = _traced_search(how, emqg, sharded, data[1], None)
    tr = Tracer(max_spans=2 ** 16)
    on = _traced_search(how, emqg, sharded, data[1], tr)
    assert tr.n_dropped == 0 and tr.by_name("probe.iter")
    for a, b in zip(off[0] + off[1], on[0] + on[1]):
        if isinstance(a, torch.Tensor):
            assert torch.equal(_bits(a), _bits(b))
        else:
            assert a == b


@pytest.mark.parametrize("shards", [1, 2])
def test_the_call_span_tree(sharded, data, shards):
    tr = Tracer(max_spans=2 ** 16)
    stats = {}
    make_sharded_search("all_gather", quantized=True)(
        sharded[shards], data[1], SP, stats=stats, tracer=tr)
    (call,) = tr.by_name("ann.call")
    assert call.parent_id is None
    assert call.attrs == {"queries": len(data[1]), "shards": shards}
    kids = sorted(tr.children_of(call), key=lambda s: s.start)
    assert [s.name for s in kids] == ["search.lockstep", "search.merge"]
    lock = kids[0]
    assert lock.attrs["rows"] == shards * len(data[1])
    passes = sorted(tr.children_of(lock), key=lambda s: s.start)
    assert {s.name for s in passes} == {"probe.iter"}
    assert [s.attrs["i"] for s in passes] == list(range(len(passes)))
    searched = [s for s in passes if s.attrs["active"] > 0]
    assert len(searched) == stats["iterations"] == len(passes) - 1
    for s in searched:
        names = [c.name for c in sorted(tr.children_of(s),
                                        key=lambda c: c.start)]
        assert names == list(LOOP)
    assert [c.name for c in tr.children_of(passes[-1])] == ["probe.sync"]
    for s in tr.finished:
        parent = [p for p in tr.finished if p.span_id == s.parent_id]
        if parent:
            assert parent[0].start <= s.start <= s.end <= parent[0].end


@pytest.mark.parametrize("how", ["probing", "all_gather-2"])
def test_the_first_pass_has_every_row_and_the_last_none(emqg, sharded, data,
                                                        how):
    tr = Tracer(max_spans=2 ** 16)
    _traced_search(how, emqg, sharded, data[1], tr)
    passes = tr.by_name("probe.iter")
    rows = len(data[1]) * (2 if how.endswith("2") else 1)
    assert all(s.attrs["rows"] == rows for s in passes)
    assert passes[0].attrs["active"] == rows
    assert passes[-1].attrs["active"] == 0
    active = [s.attrs["active"] for s in passes]
    assert active == sorted(active, reverse=True)   # rows only retire


@pytest.mark.parametrize("quantized", [False, True], ids=["graph", "emqg"])
def test_iterations_count_the_passes_that_searched(sharded, data, quantized,
                                                   monkeypatch):
    """Counted against the loop's own calls: δ-EMG's loop selects a
    frontier once a pass."""
    port_search = importlib.import_module("repro_torch.core.search")
    sidx = sharded[2] if quantized else build_sharded(
        data[0], 2, BP, quantized=False, device="cpu")
    calls, real = [], port_search.select_top_w

    def spy(*args):
        calls.append(1)
        return real(*args)

    if not quantized:
        monkeypatch.setattr(port_search, "select_top_w", spy)
    tr, stats = Tracer(max_spans=2 ** 16), {}
    make_sharded_search("all_gather", quantized=quantized)(
        sidx, data[1], SP, stats=stats, tracer=tr)
    if quantized:
        assert stats["iterations"] == sum(
            s.attrs["active"] > 0 for s in tr.by_name("probe.iter"))
    else:
        assert stats["iterations"] == len(calls) > 0


@pytest.mark.parametrize("entry", ["build_approx", "build_emqg"])
def test_a_traced_build_is_the_same_build(data, emqg, entry):
    tr = Tracer()
    if entry == "build_emqg":
        got = build_emqg(data[0], BP, device="cpu", tracer=tr)
        assert torch.equal(got.codes.codes, emqg.codes.codes)
        assert torch.equal(got.codes.norms, emqg.codes.norms)
        assert torch.equal(got.codes.ip_xo, emqg.codes.ip_xo)
        want = emqg.graph
        got = got.graph
    else:
        got = build_approx(data[0], BP, device="cpu", tracer=tr)
        want = build_approx(data[0], BP, device="cpu")
    assert torch.equal(got.neighbors, want.neighbors)
    assert got.medoid == want.medoid
    blocks = -(-N // BP.block)
    (root,) = tr.by_name("build")
    assert root.parent_id is None and root.attrs == {"n": N}
    assert len(tr.by_name("build.search")) == BP.iters * blocks
    assert len(tr.by_name("build.select")) == BP.iters * blocks
    top = [s.name for s in sorted(tr.children_of(root),
                                  key=lambda s: s.start)]
    want_top = (["build.bootstrap"]
                + ["build.refine", "build.repair"] * BP.iters
                + ["build.align", "build.repair"])
    if entry == "build_emqg":
        want_top.append("build.quantize")
    assert top == want_top
    for refine in tr.by_name("build.refine"):
        kids = [s.name for s in sorted(tr.children_of(refine),
                                       key=lambda s: s.start)]
        assert kids == ["build.search", "build.select"] * blocks
    assert [s.attrs["iter"] for s in tr.by_name("build.repair")] == \
        list(range(BP.iters)) + ["align"]


@pytest.mark.parametrize("traced", [False, True])
def test_build_events_keep_their_phases_and_order(data, traced):
    m = MetricsRegistry()
    tr = Tracer() if traced else None
    build_approx(data[0], BP, device="cpu", metrics=m, tracer=tr)
    events = [e for e in m.events if e["name"] == "build_progress"]
    assert [e["phase"] for e in events] == \
        ["bootstrap", "refine_iter0", "refine_iter1", "align_degree"]
    assert all(e["elapsed_s"] > 0 for e in events)
    hist = m.histogram("build_phase_seconds", {"phase": "refine_iter1"})
    assert hist.count == 1
    if traced:
        def seconds(name):
            return [s.duration_s for s in tr.by_name(name)]
        repair = seconds("build.repair")
        assert events[0]["elapsed_s"] == seconds("build.bootstrap")[0]
        for it, e in enumerate(events[1:3]):
            assert e["elapsed_s"] == pytest.approx(
                seconds("build.refine")[it] + repair[it], rel=1e-12)
        assert events[3]["elapsed_s"] == pytest.approx(
            seconds("build.align")[0] + repair[-1], rel=1e-12)


def test_the_ring_counts_what_it_drops_and_carries_anchors():
    tr = Tracer(max_spans=3)
    assert len(tr.anchors) == 1
    perf_ns, unix_ns = tr.anchors[0]
    assert perf_ns > 0 and unix_ns > 10 ** 18          # after 2001
    for i in range(5):
        with tr.span(f"s{i}"):
            pass
    assert len(tr.finished) == 3 and tr.n_dropped == 2
    assert [d["name"] for d in tr.to_dicts()] == ["s2", "s3", "s4"]
    assert len(tr.anchors) == 2                         # one at export
    assert tr.anchors[1][0] >= perf_ns


def test_no_tracer_makes_no_span():
    with maybe_span(None, "probe.iter", i=0) as span:
        assert span is None
    tr = Tracer()
    with maybe_span(tr, "probe.iter", i=0) as span:
        span.set(active=3)
    assert tr.finished[0].attrs == {"i": 0, "active": 3}
