"""``pbench/spans.py`` on hand-made spans and device traces: the clock
mapping, each op's and each gap's span, the per-span table and the
readings, and their silence without spans or with a ring that dropped
some.  The span tool itself is rehearsed on the CPU at the tiny sizes."""

import importlib.util
from pathlib import Path

import pytest

from pbench import spans

BENCH = Path(__file__).resolve().parents[1]
ANCHORS = [(1_000, 5_001_000), (101_000, 5_101_000)]     # epoch = perf + 5e6


def _span(sid, name, start_ns, end_ns, parent=None, **attrs):
    return {"name": name, "span_id": sid, "parent_id": parent,
            "start": start_ns / 1e9, "end": end_ns / 1e9, "attrs": attrs}


def _call():
    """One call of two passes, on the spans' clock (ns): the second pass
    finds no active row."""
    return [
        _span(1, "ann.call", 10_000, 90_000, queries=4, shards=1),
        _span(2, "search.lockstep", 11_000, 80_000, 1, rows=4),
        _span(3, "probe.iter", 20_000, 50_000, 2, i=0, rows=4, active=3),
        _span(4, "probe.sync", 20_000, 24_000, 3),
        _span(5, "probe.select", 24_000, 30_000, 3),
        _span(6, "probe.merge", 40_000, 48_000, 3),
        _span(7, "probe.iter", 50_000, 56_000, 2, i=1, rows=4, active=0),
        _span(8, "probe.sync", 50_000, 55_000, 7),
        _span(9, "search.merge", 81_000, 89_000, 1),
    ]


# device ops (name, start, end, correlation id) and their launch calls, on
# the epoch's clock (the spans' + 5,000,000 ns)
OPS = [
    ("void sort_kernel<float>(float*)", 5_026_000, 5_031_000, 11),
    ("elementwise(float*)", 5_033_000, 5_034_000, 12),
    ("void sort_kernel<float>(float*)", 5_042_000, 5_046_000, 13),
    ("gather(float*)", 5_046_000, 5_047_000, 14),
    ("stray(float*)", 5_095_000, 5_096_000, 15),
    ("unmatched(float*)", 5_097_000, 5_098_000, 99),
]
LAUNCHES = {11: 5_025_000, 12: 5_032_000, 13: 5_041_000, 14: 5_043_000,
            15: 5_094_000}


class _Event:
    """A stand-in for one of the profiler's raw events."""

    def __init__(self, name, device, corr, start, duration):
        self._v = name, device, corr, start, duration

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def correlation_id(self):
        return self._v[2]

    def start_ns(self):
        return self._v[3]

    def duration_ns(self):
        return self._v[4]


def test_the_profilers_events_give_ops_and_their_launch_calls():
    import torch
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    raw = [_Event("cudaLaunchKernel", cpu, 7, 100, 5),
           _Event("void k2(float*)", cuda, 8, 400, 10),
           _Event("cudaStreamSynchronize", cpu, 9, 120, 50),
           _Event("Buffer Flush", cpu, 9, 130, 2),     # the profiler's own
           _Event("Activity Buffer Request", cpu, 0, 90, 3),
           _Event("void k1(float*)", cuda, 7, 300, 20),
           _Event("cudaMemcpyAsync", cpu, 8, 110, 4)]
    ops, launches = spans.profiler_events(raw)
    assert ops == [("void k1(float*)", 300, 320, 7),
                   ("void k2(float*)", 400, 410, 8)]
    assert launches == {7: 100, 8: 110, 9: 120}


def test_spans_map_onto_the_epoch_clock():
    m = spans.mapped_spans(_call(), ANCHORS)
    assert [s["t0"] for s in m[:2]] == [5_010_000, 5_011_000]
    assert spans.drift_ns(ANCHORS) == 0
    drifting = [(1_000, 5_001_000), (101_000, 5_101_100)]   # +100 ns
    assert spans.drift_ns(drifting) == 100
    late = spans.mapped_spans([_span(1, "x", 101_000, 101_000)], drifting)
    assert late[0]["t0"] == 5_101_100


def test_the_innermost_span_owns_a_time():
    m = spans.mapped_spans(_call(), ANCHORS)
    bounds, owners = spans._segments(m)
    names = {t: (m[k]["name"] if k >= 0 else None) for t in (
        5_005_000, 5_010_500, 5_021_000, 5_025_000, 5_032_000, 5_041_000,
        5_052_000, 5_056_500, 5_085_000, 5_090_000)
        for k in [spans.owner_of(bounds, owners, t)]}
    assert names == {
        5_005_000: None, 5_010_500: "ann.call", 5_021_000: "probe.sync",
        5_025_000: "probe.select", 5_032_000: "probe.iter",
        5_041_000: "probe.merge", 5_052_000: "probe.sync",
        5_056_500: "search.lockstep", 5_085_000: "search.merge",
        5_090_000: None}
    assert spans.owner_of(bounds, owners, None) == -1


def test_each_op_and_gap_goes_to_the_span_of_its_launch():
    m = spans.mapped_spans(_call(), ANCHORS)
    att = spans.attribute(m, OPS, LAUNCHES)
    rows = att["rows"]
    assert rows["probe.select"]["device_ns"] == 5_000
    assert rows["probe.iter"]["device_ns"] == 1_000       # its own launch
    assert rows["probe.merge"]["device_ns"] == 5_000
    assert rows["probe.merge"]["ops"] == 2
    # launched outside every span, or with no launch call found
    assert rows[spans.UNATTRIBUTED]["device_ns"] == 2_000
    assert rows[spans.UNATTRIBUTED]["ops"] == 2
    # gaps: 2 µs before the elementwise op (launched in probe.iter), 8 µs
    # before the second sort (probe.merge), 48 µs before the stray op and
    # 1 µs before the unmatched one (unattributed); none before the gather
    assert rows["probe.iter"]["idle_ns"] == 2_000
    assert rows["probe.merge"]["idle_ns"] == 8_000
    assert rows[spans.UNATTRIBUTED]["idle_ns"] == 49_000
    assert att["busy_ns"] == 13_000
    assert att["gaps"]["probe.merge"] == {"sort_kernel<float>": 8_000}
    assert att["device"]["probe.merge"] == {"sort_kernel<float>": 4_000,
                                            "gather": 1_000}
    # host self time: a span less its children
    assert rows["probe.iter"]["host_self_ns"] == (30_000 - 18_000) \
        + (6_000 - 5_000)
    assert rows["probe.iter"]["spans"] == 2
    gaps = spans.idle_gaps(att["gaps"])
    assert gaps[0] == ["unattributed: before stray", pytest.approx(48e-6)]
    assert gaps[1] == ["probe.merge: before sort_kernel<float>",
                       pytest.approx(8e-6)]
    assert all(len(k) <= 64 for k, _ in gaps)
    lines = spans.table(rows, 1)
    assert lines[1].split()[0] in ("probe.select", "probe.merge")
    assert any(line.startswith("unattributed") for line in lines)


def test_kernel_shares_and_early_starts():
    m = spans.mapped_spans(_call(), ANCHORS)
    att = spans.attribute(m, OPS, LAUNCHES)
    assert spans.share_in(OPS, att["owners"], m, r"sort_kernel",
                          "probe.merge") == (1, 2)
    assert spans.early_starts(OPS, LAUNCHES) == 0
    early = {**LAUNCHES, 12: 5_035_001}          # after its op's start
    assert spans.early_starts(OPS, early) == 1
    assert spans.early_starts(OPS, early, slack_ns=3_000) == 0


def test_the_readings():
    m = spans.mapped_spans(_call(), ANCHORS)
    att = spans.attribute(m, OPS, LAUNCHES)
    assert spans.merge_ms(att["rows"], m, 0) == pytest.approx(0.005)
    assert spans.active_row_share(m, 0) == pytest.approx(75.0)
    # 30 µs less its 4 µs sync
    assert spans.host_launch_ms(m, 0) == pytest.approx(0.026)
    build = [_span(1, "build", 0, 9e9, n=8),
             _span(2, "build.search", 0, 2e9, 1),
             _span(3, "build.search", 3e9, 4.5e9, 1)]
    assert spans.build_search_s(build, 0) == pytest.approx(3.5)


@pytest.mark.parametrize("reading", ["merge_ms", "active_row_share",
                                     "host_launch_ms", "build_search_s"])
def test_a_reading_is_silent_without_spans_or_after_drops(reading):
    m = spans.mapped_spans(_call(), ANCHORS)
    att = spans.attribute(m, OPS, LAUNCHES)
    build = [_span(2, "build.search", 0, 2e9)]
    args = {"merge_ms": lambda s, d: spans.merge_ms(att["rows"], s, d),
            "active_row_share": spans.active_row_share,
            "host_launch_ms": spans.host_launch_ms,
            "build_search_s": spans.build_search_s}[reading]
    present = build if reading == "build_search_s" else m
    assert args(present, 0) is not None
    assert args([], 0) is None
    assert args(present, 1) is None


def test_the_span_tool_rehearses_on_the_cpu(tiny_bench):
    """The tool's whole flow at the tiny sizes: the CPU launches nothing,
    so only the program's counters read."""
    from pbench.cell import Cell
    spec = importlib.util.spec_from_file_location(
        "trace_spans", BENCH / "trace_spans.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    out = tool.run(Cell("synth-d128.batch", bench_dir=tiny_bench),
                   2 ** 33 + 7, 1, "cpu", 0.0, log=lambda m: None)
    assert out["n_dropped"] == 0 and out["forbidden"] == []
    assert all(r["equal"] for r in out["replays"].values())
    assert out["iterations"] == out["calls"][0]["iterations"] > 0
    r = out["readings"]
    assert 0 < r["active_row_share"] <= 100
    assert r["host_launch_ms"] > 0 and r["build_search_s"] > 0
    assert r["merge_ms"] == 0.0                  # no device op on the CPU
    assert out["build_phases_s"]["build.search"] == r["build_search_s"]
