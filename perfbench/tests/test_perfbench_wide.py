"""The wide cell, ``synth-d960.batch``: its configuration against the
registry's sift1m, its corpus's intrinsic dimension and contrast, a whole
run at a CPU size, the faults and the control it fails, and the three
readers it adds, on hand-worked inputs."""

import json
from pathlib import Path

import pytest
import torch

from conftest import make_tiny
from pbench import data, faults
from pbench.cell import Cell, run_cell
from test_perfbench_control import _failing
from test_perfbench_counts import _metric
from test_perfbench_data import _lid

BENCH = Path(__file__).resolve().parents[1]
CONFIG = "synth-d960"
SEED = 2 ** 37 + 11
# GIST1M's local intrinsic dimension and relative contrast as arXiv:
# 1610.02455's dataset table reports them (about 19 and 1.9), with room
LID_RANGE = (17.0, 21.0)
CONTRAST_RANGE = (1.7, 2.2)
# a CPU size of the configuration, cut here (conftest.py's TINY cuts the
# cells that were there before this one); d stays 960, so the codes are
# W = 30 words and the exact tier takes the block kernels' width
TINY = {"n": 1200, "warmup_queries": 8,
        "build": {"max_degree": 16, "beam_width": 32, "t": 8, "iters": 2,
                  "align_degree": True, "max_hops": 256, "block": 1200},
        "search": {"k": 10, "l0": 10, "l_max": 64, "alpha": 1.2,
                   "adaptive": True, "max_hops": 512},
        "graph_check": {"queries": 48}}
# a recall's miss at that size: the cell's own limit is set at its size
TINY_LIMITS = {"recall_miss": 0.3, "graph_miss": 0.1}


def _cfg(name=CONFIG):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def corpus_readings(x: torch.Tensor, q: torch.Tensor):
    """(local intrinsic dimension, relative contrast) of the queries ``q``
    over the corpus ``x``, in float64: ``test_perfbench_data._lid``'s MLE
    over 20 neighbours, and the mean over queries of the mean distance to
    the corpus over the nearest."""
    d = torch.cdist(q.double(), x.double())
    return _lid(x, q), float((d.mean(1) / d.min(1).values).mean())


def _law_points(cfg, device, n_queries=300):
    """The configuration's corpus at its own n and ``n_queries`` of its
    queries, drawn on ``device`` from its data seed as the cell draws
    them."""
    c = cfg["corpus"]
    law = data.subspace_law(cfg["dim"], c["n_clusters"], c["rank"],
                            c["center_std"],
                            data.generator(device, cfg["data_seed"], 0))
    x = data.subspace_points(law, cfg["n"], c["spread"], c["noise"],
                             data.generator(device, cfg["data_seed"], 1))
    q = data.subspace_points(law, n_queries, c["spread"], c["noise"],
                             data.generator(device, cfg["data_seed"], 2,
                                            n_queries))
    return x, q


def test_synth_d960_is_the_registrys_sift1m_but_for_what_it_reduces():
    from repro_torch.configs import get_arch
    arch, cfg = get_arch("sift1m"), _cfg()
    assert cfg["dim"] == 960 and cfg["shards"] == 1
    assert sorted(cfg["reduced"]) == ["build", "n"]
    b = arch.model_cfg["build"]
    assert set(cfg["build"]) - {"block"} <= set(_cfg("synth-d128")["build"])
    for key, value in cfg["build"].items():
        if key != "block":
            assert getattr(b, key) == value, key
    s = arch.model_cfg["search"]
    for key, value in cfg["search"].items():
        assert getattr(s, key) == value, key
    assert cfg["search"] == _cfg("synth-d128")["search"]
    assert 32_768 <= cfg["n"] < 1_000_000
    assert cfg["data_seed"] != _cfg("synth-d128")["data_seed"]


def test_synth_d960_corpus_reads_gists_dimension_and_contrast():
    """The law at the cell's own n, drawn on the CPU (other draws than the
    card's, the same law)."""
    x, q = _law_points(_cfg(), "cpu")
    lid, contrast = corpus_readings(x, q)
    assert LID_RANGE[0] <= lid <= LID_RANGE[1], lid
    assert CONTRAST_RANGE[0] <= contrast <= CONTRAST_RANGE[1], contrast


@pytest.mark.cuda
def test_synth_d960_corpus_on_the_card(card):
    """The cell's own corpus and queries, as the card draws them."""
    x, q = _law_points(_cfg(), card)
    lid, contrast = corpus_readings(x, q)
    print(f"synth-d960 on the card: LID {lid!r}, relative contrast "
          f"{contrast!r}")
    assert LID_RANGE[0] <= lid <= LID_RANGE[1], lid
    assert CONTRAST_RANGE[0] <= contrast <= CONTRAST_RANGE[1], contrast


@pytest.fixture(scope="module")
def wide_bench(tmp_path_factory):
    """A copy of the benchmark with synth-d960 cut to ``TINY``."""
    bench = make_tiny(tmp_path_factory.mktemp("wide"))
    path = bench / "configs" / f"{CONFIG}.json"
    cfg = json.loads(path.read_text())
    cfg.update(TINY)
    cfg["limits"].update(TINY_LIMITS)
    path.write_text(json.dumps(cfg))
    return bench


def test_a_whole_wide_run_on_the_cpu_is_correct(wide_bench):
    cell = Cell("synth-d960.batch", bench_dir=wide_bench)
    assert cell.config["dim"] == 960
    assert {"wide_estimate_roofline", "wide_gather_roofline",
            "estimate_ms"} <= set(cell.readers)
    assert "fused_estimate_roofline" not in cell.readers
    line = run_cell(cell, SEED, 0.0, False, "cpu", 0.0, log=lambda m: None)
    assert line["correct"], line["checks"]
    assert line["attempted"] == 48 and line["failed"] == 0
    assert line["checks"]["dist_err"]["value"] <= cell.config["limits"][
        "dist_err"]
    assert 0.7 <= line["metrics"]["recall"]["value"] <= 1


# what each loop fault must fail at least: the numbers test_perfbench_
# control.py holds synth-d128 to, at d = 960
WANT = {"unchanged": "recall_miss", "half_stopped": "recall_miss",
        "zero_estimates": "recall_miss", "altered": "dist_err"}


@pytest.mark.parametrize("fault", faults.LOOP_FAULTS)
def test_a_broken_wide_search_is_not_correct(wide_bench, fault):
    cell = Cell("synth-d960.batch", bench_dir=wide_bench)
    with faults.loop_fault(fault):
        line = run_cell(cell, SEED, 0.0, False, "cpu", 0.0,
                        log=lambda m: None)
    assert not line["correct"]
    assert WANT[fault] in _failing(line), line["checks"]


@pytest.mark.parametrize("fault,number", [("shuffled", "graph_miss"),
                                          ("truncated", "degree_short")])
def test_a_faulty_wide_graph_is_not_correct(wide_bench, fault, number):
    cell = Cell("synth-d960.batch", bench_dir=wide_bench)
    snap = cell.system.snapshot
    cell.system.snapshot = lambda st: faults.graph_fault(snap(st), fault, 5)
    try:
        line = run_cell(cell, SEED, 0.0, False, "cpu", 0.0,
                        log=lambda m: None)
    finally:
        cell.system.snapshot = snap
    assert number in _failing(line), line["checks"]


def test_the_wide_control_fails(wide_bench):
    """The reference in the program's place in TF32, the precision below
    the configuration's float32, fails the distance limit alone."""
    from calibrate import control_readings
    row = control_readings(Cell("synth-d960.batch", bench_dir=wide_bench),
                           SEED, 2, "cpu")
    assert set(row["failed"]) == {"dist_err"}, row


def test_wide_estimate_bytes_are_fused_estimates():
    m = _metric("wide_estimate_roofline")
    codes = torch.zeros((10, 30), dtype=torch.int32)          # W = 30 words
    ids = torch.tensor([[0, 1, -1], [1, 1, 2]], dtype=torch.int32)
    q_unit = torch.zeros((2, 960))
    # rows {0, 1, 2} × (120 + 4 + 4) + ids 6 × 4 + 2 query rows ×
    # (3840 + 8) + √d 4 + estimates 6 × 4
    assert m.bytes_needed(codes, ids, q_unit) == 384 + 24 + 7696 + 4 + 24
    assert m.launch_bytes(codes, None, None, ids, q_unit, None, None,
                          None) == 0                   # a CPU call: none
    assert m.HOOK == ("repro_torch.kernels.bitdot.ops", "fused_estimate")


def test_wide_gather_bytes():
    m = _metric("wide_gather_roofline")
    base = torch.zeros((10, 960))
    ids = torch.tensor([[3], [-1], [3], [7]], dtype=torch.int32)  # [B, 1]
    # rows {3, 7} × 3840 + ids 16 + 3 query lines × 3840 + distances 16
    assert m.bytes_needed(base, ids) == 7680 + 16 + 11520 + 16
    assert m.HOOK == ("repro_torch.kernels.l2dist.ops", "gather_l2_tiled")
    for name in ("void (anonymous namespace)::gather_l2_kernel<true>(float "
                 "const*, int const*)",
                 "void l2rows::ragged_kernel<true, 4>(float const*)"):
        kernels = {name: (0.001, 2), "void batched_l2_kernel<true>()":
                   (5.0, 9)}
        ctx = {"trace": {"kernels": kernels},
               "bytes": {"wide_gather_roofline": [1.675e9, 2]}}
        assert m.read(ctx) == pytest.approx(50.0)


def test_estimate_ms_per_pass():
    m = _metric("estimate_ms")
    kernels = {"void (anonymous namespace)::fused_estimate_kernel<6>(int "
               "const*)": (0.006, 4),
               "void l2rows::rows_kernel<true, 2>()": (1.0, 4)}
    ctx = {"trace": {"kernels": kernels},
           "calls": [{"iterations": 4}, {"iterations": 9}]}
    assert m.read(ctx) == pytest.approx(1.5)          # 6 ms over 4 passes
    ctx["calls"][0]["iterations"] = 5          # launches differ: no reading
    assert m.read(ctx) is None and ctx["notes"]
    assert m.read({"trace": None, "calls": []}) is None
