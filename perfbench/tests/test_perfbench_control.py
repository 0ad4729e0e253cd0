"""The control and the faults a cell can have come out not correct; the
control at the cells' own size runs on the card only."""

import pytest
import torch

from pbench import faults
from pbench.cell import Cell, run_cell

SEED = 2 ** 35 + 3


# the number each fault has to fail, at least
WANT = {"unchanged": "recall_miss", "half_stopped": "recall_miss",
        "zero_estimates": "recall_miss", "altered": None}
EXACT = {"synth-d128.batch": "dist_err"}
CELLS = list(EXACT)


def _run(tiny_bench, workload):
    cell = Cell(workload, bench_dir=tiny_bench)
    return run_cell(cell, SEED, 0.0, False, "cpu", 0.0, log=lambda m: None)


def _failing(line):
    return {n for n, c in line["checks"].items() if c["value"] > c["limit"]}


@pytest.mark.parametrize("fault", faults.LOOP_FAULTS)
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_search_is_not_correct(tiny_bench, workload, fault):
    with faults.loop_fault(fault):
        line = _run(tiny_bench, workload)
    assert not line["correct"]
    assert (WANT[fault] or EXACT[workload]) in _failing(line), line["checks"]


@pytest.mark.parametrize("fault,number", [("shuffled", "graph_miss"),
                                          ("truncated", "degree_short")])
@pytest.mark.parametrize("workload", CELLS)
def test_a_faulty_graph_is_not_correct(tiny_bench, workload, fault, number):
    cell = Cell(workload, bench_dir=tiny_bench)
    snap = cell.system.snapshot
    cell.system.snapshot = lambda st: faults.graph_fault(snap(st), fault, 5)
    try:
        line = run_cell(cell, SEED, 0.0, False, "cpu", 0.0,
                        log=lambda m: None)
    finally:
        cell.system.snapshot = snap
    assert number in _failing(line), line["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails(tiny_bench, workload):
    from calibrate import control_readings
    cell = Cell(workload, bench_dir=tiny_bench)
    row = control_readings(cell, SEED, 2, "cpu")
    assert set(row["failed"]) == {EXACT[workload]}, row


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_at_the_cells_size(card, workload):
    from calibrate import control_readings
    cell = Cell(workload)
    for seed in (SEED, SEED + 1, SEED + 2):
        row = control_readings(cell, seed, 1, card)
        assert row["failed"], row
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_faults_fail_at_the_cells_size(card, workload):
    from calibrate import program_readings
    cell = Cell(workload)
    rows = program_readings(cell, [SEED], ["half_stopped", "zero_estimates",
                                           "shuffled", "truncated"],
                            [SEED + 1], card)
    assert not rows[0]["failed"], rows[0]
    for row in rows[1:]:
        assert row["failed"], row
    torch.cuda.empty_cache()
