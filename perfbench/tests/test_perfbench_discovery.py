"""A configuration, a cell and a per-layer metric are added by adding
files and entries alone; the harness finds them by name."""

import json
import shutil

from pbench.cell import Cell, run_cell

NEW_METRIC = '''"""calls_in_window: how many calls the window held."""


def read(ctx):
    return float(len(ctx["calls"]))
'''


def test_new_config_cell_and_metric_are_found(tiny_bench, tmp_path):
    root = tmp_path / "copy"
    shutil.copytree(tiny_bench.parent, root)
    bench = root / "perfbench"
    # a configuration: its file and its reference, beside the others
    cfg = json.loads((bench / "configs" / "synth-d128.json").read_text())
    cfg.update(name="sift-small", n=900)
    cfg["corpus"]["n_clusters"] = 12
    (bench / "configs" / "sift-small.json").write_text(json.dumps(cfg))
    shutil.copy(bench / "configs" / "synth-d128.ref.py",
                bench / "configs" / "sift-small.ref.py")
    # a traffic mix, and a metric's reader
    (bench / "traffic" / "small.json").write_text(json.dumps(
        {"queries_per_call": 20}))
    (bench / "metrics" / "calls_in_window.py").write_text(NEW_METRIC)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "sift-small", "source": "test",
                            "file": "perfbench/configs/sift-small.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "sift-small.small",
                              "config": "sift-small", "traffic": "small",
                              "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "calls_in_window", "unit": "calls",
                              "better": "higher", "source": "host_clock",
                              "layer": "probing loop", "moves": "qps",
                              "workloads": ["sift-small.small"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = Cell("sift-small.small", bench_dir=bench)
    assert cell.config["n"] == 900 and cell.traffic["queries_per_call"] == 20
    assert "calls_in_window" in cell.readers
    assert cell.readers["calls_in_window"].read({"calls": [{}, {}]}) == 2.0
    line = run_cell(cell, 77, 0.0, False, "cpu", 0.0, log=lambda m: None)
    assert line["correct"] and line["attempted"] == 20
    # the existing cells do not see the new metric
    assert "calls_in_window" not in Cell("synth-d128.batch",
                                         bench_dir=bench).readers
