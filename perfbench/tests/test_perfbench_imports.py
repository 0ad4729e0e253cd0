"""Nothing of the benchmark imports JAX or the JAX package, and a run
refuses to report where they were loaded, where the port is missing, or
where the cards are."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from pbench.cell import FORBIDDEN, forbidden_modules

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _imported_tops(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") \
                == "import_module" and node.args and \
                isinstance(node.args[0], ast.Constant):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 10
    for path in files:
        assert not _imported_tops(path) & set(FORBIDDEN), path
        assert not path.stem.split(".")[0] in FORBIDDEN, path


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in FORBIDDEN:
        monkeypatch.delitem(sys.modules, name, raising=False)
    import repro_torch  # noqa: F401  (the port: allowed)
    monkeypatch.setitem(sys.modules, "reprofile", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping.x", sys)
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert forbidden_modules() == ["jax", "repro"]


RUN_TINY = """
import sys
sys.path[:0] = [{src!r}, {bench!r}]
from pbench.cell import Cell, run_cell, forbidden_modules
line = run_cell(Cell("synth-d128.batch",
                     bench_dir=__import__("pathlib").Path({tiny!r})),
                5, 0.0, False, "cpu", 0.0, log=lambda m: None)
assert line["correct"]
print(forbidden_modules())
"""


def test_a_run_loads_neither(tiny_bench):
    code = RUN_TINY.format(src=str(ROOT / "src"), bench=str(BENCH),
                           tiny=str(tiny_bench))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _run(cwd: Path, *extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "synth-d128.batch",
         "--seed", "3", "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, env=env, timeout=300)


def test_no_result_without_the_port(tmp_path):
    shutil.copytree(BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


def test_no_result_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    out = _run(ROOT)
    assert out.returncode == 3 and out.stdout == ""
    assert "needs 1 CUDA card" in out.stderr


def test_benchmark_json_keeps_to_its_shape():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = {m["name"] for m in spec["end_to_end"] + spec["per_layer"]}
    assert {"qps", "recall", "setup_s"} <= names
    for m in spec["per_layer"]:
        assert m["moves"] in {e["name"] for e in spec["end_to_end"]}
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    for c in spec["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert (BENCH / "configs" / f"{c['name']}.ref.py").is_file()
    for w in spec["workloads"]:
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
