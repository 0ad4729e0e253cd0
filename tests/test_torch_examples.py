"""The port's examples (``examples/torch_*.py``) run on the CPU with
``--device cpu``, as a user runs them (``python examples/...`` with
``PYTHONPATH=src``), and print their result lines; without a card and
without ``--device cpu`` each raises before any work.

The four run at once, one process each with one intra-op thread.  Cuts
(the card runs them uncut, ``chip_smoke.py``'s examples phase): the two
ANN examples at ``--n 600`` (from 4,000); ``torch_train_lm.py`` at its
model's sizes for 1 step of batch 1 × 16 tokens (from 300 of 8 × 256),
a checkpoint after it, then a second run to step 2 that resumes there;
``torch_recsys_retrieval.py`` at its model's sizes for 2 steps (from
200), so its recall is not the trained model's.
"""

import importlib.util
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "vector_serve", "train_lm", "recsys_retrieval")


def _cmd(name, *argv):
    return [sys.executable, str(ROOT / "examples" / f"torch_{name}.py"),
            *argv, "--device", "cpu"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each example's (return code, output), the four run in parallel."""
    ckpt = str(tmp_path_factory.mktemp("lm_ckpt"))
    lm = ["--batch", "1", "--seq", "16", "--ckpt-every", "1",
          "--ckpt-dir", ckpt]
    jobs = {
        "quickstart": [_cmd("quickstart", "--n", "600")],
        "vector_serve": [_cmd("vector_serve", "--n", "600")],
        "train_lm": [_cmd("train_lm", "--steps", "1", *lm),
                     _cmd("train_lm", "--steps", "2", *lm)],
        "recsys_retrieval": [_cmd("recsys_retrieval", "--steps", "2")],
    }
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)

    def start(cmd):
        return subprocess.Popen(cmd, cwd=ROOT, env=env, text=True,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT)

    procs = {name: start(cmds[0]) for name, cmds in jobs.items()}
    out = {}
    for name, cmds in jobs.items():
        text = procs[name].communicate(timeout=600)[0]
        rc = procs[name].returncode
        for cmd in cmds[1:]:                    # the resumed run
            if rc == 0:
                nxt = start(cmd)
                more = nxt.communicate(timeout=600)[0]
                text, rc = text + "\n--- resumed ---\n" + more, nxt.returncode
        out[name] = (rc, text)
    import shutil
    shutil.rmtree(ckpt, ignore_errors=True)     # 0.5 GB of f32 state
    return out


RESULT_LINES = {
    "quickstart": (r"\[build_approx\] refine_iter2", r"mean out-degree: \d",
                   r"recall@10 = \d\.\d+\s+relative-distance-error = ",
                   r"mean distance computations / query = \d+",
                   r"certificate found for \d+% of queries; mean certified"),
    "vector_serve": (r"built in [\d.]+s; code compression = 24×",
                     r"served 300 requests in \d+ batches → recall@10=\d\.\d+",
                     r"4-shard sharded index recall@10 = \d\.\d+"),
    "train_lm": (r"model: 46M params", r"step    0  loss=9\.\d+",
                 r"--- resumed ---\n(.|\n)*resumed at step 1\n",
                 r"step    1  loss=\d+\.\d+", r"done\.\n(.|\n)*done\."),
    "recsys_retrieval": (r"step 0: loss=\d\.\d+ acc=", r"step 1: loss=",
                         r"exact scoring of 8192 items",
                         r"δ-EMQG build over item table",
                         r"recall@50 vs exact: \d\.\d+",
                         r"distance budget: \d+ exact \+ \d+ approx"),
}


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_on_the_cpu(runs, name):
    rc, text = runs[name]
    assert rc == 0, text[-3000:]
    for pattern in RESULT_LINES[name]:
        assert re.search(pattern, text), (pattern, text[-3000:])
    assert "nan" not in text.lower().replace("nanoseconds", "")


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_needs_a_card_or_device_cpu(name):
    """``main()`` with no ``--device`` asks for the card, and without one
    raises before it builds or trains anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is valid")
    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", ROOT / "examples" / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.path.insert(0, str(ROOT / "src"))
    try:
        spec.loader.exec_module(mod)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mod.main([])
    finally:
        sys.path.remove(str(ROOT / "src"))
