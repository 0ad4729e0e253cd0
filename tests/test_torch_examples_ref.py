"""The port's ANN examples against the reference's on the same inputs, as a
user runs them on the CPU: ``examples/quickstart.py`` and
``examples/vector_serve.py`` (the JAX package) beside
``examples/torch_quickstart.py`` and ``examples/torch_vector_serve.py``
with ``--device cpu``, all four at the reference's own sizes (n = 4,000)
and at once, one process each.  Their printed numbers are compared within
the tolerances stated at each test.

The two vector_serve runs quantize with a random RaBitQ rotation, which
the reference draws from ``jax.random`` and the port from a torch
generator: the same seed gives two different rotations, and the served
recall moves with the rotation (0.326 against 0.359 at this corpus).  So
the port's example runs here with the reference's rotation for each
build seed, given through ``core.emqg._rotation``; everything else is the
example as shipped.
"""

import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]

# the port's vector_serve with each build's rotation the reference's
# (jax.random.PRNGKey(seed), as the reference's build_emqg draws it)
_PORT_SERVE_WITH_REF_ROTATION = """
import importlib.util, sys
import jax
import numpy as np
from repro.core import rabitq as ref_rabitq
from repro_torch.core import emqg

real = emqg._rotation


def ref_rotation(dim, generator, rotation, seed, device):
    if rotation is None and generator is None:
        rotation = np.asarray(ref_rabitq.random_rotation(
            dim, jax.random.PRNGKey(seed)))
    return real(dim, generator, rotation, seed, device)


emqg._rotation = ref_rotation
spec = importlib.util.spec_from_file_location(
    "torch_vector_serve", "examples/torch_vector_serve.py")
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
mod.main(["--device", "cpu"])
"""


@pytest.fixture(scope="module")
def outputs():
    """Each run's output; a run that fails fails the test that reads it."""
    py = sys.executable
    jobs = {
        "quickstart": [py, "examples/quickstart.py"],
        "torch_quickstart": [py, "examples/torch_quickstart.py",
                             "--device", "cpu"],
        "vector_serve": [py, "examples/vector_serve.py"],
        "torch_vector_serve": [py, "-c", _PORT_SERVE_WITH_REF_ROTATION],
    }
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")
    procs = {name: subprocess.Popen(cmd, cwd=ROOT, env=env, text=True,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT)
             for name, cmd in jobs.items()}
    out = {}
    for name, proc in procs.items():
        text = proc.communicate(timeout=600)[0]
        out[name] = (proc.returncode, text)
    return out


def _numbers(outputs, name, patterns):
    rc, text = outputs[name]
    assert rc == 0, text[-3000:]
    found = {}
    for key, pattern in patterns.items():
        m = re.search(pattern, text)
        assert m, (name, pattern, text[-3000:])
        found[key] = float(m.group(1))
    return found


QUICKSTART = {
    "recall": r"recall@10 = (\d\.\d+)",
    "rde": r"relative-distance-error = ([\d.e+-]+)",
    "comps": r"mean distance computations / query = (\d+)",
    "certified": r"certificate found for (\d+)% of queries",
    "delta": r"mean certified δ' = (\d\.\d+)",
}


def test_quickstart_equals_reference(outputs):
    """recall@10 within 0.01 (under one neighbour in a hundred: the two
    builders meet the index builds' bar, not bit for bit), the relative
    distance error within 5% of the reference's, the mean distance
    computations within 2%, the certified share within 2 points and the
    mean certified δ' within 0.002."""
    ref = _numbers(outputs, "quickstart", QUICKSTART)
    port = _numbers(outputs, "torch_quickstart", QUICKSTART)
    assert abs(port["recall"] - ref["recall"]) <= 0.01, (port, ref)
    assert abs(port["rde"] - ref["rde"]) <= 0.05 * ref["rde"], (port, ref)
    assert abs(port["comps"] - ref["comps"]) <= 0.02 * ref["comps"], \
        (port, ref)
    assert abs(port["certified"] - ref["certified"]) <= 2, (port, ref)
    assert abs(port["delta"] - ref["delta"]) <= 0.002, (port, ref)


SERVE = {
    "batches": r"served 300 requests in (\d+) batches",
    "recall": r"batches → recall@10=(\d\.\d+)",
    "sharded": r"4-shard sharded index recall@10 = (\d\.\d+)",
}


def test_vector_serve_equals_reference(outputs):
    """With the reference's rotation: the same number of served batches,
    and the served and the 4-shard recall@10 each within 0.01 of the
    reference's (30 of the 3,000 neighbours)."""
    ref = _numbers(outputs, "vector_serve", SERVE)
    port = _numbers(outputs, "torch_vector_serve", SERVE)
    assert port["batches"] == ref["batches"], (port, ref)
    assert abs(port["recall"] - ref["recall"]) <= 0.01, (port, ref)
    assert abs(port["sharded"] - ref["sharded"]) <= 0.01, (port, ref)
