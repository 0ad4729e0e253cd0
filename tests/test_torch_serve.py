"""The slice as a whole: the port's δ-EMQG build, ``AnnServer`` and
``launch.serve`` against the JAX package's, plus the port's rules
(no ``jax``/``repro`` imports; no silent CPU fallback).

Whole-build parity is ≥ 95% identical neighbor rows and the same mean
degree, not 100%: the kNN bootstrap's norm-identity matmul sums in another
order in the two frameworks, and a last-bit difference can swap two
near-tied neighbors, which the refinement then carries on.
"""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.core import BuildParams as RefBuildParams
from repro.core import SearchParams as RefSearchParams
from repro.core import build_emqg as ref_build_emqg
from repro.obs import MetricsRegistry as RefRegistry
from repro.serve import AnnServer as RefAnnServer

from repro_torch.core import BuildParams, SearchParams, build_approx, build_emqg
from repro_torch.core import baselines, build_exact
from repro_torch.core.mips import build_mips
from repro_torch.interop import index_from_numpy
from repro_torch.launch import serve as port_serve
from repro_torch.obs import MetricsRegistry
from repro_torch.checkpoint import restore_latest
from repro_torch.core.updates import JournaledLiveIndex, as_live, recover
from repro_torch.serve import AnnServer, ResilientAnnServer

from conftest import gmm
from test_torch_search import to_port

# several test workers share the host's cores; one intra-op thread each
# keeps them from oversubscribing it
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
BP = dict(max_degree=12, beam_width=24, t=12, iters=2, block=512,
          align_degree=True)


@pytest.fixture(scope="module")
def built():
    base = gmm(900, 16, 10, seed=31)
    ref = ref_build_emqg(base, RefBuildParams(**BP), key=jax.random.PRNGKey(5))
    port = build_emqg(base, BuildParams(**BP),
                      rotation=np.asarray(ref.codes.rotation), device="cpu")
    return base, ref, port


def test_build_emqg_matches_reference(built):
    _, ref, port = built
    r_nbr = np.asarray(ref.graph.neighbors)
    t_nbr = port.graph.neighbors.numpy()
    same_rows = (r_nbr == t_nbr).all(1).mean()
    assert same_rows >= 0.95, same_rows
    assert port.graph.medoid == int(ref.graph.medoid)
    assert port.graph.kind == ref.graph.kind == "delta_emqg"
    assert float(port.graph.degrees().float().mean()) == \
        float(np.asarray(ref.graph.degrees()).mean())
    np.testing.assert_array_equal(port.codes.codes.numpy().view(np.uint32),
                                  np.asarray(ref.codes.codes))


def test_ann_server_matches_reference(built):
    """Same index, same request stream: per-request ids and dists, the
    ServeStats counts and the search counters agree request for request."""
    base, ref, _ = built
    port = to_port(ref)
    queries = gmm(40, 16, 10, seed=32)
    kw = dict(k=10, l0=10, l_max=64, alpha=1.2, adaptive=True, max_hops=512)
    r_reg, t_reg = RefRegistry(), MetricsRegistry()
    r_srv = RefAnnServer(ref, RefSearchParams(**kw), max_batch=16,
                         buckets=(8, 16), backend="jnp", metrics=r_reg)
    t_srv = AnnServer(port, SearchParams(**kw), max_batch=16, buckets=(8, 16),
                      backend="jnp", metrics=t_reg, device="cpu")
    r_srv.submit_many(queries)
    t_srv.submit_many(queries)
    r_out, t_out = r_srv.drain(), t_srv.drain()
    assert len(t_out) == len(r_out) == 40
    for (ri, rd), (ti, td) in zip(r_out, t_out):
        np.testing.assert_array_equal(ti, np.asarray(ri))
        np.testing.assert_allclose(td, np.asarray(rd), rtol=1e-4, atol=1e-4)
    assert (t_srv.stats.n_requests, t_srv.stats.n_batches) == \
        (r_srv.stats.n_requests, r_srv.stats.n_batches) == (40, 3)
    for name in ("search_dist_comps_total", "search_approx_comps_total",
                 "search_hops_total", "search_encounters_total",
                 "search_saturated_total"):
        assert t_reg.counter(name).value == r_reg.counter(name).value, name


def test_launch_serve_runs_on_cpu(capsys):
    assert port_serve.main(["--n", "500", "--dim", "16", "--queries", "40",
                            "--beam", "24", "--max-degree", "12",
                            "--device", "cpu", "--metrics"]) == 0
    out = capsys.readouterr().out
    assert "recall@10=" in out and "search_hops_total" in out


@pytest.mark.parametrize("flag", [["--shards", "2"]])
def test_launch_serve_refuses_unported_modes(flag):
    with pytest.raises(SystemExit) as exc:
        port_serve.main(["--device", "cpu", *flag])
    assert exc.value.code == 2


@pytest.mark.parametrize("flags,stdout,stderr", [
    (["--audit"], "[audit] OK", ""),
    (["--resilient", "--deadline-ms", "60000", "--max-queue", "64",
      "--degrade-at", "16", "--recover-at", "4", "--rungs", "3"],
     "[serve] resilience: shed=0 rejected=0 degraded=40", ""),
    (["--metrics-every", "0.1"], "search_hops_total", "[obs] req=40")],
    ids=["audit", "resilient", "metrics-every"])
def test_launch_serve_runs_ported_modes(capsys, flags, stdout, stderr):
    """The reference CLI's single-node modes run on the CPU: the auditor
    before serving, the resilience layer with its five knobs (40 queued
    requests over a degrade depth of 16: one batch, served at rung 1), and
    the periodic stderr summary."""
    assert port_serve.main(["--n", "400", "--dim", "16", "--queries", "40",
                            "--beam", "24", "--max-degree", "12",
                            "--device", "cpu", *flags]) == 0
    out = capsys.readouterr()
    assert stdout in out.out and stderr in out.err


def _journal(graph) -> str:
    """A journal directory holding ``graph`` (written on the CPU)."""
    import tempfile

    d = tempfile.mkdtemp(prefix="journal_")
    JournaledLiveIndex.create(as_live(graph), d)
    return d


def test_entry_points_raise_without_a_card(monkeypatch):
    """No entry point drops to the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    base = gmm(64, 8, 4, seed=0)
    with pytest.raises(RuntimeError, match="cuda"):
        build_approx(base, BuildParams(max_degree=4, beam_width=8, iters=1))
    with pytest.raises(RuntimeError, match="cuda"):
        build_emqg(base, BuildParams(max_degree=4, beam_width=8, iters=1))
    with pytest.raises(RuntimeError, match="cuda"):
        build_exact(base)
    for name, builder in baselines.BUILDERS.items():
        with pytest.raises(RuntimeError, match="cuda"):
            builder(base)
    with pytest.raises(RuntimeError, match="cuda"):
        build_mips(base, BuildParams(max_degree=4, beam_width=8, iters=1))
    with pytest.raises(RuntimeError, match="cuda"):
        index_from_numpy(base, np.zeros((64, 4), np.int32), 0)
    g = index_from_numpy(base, np.zeros((64, 4), np.int32), 0, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        AnnServer(g, SearchParams())
    with pytest.raises(RuntimeError, match="cuda"):
        port_serve.main(["--n", "64", "--dim", "8"])
    with pytest.raises(RuntimeError, match="cuda"):
        ResilientAnnServer(g, SearchParams())
    with pytest.raises(RuntimeError, match="cuda"):
        restore_latest("no-such-directory", {"x": np.zeros(1)})
    with pytest.raises(RuntimeError, match="cuda"):
        recover(_journal(g))


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{f}: imports {mod}"
