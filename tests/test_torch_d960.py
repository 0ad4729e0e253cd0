"""GIST1M's width, d = 960, through the port at a CPU size: the widths no
d ≤ 256 path reaches — RaBitQ codes of W = 30 words (three full chunks of
8 and a last of 6 in the kernels' row body), the exact tier past the
register kernels' d = 256 — against the JAX package on a reference-built
index, and ``launch.steps.ann_serve`` against a plain float64 exact
search (no JAX), as the benchmark's ``synth-d960.batch`` cell serves it.
"""

import dataclasses
import json
import math
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.core import BuildParams as RefBuildParams
from repro.core import SearchParams as RefSearchParams
from repro.core import build_emqg as ref_build_emqg
from repro.core import probing_search as ref_probing

from repro_torch.core import BuildParams, SearchParams, build_emqg
from repro_torch.core import probing_search
from repro_torch.core.distributed import build_sharded
from repro_torch.kernels.bitdot import ref as bitdot_ref
from repro_torch.launch import steps

from test_torch_configs import COUNTERS, assert_block_free
from test_torch_search import to_port

torch.set_num_threads(1)

D = 960
N = 768
W = math.ceil(D / 32)                     # 30 code words
BUILD = dict(max_degree=16, beam_width=32, t=8, iters=2, align_degree=True)
CELL = json.loads((Path(__file__).resolve().parents[1] / "perfbench" /
                   "configs" / "synth-d960.json").read_text())
# recall@10 of the served top 10 at N_SERVE, over the exact float64 top 10,
# at the cell's search parameters: the corpus lies near 21-dimensional
# subspaces (the cell's law), where a search of l_max 512 over 1,024 points
# on the M = 16 graph reads 0.97 (31 of 32 queries whole); the floor leaves
# two more queries' misses of room.  Isotropic points at d = 960 read far
# lower and would test nothing
N_SERVE = 1024
RECALL_FLOOR = 0.9


def subspace_corpus(n: int, seed: int, clusters: int = 8, rank: int = 21,
                    noise: float = 0.05) -> np.ndarray:
    """float32 [n, D]: clusters, each a random ``rank``-dimensional
    subspace through its centre, with isotropic noise (the benchmark
    cell's law, drawn here with numpy)."""
    law = np.random.default_rng(1234)
    centres = law.normal(0, 0.12, (clusters, D))
    bases = law.normal(0, D ** -0.5, (clusters, D, rank))
    rng = np.random.default_rng(seed)
    c = rng.integers(0, clusters, n)
    z = rng.normal(0, 1, (n, rank))
    x = centres[c] + np.einsum("ndr,nr->nd", bases[c], z) \
        + rng.normal(0, noise, (n, D))
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def wide():
    base = subspace_corpus(N, seed=0)
    queries = subspace_corpus(24, seed=1)
    ref = ref_build_emqg(base, RefBuildParams(**BUILD),
                         key=jax.random.PRNGKey(0))
    port = build_emqg(base, BuildParams(**BUILD),
                      rotation=np.asarray(ref.codes.rotation), device="cpu")
    search = dict(k=10, l0=10, l_max=64, alpha=1.2, adaptive=True,
                  max_hops=512)
    return dict(base=base, queries=queries, ref=ref, port=port,
                rsearch=RefSearchParams(**search),
                search=SearchParams(**search))


def test_codes_at_w30_match_reference_bit_for_bit(wide):
    ref, port = wide["ref"], wide["port"]
    assert port.codes.codes.shape == (N, W)
    np.testing.assert_array_equal(port.codes.codes.numpy().view(np.uint32),
                                  np.asarray(ref.codes.codes))
    # and the reference's index carried across holds the same words
    assert torch.equal(to_port(ref).codes.codes, port.codes.codes)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_probing_parity_at_d960(wide, use_kernel):
    """The W = 1 parity bar on the reference's index carried across: ids
    identical, dists to 1e-4, every counter identical."""
    idx = to_port(wide["ref"])
    q = wide["queries"]
    r = ref_probing(wide["ref"], jnp.asarray(q), wide["rsearch"],
                    use_kernel=use_kernel, backend="jnp")
    t = probing_search(idx, q, wide["search"], use_kernel=use_kernel,
                       backend="jnp")
    np.testing.assert_array_equal(t.ids.numpy(), np.asarray(r.ids))
    np.testing.assert_allclose(t.dists.numpy(), np.asarray(r.dists),
                               rtol=1e-4, atol=1e-4)
    for name in COUNTERS:
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(r, name)),
                                      err_msg=name)


def test_build_does_not_depend_on_block_at_d960(wide):
    assert_block_free(BuildParams(**BUILD), wide["base"], wide["port"],
                      rotation=np.asarray(wide["ref"].codes.rotation))


def test_ann_serve_at_d960_against_float64_exact():
    """The cell's serve call (one shard, its search parameters) on seeded
    data: every row valid, each distance the float64
    distance of its id to the cell's ``dist_err`` limit, recall@10 over the
    floor."""
    base = subspace_corpus(N_SERVE, seed=2)
    queries = torch.from_numpy(subspace_corpus(32, seed=3))
    sidx = build_sharded(base, 1, BuildParams(**BUILD), quantized=True,
                         seed=0, device="cpu")
    search = SearchParams(**CELL["search"])
    arch = types.SimpleNamespace(id="synth-d960", family="ann",
                                 model_cfg={"dim": D, "search": search})
    shape = types.SimpleNamespace(kind="ann_serve", name="serve", dims={})
    ids, dists = steps.ann_serve(arch, shape, sidx)(queries)
    k = CELL["search"]["k"]
    assert ids.shape == (32, k)
    x, q = torch.from_numpy(base).double(), queries.double()
    full = torch.cdist(q, x)
    exact = torch.sort(full, dim=1, stable=True)
    exact_ids, kth = exact.indices[:, :k], exact.values[:, k - 1:k]
    idl = ids.long()
    assert bool(((idl >= 0) & (idl < N_SERVE)).all())
    assert all(len(set(row.tolist())) == k for row in idl)
    assert bool(torch.isfinite(dists).all())
    assert bool((dists[:, 1:] >= dists[:, :-1]).all())
    gap = (dists.double() - full.gather(1, idl)).abs() / kth
    assert float(gap.max()) <= CELL["limits"]["dist_err"], float(gap.max())
    hits = (idl[:, :, None] == exact_ids[:, None, :]).any(1).sum()
    recall = int(hits) / (32 * k)
    assert recall >= RECALL_FLOOR, recall


def test_s_plus_kernel_order_at_w30_is_the_float64_sum():
    """S₊ at W = 30 as the kernels sum it (``rabitq_rows.cuh``: three full
    chunks in its loop, then the last 6 words) against the float64 sum of
    the query over the set bits: each lane adds ≤ 30 terms and the
    butterfly 5 more, so float32 is off by at most 35 · 2⁻²⁴ of Σ|q|."""
    g = torch.Generator().manual_seed(9)
    B, K = 6, 40
    codes = torch.randint(-2 ** 31, 2 ** 31 - 1, (B, K, W), generator=g,
                          dtype=torch.int32)
    q = torch.randn((B, D), generator=g)
    got = bitdot_ref.s_plus_kernel_order(codes, q)
    shifts = torch.arange(32, dtype=torch.int32)
    bits = ((codes[..., None] >> shifts) & 1).reshape(B, K, 32 * W)[..., :D]
    want = (bits.double() * q.double()[:, None, :]).sum(-1)
    tol = 35 * 2.0 ** -24 * q.double().abs().sum(1, keepdim=True)
    assert bool(((got.double() - want).abs() <= tol).all())
