"""The port's CUDA kernels and its engines on the card (marker ``cuda``).

These need an NVIDIA card and skip without one: a CUDA kernel has no CPU
mode.  The file imports neither ``jax`` nor the JAX package, so it runs on
a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same card
tensors: gather-L2 to rtol 1e-5 / atol 1e-5 (the same float32 squares
summed in another order), bitdot to rtol 1e-5 / atol 1e-4 (the JAX
kernel test's tolerance).  The engines on the card must give the ids of
their plain paths on ≥ 99% of queries (float sum order can swap a tie).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import BuildParams, SearchParams, build_emqg
from repro_torch.core import probing_search, search
from repro_torch.data import clustered_vectors
from repro_torch.kernels.bitdot import ops as bitdot_ops
from repro_torch.kernels.bitdot import ref as bitdot_ref
from repro_torch.kernels.l2dist import ops as l2ops
from repro_torch.kernels.l2dist import ref as l2ref

L2_SHAPES = [(2, 16, 24), (4, 32, 128), (1, 7, 65)]
BITDOT_SHAPES = [(8, 32), (100, 100), (300, 128), (17, 257)]


def _l2_inputs(B, M, d, seed=7, n=200):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(n, d)).astype(np.float32)
    ids = rng.integers(0, n, (B, M)).astype(np.int32)
    ids[0, 0] = -1
    ids[-1, M // 2] = -1
    qs = rng.normal(size=(B, d)).astype(np.float32)
    return base, ids, qs


def _codes(m, d, seed):
    rng = np.random.default_rng(seed)
    W = (d + 31) // 32
    codes = rng.integers(0, 2**32, (m, W), dtype=np.uint64).astype(np.uint32)
    return codes, rng.normal(size=(d,)).astype(np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gather_l2", "gather_l2_tiled"])
@pytest.mark.parametrize("B,M,d", L2_SHAPES + [(3, 17, 33)])
def test_gather_l2_kernel_on_card(cuda, name, B, M, d):
    base, ids, qs = (torch.from_numpy(x).to(cuda) for x in _l2_inputs(B, M, d))
    before = l2ops.LAUNCHES[name]
    out = getattr(l2ops, name)(base, ids, qs)
    torch.cuda.synchronize()
    assert l2ops.LAUNCHES[name] == before + 1
    expect = l2ref.gather_l2_ref(base, ids, qs)
    assert torch.isinf(out[ids < 0]).all()
    torch.testing.assert_close(out, expect, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("m,d", BITDOT_SHAPES)
def test_bitdot_kernel_on_card(cuda, m, d):
    codes, q = _codes(m, d, seed=m + d)
    c = torch.from_numpy(codes.view(np.int32)).to(cuda)[None].repeat(3, 1, 1)
    qs = torch.from_numpy(q).to(cuda)[None].repeat(3, 1)
    before = bitdot_ops.LAUNCHES["bitdot"]
    out = bitdot_ops.bitdot(c, qs)
    torch.cuda.synchronize()
    assert bitdot_ops.LAUNCHES["bitdot"] == before + 1
    torch.testing.assert_close(out, bitdot_ref.bitdot_ref(c, qs),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_engines_on_card_match_their_plain_paths(cuda):
    base = clustered_vectors(3000, 32, 16, seed=0)
    queries = clustered_vectors(64, 32, 16, seed=1)
    idx = build_emqg(base, BuildParams(max_degree=12, beam_width=24, t=12,
                                       iters=2, block=512),
                     generator=torch.Generator().manual_seed(0), device=cuda)
    p = SearchParams(k=10, l0=10, l_max=64, alpha=1.2, adaptive=True,
                     max_hops=512)
    plain = search(idx.graph, queries, p, backend="jnp")
    for backend in ("auto", "kernel", "kernel_tiled"):
        res = search(idx.graph, queries, p, backend=backend)
        agree = (res.ids == plain.ids).all(1).float().mean().item()
        assert agree >= 0.99, (backend, agree)
    before = bitdot_ops.LAUNCHES["bitdot"]
    kern = probing_search(idx, queries, p, use_kernel=True)
    assert bitdot_ops.LAUNCHES["bitdot"] > before
    plain = probing_search(idx, queries, p, use_kernel=False, backend="jnp")
    assert (kern.ids == plain.ids).all(1).float().mean().item() >= 0.99
