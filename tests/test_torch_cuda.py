"""The port's CUDA kernels and its engines on the card (marker ``cuda``).

These need an NVIDIA card and skip without one: a CUDA kernel has no CPU
mode.  The file imports neither ``jax`` nor the JAX package, so it runs on
a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same card
tensors: gather-L2 to rtol 1e-5 / atol 1e-5 (the same float32 squares
summed in another order), bitdot to rtol 1e-5 / atol 1e-4 (the JAX
kernel test's tolerance), fused_estimate to rtol 1e-4 / atol 1e-3 (the JAX
fused-estimate test's tolerance; the kernel sums S₊ over set bits, the
plain version over ±1 signs), and both to the bit against plain versions
that sum and round in the kernels' order (``ref.s_plus_kernel_order``,
``ref.fused_estimate_kernel_order``), batched_l2 to rtol 1e-5 / atol 1e-4 in f32
(and the same on bf16 inputs, which both cast to f32 first).  The engines
on the card must give the ids of their plain paths on ≥ 99% of queries
(float sum order can swap a tie).  The flash-attention kernel is held
against the full-matrix plain version to rtol/atol 2e-5 in f32 (the same
f32 math in another order; the JAX kernel test's tolerance); its bf16
tensor-core kernel against the plain version in f32 on the same values, to
half a bf16 ulp of each value plus 2^-12 of its row's RMS
(``ref.err_ratio``: the kernel keeps p to ~16 bits as two bf16 terms and
its sums in f32, and rounds only its output), and its two wgmma products
on one tile against the same products in f32 (rtol/atol 1e-5).  Live
updates on the card launch the L2 kernels and recover from their journal
to the same bits; the resilient server at rung 0 gives ``AnnServer``'s
results exactly, with no retry and no fallback, and a failing kernel tier
fails its batch instead of falling back to the plain version.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import BuildParams, SearchParams, build_emqg
from repro_torch.core import ags_search, build_exact, probing_search, search
from repro_torch.core import rabitq, theorem4_delta_prime
from repro_torch import data as port_data
from repro_torch.data import clustered_vectors
from repro_torch.kernels import _build
from repro_torch.kernels.bitdot import ops as bitdot_ops
from repro_torch.kernels.bitdot import ref as bitdot_ref
from repro_torch.kernels.flashattn import ops as flash_ops
from repro_torch.kernels.flashattn import ref as flash_ref
from repro_torch.kernels.l2dist import ops as l2ops
from repro_torch.kernels.l2dist import ref as l2ref
from repro_torch.configs import get_arch
from repro_torch.models import common
from repro_torch.models import transformer as tf
from repro_torch.core.updates import JournaledLiveIndex, as_live, recover
from repro_torch.core.verify import audit_live
from repro_torch.serve import AnnServer, ResilienceConfig, ResilientAnnServer
from repro_torch.serve import generate
from repro_torch.testing import FaultPlan, inject_search_faults

# the build's [block, M] at d = 128 and MIPS's ragged d + 1 = 129, cut in B
L2_SHAPES = [(2, 16, 24), (4, 32, 128), (1, 7, 65), (8, 24, 128), (2, 24, 129)]
# W = 1, 4, 4, 9 and 10 (past the kernels' 8-word chunk), d off 32's multiples
BITDOT_SHAPES = [(9, 16), (8, 32), (100, 100), (300, 128), (17, 257), (40, 300)]
# W = 1, 4, 5 (one bit in the last), 7, 9 and 10
ESTIMATE_DIMS = [16, 128, 129, 200, 257, 300]
BATCHED_L2_SHAPES = [(1, 8, 16), (4, 24, 100), (3, 17, 33), (4, 25, 128),
                     (4, 25, 129)]
# (B, S, H, KV, causal, window): one row, a ragged tile, bidirectional,
# GQA, windows inside and across tiles, and S past a 64-row tile at 4,097
FLASH_CASES = [(1, 1, 2, 1, True, None), (2, 100, 6, 3, True, None),
               (1, 100, 4, 4, False, None), (1, 130, 4, 2, True, 7),
               (1, 4097, 2, 1, True, None), (1, 4097, 4, 2, True, 300),
               (1, 4097, 2, 2, False, None)]
# and for the bf16 tensor-core kernel (128-row query tiles, 128-key tiles
# at hd <= 64 and 64-key tiles above): S past one query or key tile, windows
# 1, 63, 64, 65 and 129 across tile edges, GQA groups 1, 3 and 4, B = 2,
# non-causal with and without a window
FLASH_BF16_CASES = [(2, 300, 4, 4, True, 1), (1, 257, 6, 2, True, 63),
                    (1, 257, 8, 2, True, 64), (2, 385, 3, 1, True, 65),
                    (1, 1000, 4, 1, True, 129), (1, 129, 4, 1, True, None),
                    (2, 200, 4, 4, False, None), (1, 333, 6, 2, False, 65)]
# the bf16 prefill of the smoke config against plain attention: chip_smoke's
# bound on the full-width model's logits (LM_LOGIT_TOL)
LM_LOGIT_TOL = 0.2


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


def _estimate_inputs(B, K, d, n=300, seed=0):
    """A code table, its scalars, ids with invalid slots, and a batched
    query context (q, Σq, ‖q − c‖) as numpy arrays."""
    codes, _ = _codes(n, d, seed)
    rng = np.random.default_rng(seed + 1)
    norms = (0.5 + np.abs(rng.normal(size=n))).astype(np.float32)
    ip_xo = (0.5 + 0.4 * rng.random(n)).astype(np.float32)
    ids = rng.integers(0, n, (B, K)).astype(np.int32)
    ids[0, 0] = -1
    ids[-1, K // 2:] = -1
    q = rng.normal(size=(B, d)).astype(np.float32)
    norm_q = (1.0 + rng.random(B)).astype(np.float32)
    return codes, norms, ip_xo, ids, q, norm_q


def _estimate_args(inputs, device):
    """fused_estimate's tensor arguments on ``device`` (codes as the int32
    view, Σq from q, √d from d)."""
    codes, norms, ip_xo, ids, q, norm_q = inputs
    t = [torch.from_numpy(x).to(device) for x in
         (codes.view(np.int32), norms, ip_xo, ids, q)]
    sum_q = t[4].sum(-1)
    sqrt_d = torch.tensor(float(q.shape[1]), device=device).sqrt()
    return (*t, sum_q, torch.from_numpy(norm_q).to(device), sqrt_d)


def _batched_l2_inputs(B, M, d, dtype=torch.float32, seed=None):
    rng = np.random.default_rng(B * 1000 + M + d if seed is None else seed)
    rows = rng.normal(size=(B, M, d)).astype(np.float32)
    qs = rng.normal(size=(B, d)).astype(np.float32)
    return (torch.from_numpy(rows).to(dtype), torch.from_numpy(qs).to(dtype))


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
@pytest.mark.parametrize("d", ESTIMATE_DIMS)
def test_fused_estimate_kernel_on_card(cuda, d):
    args = _estimate_args(_estimate_inputs(5, 70, d, seed=d), cuda)
    ids = args[3]
    before = bitdot_ops.LAUNCHES["fused_estimate"]
    out = bitdot_ops.fused_estimate(*args)
    torch.cuda.synchronize()
    assert bitdot_ops.LAUNCHES["fused_estimate"] == before + 1
    assert torch.isinf(out[ids < 0]).all()
    torch.testing.assert_close(out, bitdot_ref.fused_estimate_ref(*args),
                               rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("d", ESTIMATE_DIMS)
def test_rabitq_kernels_sum_in_the_kernel_order(cuda, d):
    """bitdot (q unpadded, d < 32·W where d is off 32's multiples) and
    fused_estimate equal their kernel-order plain versions to the bit; +inf
    at ids < 0 and NaN at ids ≥ n."""
    codes, q = _codes(96, d, seed=d)
    c = torch.from_numpy(codes.view(np.int32)).to(cuda).view(4, 24, -1)
    qs = torch.from_numpy(np.stack([q, -q, 2 * q, q[::-1].copy()])).to(cuda)
    got = bitdot_ops.bitdot(c, qs)
    assert torch.equal(got, bitdot_ref.s_plus_kernel_order(c, qs))
    args = list(_estimate_args(_estimate_inputs(5, 70, d, seed=d), cuda))
    n = args[0].shape[0]
    ids = args[3]
    ids[1, :3] = torch.tensor([n, n + 5, 2**31 - 1])
    out = bitdot_ops.fused_estimate(*args)
    expect = bitdot_ref.fused_estimate_kernel_order(*args)
    assert torch.isinf(out[ids < 0]).all() and torch.isnan(out[ids >= n]).all()
    ok = (ids >= 0) & (ids < n)
    assert torch.equal(out[ok].view(torch.int32), expect[ok].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,M,d", BATCHED_L2_SHAPES + [(2, 25, 128),
                                                         (3, 9, 129)])
def test_batched_l2_kernel_on_card(cuda, B, M, d, dtype):
    rows, qs = (x.to(cuda) for x in _batched_l2_inputs(B, M, d, dtype))
    before = l2ops.LAUNCHES["batched_l2"]
    out = l2ops.batched_l2(rows, qs)
    torch.cuda.synchronize()
    assert l2ops.LAUNCHES["batched_l2"] == before + 1
    torch.testing.assert_close(out, l2ref.batched_l2_ref(rows, qs),
                               rtol=1e-5, atol=1e-4)
    # a query line that is a column slice of a wider tensor (the selector's
    # candidate step) is read in place
    wide = torch.randn((B, 3, d), device=cuda, dtype=dtype)
    out = l2ops.batched_l2(rows, wide[:, 1])
    torch.testing.assert_close(out, l2ref.batched_l2_ref(rows, wide[:, 1]),
                               rtol=1e-5, atol=1e-4)


# the edges of gather_l2_tiled's and batched_l2's kernels: M of one row,
# of the build's 24 and 25 (odd: a warp's last group is one row), and 33;
# B of one line, a few, and the build's block of 1024
EDGE_M = [1, 24, 25, 33]
EDGE_B = [1, 3, 1024]
TILED_KERNELS = ["gather_l2_rows", "gather_l2_ragged", "gather_l2_blocks"]
ONE_ROW_KERNELS = ["gather_l2_row1", "gather_l2_ragged1", "gather_l2_blocks"]
# the ragged-d register kernels' widths: MIPS's d + 1, one column past a
# lane's fourth, and the widest they take (K = 5, 5, 7, 8 columns a lane)
RAGGED_D = [129, 130, 200, 256]


def _gather_edge_inputs(cuda, B, M, d, n=3000, base_off=0, q_off=0, seed=0):
    """base f32[n, d] and queries f32[B, d] on the card, each a contiguous
    view ``*_off`` elements into a flat buffer (1: not 16-byte aligned), and
    ids with slots of -1 and of ids >= n."""
    rng = np.random.default_rng(seed)
    flat = torch.from_numpy(rng.normal(size=n * d + base_off).astype(np.float32))
    base = flat.to(cuda)[base_off:].view(n, d)
    flat = torch.from_numpy(rng.normal(size=B * d + q_off).astype(np.float32))
    queries = flat.to(cuda)[q_off:].view(B, d)
    ids = rng.integers(0, n, (B, M)).astype(np.int32)
    ids.reshape(-1)[::7] = -1
    ids.reshape(-1)[3::11] = n + 5
    return base, torch.from_numpy(ids).to(cuda), queries


def _check_gather(base, ids, queries, out):
    """+inf at ids < 0, NaN at ids >= n, the plain version elsewhere."""
    n = base.shape[0]
    assert torch.isinf(out[ids < 0]).all() and (out[ids < 0] > 0).all()
    assert torch.isnan(out[ids >= n]).all()
    ok = (ids >= 0) & (ids < n)
    expect = l2ref.gather_l2_ref(base, torch.where(ok, ids, -1), queries)
    torch.testing.assert_close(out[ok], expect[ok], rtol=1e-5, atol=1e-4)


def _launched(name, kernel, call):
    """call() → its result, asserting it launched the entry point ``name``
    and its ``kernel`` once each."""
    before = (l2ops.LAUNCHES[name], l2ops.KERNEL_LAUNCHES[kernel])
    out = call()
    torch.cuda.synchronize()
    assert (l2ops.LAUNCHES[name], l2ops.KERNEL_LAUNCHES[kernel]) == \
        (before[0] + 1, before[1] + 1)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", TILED_KERNELS)
@pytest.mark.parametrize("B", EDGE_B)
@pytest.mark.parametrize("M", EDGE_M)
def test_gather_l2_tiled_kernels_on_card(cuda, monkeypatch, kernel, B, M):
    """Each of gather_l2_tiled's kernels, forced, at every edge shape."""
    base, ids, queries = _gather_edge_inputs(cuda, B, M, 128, seed=B + M)
    monkeypatch.setattr(l2ops, "tiled_kernel", lambda *a: kernel)
    out = _launched("gather_l2_tiled", kernel,
                    lambda: l2ops.gather_l2_tiled(base, ids, queries))
    _check_gather(base, ids, queries, out)


@pytest.mark.cuda
@pytest.mark.parametrize("d", RAGGED_D)
@pytest.mark.parametrize("B", EDGE_B)
@pytest.mark.parametrize("M", EDGE_M)
def test_gather_l2_ragged_on_card(cuda, d, B, M):
    """The ragged-d kernel, as the wrapper picks it, at every edge shape and
    width; base read in place."""
    base, ids, queries = _gather_edge_inputs(cuda, B, M, d, seed=B + M + d)
    assert l2ops.tiled_kernel(base, queries) == "gather_l2_ragged"
    ptr = base.data_ptr()
    out = _launched("gather_l2_tiled", "gather_l2_ragged",
                    lambda: l2ops.gather_l2_tiled(base, ids, queries))
    assert base.data_ptr() == ptr
    _check_gather(base, ids, queries, out)


@pytest.mark.cuda
@pytest.mark.parametrize("d,base_off,q_off", [(129, 1, 0), (129, 3, 1),
                                              (128, 1, 3), (256, 2, 1)])
def test_gather_l2_ragged_misaligned_on_card(cuda, d, base_off, q_off):
    """Base and query views at every 4-byte offset from 16-byte alignment."""
    base, ids, queries = _gather_edge_inputs(cuda, 1024, 24, d, n=2000,
                                             base_off=base_off, q_off=q_off)
    out = _launched("gather_l2_tiled", "gather_l2_ragged",
                    lambda: l2ops.gather_l2_tiled(base, ids, queries))
    _check_gather(base, ids, queries, out)


@pytest.mark.cuda
@pytest.mark.parametrize("base_off", [0, 1])
def test_gather_l2_ragged_equals_blocks_bitwise(cuda, monkeypatch, base_off):
    """At d = 129 the ragged kernel sums each row's terms in the block
    kernel's order and pairs: the same floats to the bit, NaN and inf
    slots included."""
    base, ids, queries = _gather_edge_inputs(cuda, 1024, 24, 129, n=2000,
                                             base_off=base_off)
    ragged = _launched("gather_l2_tiled", "gather_l2_ragged",
                       lambda: l2ops.gather_l2_tiled(base, ids, queries))
    monkeypatch.setattr(l2ops, "tiled_kernel", lambda *a: "gather_l2_blocks")
    blocks = _launched("gather_l2_tiled", "gather_l2_blocks",
                       lambda: l2ops.gather_l2_tiled(base, ids, queries))
    assert torch.equal(ragged.view(torch.int32), blocks.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [4, 64])
def test_gather_l2_rows_widths_on_card(cuda, d):
    """The register kernel at one lane and half a warp a row, as the wrapper
    picks it."""
    base, ids, queries = _gather_edge_inputs(cuda, 33, 25, d, n=2000)
    assert l2ops.tiled_kernel(base, queries) == "gather_l2_rows"
    out = _launched("gather_l2_tiled", "gather_l2_rows",
                    lambda: l2ops.gather_l2_tiled(base, ids, queries))
    _check_gather(base, ids, queries, out)


@pytest.mark.cuda
@pytest.mark.parametrize("d,base_off,q_off,want", [
    (129, 0, 0, "gather_l2_ragged"),         # MIPS's d + 1
    (128, 1, 0, "gather_l2_ragged"),         # base off 16-byte alignment
    (128, 0, 1, "gather_l2_ragged"),         # query lines off it
    (256, 0, 0, "gather_l2_ragged"),         # the widest scalar row
    (264, 0, 0, "gather_l2_blocks"),         # past it
])
def test_gather_l2_tiled_unaligned_rows_on_card(cuda, d, base_off, q_off,
                                                want):
    """A ragged d, a base or query view off 16-byte alignment, and d past
    the float4 row take the ragged-d kernel, d past 256 the block kernel;
    base read in place."""
    base, ids, queries = _gather_edge_inputs(cuda, 1024, 24, d, n=2000,
                                             base_off=base_off, q_off=q_off)
    assert l2ops.tiled_kernel(base, queries) == want
    ptr = base.data_ptr()
    out = _launched("gather_l2_tiled", want,
                    lambda: l2ops.gather_l2_tiled(base, ids, queries))
    assert base.data_ptr() == ptr
    _check_gather(base, ids, queries, out)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ONE_ROW_KERNELS)
@pytest.mark.parametrize("B", EDGE_B)
@pytest.mark.parametrize("M", EDGE_M)
def test_gather_l2_kernels_on_card(cuda, monkeypatch, kernel, B, M):
    """Each of gather_l2's one-row kernels, forced, at every edge shape."""
    base, ids, queries = _gather_edge_inputs(cuda, B, M, 128, seed=B + M)
    monkeypatch.setattr(l2ops, "one_row_kernel", lambda *a: kernel)
    out = _launched("gather_l2", kernel,
                    lambda: l2ops.gather_l2(base, ids, queries))
    _check_gather(base, ids, queries, out)


@pytest.mark.cuda
@pytest.mark.parametrize("d", RAGGED_D)
@pytest.mark.parametrize("B", EDGE_B)
@pytest.mark.parametrize("M", EDGE_M)
def test_gather_l2_ragged1_on_card(cuda, d, B, M):
    """gather_l2's ragged-d kernel, as the wrapper picks it, at every edge
    shape and width; base read in place."""
    base, ids, queries = _gather_edge_inputs(cuda, B, M, d, seed=B + M + d)
    assert l2ops.one_row_kernel(base, queries) == "gather_l2_ragged1"
    ptr = base.data_ptr()
    out = _launched("gather_l2", "gather_l2_ragged1",
                    lambda: l2ops.gather_l2(base, ids, queries))
    assert base.data_ptr() == ptr
    _check_gather(base, ids, queries, out)


@pytest.mark.cuda
@pytest.mark.parametrize("d,base_off,q_off,want", [
    (128, 0, 0, "gather_l2_row1"),           # backend="kernel"'s rows
    (64, 0, 0, "gather_l2_row1"),            # half a warp a row
    (4, 0, 0, "gather_l2_row1"),             # one lane a row
    (129, 0, 0, "gather_l2_ragged1"),        # MIPS's d + 1
    (128, 1, 0, "gather_l2_ragged1"),        # base off 16-byte alignment
    (128, 0, 1, "gather_l2_ragged1"),        # query lines off it
    (129, 3, 1, "gather_l2_ragged1"),        # both, at d + 1
    (200, 0, 0, "gather_l2_ragged1"),        # past the float4 row
    (256, 2, 1, "gather_l2_ragged1"),        # the widest scalar row
    (264, 0, 0, "gather_l2_blocks"),         # past it
])
def test_gather_l2_one_row_kernel_choice_on_card(cuda, d, base_off, q_off,
                                                 want):
    """gather_l2 launches the kernel one_row_kernel names, once, and reads
    base in place."""
    base, ids, queries = _gather_edge_inputs(cuda, 1024, 24, d, n=2000,
                                             base_off=base_off, q_off=q_off)
    assert l2ops.one_row_kernel(base, queries) == want
    ptr = base.data_ptr()
    out = _launched("gather_l2", want,
                    lambda: l2ops.gather_l2(base, ids, queries))
    assert base.data_ptr() == ptr
    _check_gather(base, ids, queries, out)


@pytest.mark.cuda
@pytest.mark.parametrize("d,base_off", [(4, 0), (64, 0), (128, 0), (129, 0),
                                        (130, 0), (4, 1), (64, 1), (128, 1),
                                        (129, 1), (200, 1), (256, 1)])
def test_gather_l2_equals_blocks_bitwise(cuda, monkeypatch, d, base_off):
    """gather_l2's register kernels sum each row's terms in the lanes, order,
    roundings and pairs of the block kernel wherever it reads the same terms
    a lane: one float4 (d % 4 == 0, d <= 128, aligned; ``sq_diff`` fuses
    as its compiled sum does) or scalar columns (d % 4 != 0, or a base off
    16-byte alignment, at every d <= 256).  The same floats to the bit, NaN
    and inf slots included.  (On an aligned base at d % 4 == 0 past 128 the
    block kernel reads two float4s a lane, the ragged kernel columns: the
    same terms in another order, held to the plain version by the test
    above.)"""
    base, ids, queries = _gather_edge_inputs(cuda, 1024, 24, d, n=2000,
                                             base_off=base_off)
    want = l2ops.one_row_kernel(base, queries)
    assert want != "gather_l2_blocks"
    one = _launched("gather_l2", want,
                    lambda: l2ops.gather_l2(base, ids, queries))
    monkeypatch.setattr(l2ops, "one_row_kernel", lambda *a: "gather_l2_blocks")
    blocks = _launched("gather_l2", "gather_l2_blocks",
                       lambda: l2ops.gather_l2(base, ids, queries))
    assert torch.equal(one.view(torch.int32), blocks.view(torch.int32))


def _batched_edge_inputs(cuda, B, M, d, rows_off=0, q_cols=None, seed=0):
    """rows f32[B, M, d] (a contiguous view ``rows_off`` elements into a
    flat buffer) and queries f32[B, d], the trailing columns of a
    [B, q_cols] tensor, on the card."""
    rng = np.random.default_rng(seed)
    flat = rng.normal(size=B * M * d + rows_off).astype(np.float32)
    rows = torch.from_numpy(flat).to(cuda)[rows_off:].view(B, M, d)
    q_cols = q_cols or d
    wide = torch.from_numpy(rng.normal(size=(B, q_cols)).astype(np.float32))
    return rows, wide.to(cuda)[:, q_cols - d:]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["batched_l2_rows", "batched_l2_ragged",
                                    "batched_l2_blocks"])
@pytest.mark.parametrize("B,M", [(b, m) for b in EDGE_B for m in EDGE_M]
                         + [(524, 128)])
def test_batched_l2_kernels_on_card(cuda, monkeypatch, kernel, B, M):
    """Each of batched_l2's kernels, forced, at every edge shape and the
    exact build's [524, 128, 128]; query lines strided 3d apart."""
    rows, queries = _batched_edge_inputs(cuda, B, M, 128, q_cols=384,
                                         seed=B + M)
    monkeypatch.setattr(l2ops, "batched_kernel", lambda *a: kernel)
    out = _launched("batched_l2", kernel,
                    lambda: l2ops.batched_l2(rows, queries))
    torch.testing.assert_close(out, l2ref.batched_l2_ref(rows, queries),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("d", RAGGED_D)
@pytest.mark.parametrize("B", EDGE_B)
@pytest.mark.parametrize("M", EDGE_M)
def test_batched_l2_ragged_on_card(cuda, d, B, M):
    """The ragged-d kernel, as the wrapper picks it, at every edge shape and
    width; query lines strided 3d + 1 apart (a column slice, read in
    place)."""
    rows, queries = _batched_edge_inputs(cuda, B, M, d, q_cols=3 * d + 1,
                                         seed=B + M + d)
    assert l2ops.batched_kernel(rows, queries) == "batched_l2_ragged"
    ptr = queries.data_ptr()
    out = _launched("batched_l2", "batched_l2_ragged",
                    lambda: l2ops.batched_l2(rows, queries))
    assert queries.data_ptr() == ptr
    torch.testing.assert_close(out, l2ref.batched_l2_ref(rows, queries),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("d,rows_off,q_cols", [(129, 1, 129), (129, 3, 130),
                                               (128, 2, 130), (200, 1, 601)])
def test_batched_l2_ragged_misaligned_on_card(cuda, d, rows_off, q_cols):
    """Rows at every 4-byte offset from 16-byte alignment, query strides of
    130 and 3d + 1."""
    rows, queries = _batched_edge_inputs(cuda, 1024, 25, d, rows_off, q_cols)
    out = _launched("batched_l2", "batched_l2_ragged",
                    lambda: l2ops.batched_l2(rows, queries))
    torch.testing.assert_close(out, l2ref.batched_l2_ref(rows, queries),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("rows_off,q_cols", [(0, 129), (1, 388)])
def test_batched_l2_ragged_equals_blocks_bitwise(cuda, monkeypatch, rows_off,
                                                q_cols):
    """At d = 129 the ragged kernel's sums are the block kernel's to the
    bit (the same terms in the same order and pairs)."""
    rows, queries = _batched_edge_inputs(cuda, 1024, 25, 129, rows_off, q_cols)
    ragged = _launched("batched_l2", "batched_l2_ragged",
                       lambda: l2ops.batched_l2(rows, queries))
    monkeypatch.setattr(l2ops, "batched_kernel",
                        lambda *a: "batched_l2_blocks")
    blocks = _launched("batched_l2", "batched_l2_blocks",
                       lambda: l2ops.batched_l2(rows, queries))
    assert torch.equal(ragged.view(torch.int32), blocks.view(torch.int32))


@pytest.mark.cuda
def test_forcing_a_kernel_that_refuses_the_shape_raises(cuda, monkeypatch):
    """A kernel launched at a shape it does not take refuses the launch and
    the wrapper raises: the float4 one at d = 129, the ragged one at
    d = 264.  Nothing is counted."""
    rows, queries = _batched_edge_inputs(cuda, 4, 25, 129)
    monkeypatch.setattr(l2ops, "batched_kernel", lambda *a: "batched_l2_rows")
    before = dict(l2ops.KERNEL_LAUNCHES)
    with pytest.raises(RuntimeError):
        l2ops.batched_l2(rows, queries)
    base, ids, queries = _gather_edge_inputs(cuda, 4, 24, 264, n=100)
    monkeypatch.setattr(l2ops, "tiled_kernel", lambda *a: "gather_l2_ragged")
    with pytest.raises(RuntimeError):
        l2ops.gather_l2_tiled(base, ids, queries)
    assert l2ops.KERNEL_LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("d,rows_off,q_cols,want", [
    (128, 0, 384, "batched_l2_rows"),        # a strided, aligned query line
    (64, 0, 192, "batched_l2_rows"),         # half a warp a row
    (256, 0, 512, "batched_l2_ragged"),      # past the float4 row
    (128, 0, 130, "batched_l2_ragged"),      # query stride 130
    (128, 1, 128, "batched_l2_ragged"),      # rows off 16-byte alignment
    (129, 0, 129, "batched_l2_ragged"),      # ragged d
    (129, 0, 388, "batched_l2_ragged"),      # MIPS's d + 1, stride 3d + 1
    (264, 0, 264, "batched_l2_blocks"),      # past the scalar row
])
def test_batched_l2_kernel_choice_on_card(cuda, d, rows_off, q_cols, want):
    rows, queries = _batched_edge_inputs(cuda, 64, 25, d, rows_off, q_cols)
    ptr = queries.data_ptr()
    assert l2ops.batched_kernel(rows, queries) == want
    out = _launched("batched_l2", want,
                    lambda: l2ops.batched_l2(rows, queries))
    assert queries.data_ptr() == ptr
    torch.testing.assert_close(out, l2ref.batched_l2_ref(rows, queries),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_estimate_sqdist_raises_if_the_kernel_cannot_launch(cuda, monkeypatch):
    """A refused launch raises; nothing falls back to the plain version."""
    codes, norms, ip_xo, ids, q, _, _, _ = _estimate_args(
        _estimate_inputs(2, 8, 64), cuda)
    rq = rabitq.RaBitQCodes(codes=codes, norms=norms, ip_xo=ip_xo,
                            rotation=torch.eye(64, device=cuda),
                            center=torch.zeros(64, device=cuda), dim=64)
    ctx = rabitq.prepare_query(rq, q)

    class Refused:
        @staticmethod
        def fused_estimate(*args):
            return 9                    # cudaErrorInvalidConfiguration

    monkeypatch.setattr(_build, "load", lambda name: Refused())
    before = bitdot_ops.LAUNCHES["fused_estimate"]
    with pytest.raises(RuntimeError, match="fused_estimate"):
        rabitq.estimate_sqdist(rq, ctx, ids)
    assert bitdot_ops.LAUNCHES["fused_estimate"] == before


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
    # the default path estimates with fused_estimate; backend="jnp" is plain
    # on both tiers
    for engine in (probing_search, ags_search):
        before = dict(bitdot_ops.LAUNCHES, **l2ops.LAUNCHES)
        plain = engine(idx, queries, p, backend="jnp")
        assert dict(bitdot_ops.LAUNCHES, **l2ops.LAUNCHES) == before
        kern = engine(idx, queries, p)
        assert bitdot_ops.LAUNCHES["fused_estimate"] > \
            before["fused_estimate"]
        assert bitdot_ops.LAUNCHES["bitdot"] == before["bitdot"]
        assert (kern.ids == plain.ids).all(1).float().mean().item() >= 0.99


@pytest.fixture
def card_emqg(cuda):
    bp = BuildParams(max_degree=12, beam_width=24, t=12, iters=2, block=512)
    idx = build_emqg(clustered_vectors(3000, 32, 16, seed=0), bp,
                     generator=torch.Generator().manual_seed(0), device=cuda)
    return idx, bp


@pytest.mark.cuda
def test_live_updates_recover_bit_identically_on_card(card_emqg, tmp_path):
    """Insert / delete / consolidate on the card launch the L2 kernels, and
    recovery from the journal replays them to the same bits."""
    idx, bp = card_emqg
    before = dict(l2ops.LAUNCHES)
    j = JournaledLiveIndex.create(as_live(idx.graph, bp), str(tmp_path))
    j.insert(clustered_vectors(128, 32, 16, seed=2))
    dead = np.setdiff1d(np.arange(0, 3000, 37), [idx.graph.medoid])
    j.delete(dead)
    res = j.search(clustered_vectors(64, 32, 16, seed=1), 10)
    got = res.ids[res.ids >= 0].long()
    assert not bool(j.live.tombstones[got].any())
    j.consolidate()
    j.insert(clustered_vectors(64, 32, 16, seed=3))
    for name in ("gather_l2_tiled", "batched_l2"):
        assert l2ops.LAUNCHES[name] > before[name], name
    j2, info = recover(str(tmp_path), device=idx.device)
    assert info["replayed"] == 4 and j2.seq == 4
    a, b = j.live, j2.live
    assert torch.equal(a.graph.vectors, b.graph.vectors)
    assert torch.equal(a.graph.neighbors, b.graph.neighbors)
    assert torch.equal(a.tombstones, b.tombstones)
    assert a.graph.medoid == b.graph.medoid
    rep = audit_live(j2.live, sample=64)
    assert not [v for v in rep.violations if "unreachable" not in v
                and "monotone" not in v], rep.summary()


@pytest.mark.cuda
def test_resilient_server_on_card_equals_ann_server(card_emqg):
    """Un-faulted, the resilient server serves the kernels' results at rung
    0 with no retry and no fallback; a fault on the kernel tier is retried
    and then fails its batch: on the card no plain tier stands behind the
    kernels."""
    idx, _ = card_emqg
    p = SearchParams(k=10, l0=10, l_max=64, alpha=1.2, adaptive=True,
                     max_hops=512)
    queries = clustered_vectors(96, 32, 16, seed=1)
    plain = AnnServer(idx, p, max_batch=32, buckets=(32,),
                      device=idx.device)
    plain.submit_many(queries)
    want = plain.drain()
    srv = ResilientAnnServer(idx, p, config=ResilienceConfig(
        degrade_depth=1024, backoff_s=0.0, breaker_threshold=1),
        max_batch=32, buckets=(32,), device=idx.device)
    before = bitdot_ops.LAUNCHES["fused_estimate"]
    srv.submit_many(queries)
    got = srv.drain()
    assert bitdot_ops.LAUNCHES["fused_estimate"] > before
    assert all(r.ok and r.rung == 0 and r.tier == "beam/auto" for r in got)
    for r, (ids, dists) in zip(got, want):
        assert np.array_equal(r.ids, ids) and np.array_equal(r.dists, dists)
    assert srv.stats.n_retried == srv.stats.n_fallback == 0
    assert [t.name for t in srv.breaker.tiers] == ["beam/auto"]
    with inject_search_faults(srv, FaultPlan(fail_first=10**6,
                                             match_backend="auto")) as inj:
        srv.submit_many(queries[:32])
        rs = srv.drain()
    assert all(r.status == "failed" and "KernelFault" in r.error for r in rs)
    assert [b for b, _ in inj.tier_log] == ["auto"] * 3
    assert srv.stats.n_fallback == 0 and srv.stats.n_retried == 2


@pytest.mark.cuda
def test_exact_build_and_certificate_on_card(cuda):
    """build_exact launches batched_l2; Theorem 1 holds on the card; the
    Theorem-4 certificate with the kernels equals the plain one."""
    base = clustered_vectors(600, 32, 12, seed=2)
    before = l2ops.LAUNCHES["batched_l2"]
    g = build_exact(base, delta=0.1, device=cuda)
    assert l2ops.LAUNCHES["batched_l2"] > before
    res = search(g, base, SearchParams(k=1, l0=1, l_max=1, adaptive=False,
                                       max_hops=2048))
    assert (res.ids[:, 0].cpu().numpy() == np.arange(600)).all()
    assert (res.dists[:, 0] == 0).all()
    queries = clustered_vectors(64, 32, 12, seed=3)
    p = SearchParams(k=5, l0=5, l_max=64, alpha=2.0, adaptive=True,
                     max_hops=2048)
    out = {}
    for backend in ("auto", "jnp"):
        _, ids, dists = search(g, queries, p, with_candidates=True,
                               backend=backend)
        out[backend] = theorem4_delta_prime(g, queries, ids, dists, k=5,
                                            delta=0.1, backend=backend)
    assert (out["auto"][0] == out["jnp"][0]).float().mean().item() >= 0.99
    both = out["auto"][0] & out["jnp"][0]
    torch.testing.assert_close(out["auto"][1][both], out["jnp"][1][both],
                               rtol=1e-4, atol=0)


def _flash_inputs(B, S, H, KV, hd, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=device).to(dtype)
            for shape in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))]


def _flash_plain(q, k, v, causal, window):
    groups = q.shape[2] // k.shape[2]
    return flash_ref.attention_ref(q, k.repeat_interleave(groups, 2),
                                   v.repeat_interleave(groups, 2),
                                   causal=causal, window=window)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", flash_ops.HEAD_DIMS)
def test_flash_attention_kernel_on_card(cuda, hd, dtype):
    cases = FLASH_CASES + (FLASH_BF16_CASES if dtype == torch.bfloat16 else [])
    for B, S, H, KV, causal, window in cases:
        q, k, v = _flash_inputs(B, S, H, KV, hd, dtype, cuda, seed=S + hd)
        before = flash_ops.LAUNCHES["flash_attention"]
        out = flash_ops.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        assert flash_ops.LAUNCHES["flash_attention"] == before + 1
        assert out.dtype == dtype and out.shape == q.shape
        assert torch.isfinite(out).all()
        if dtype == torch.float32:
            torch.testing.assert_close(
                out, _flash_plain(q, k, v, causal, window),
                rtol=2e-5, atol=2e-5)
        else:
            want = _flash_plain(q.float(), k.float(), v.float(), causal,
                                window)
            ratio = flash_ref.err_ratio(out, want)
            assert ratio <= 1.0, (B, S, H, KV, causal, window, ratio)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", flash_ops.HEAD_DIMS)
def test_flash_sm90_products_match_matmul(cuda, hd):
    """One warpgroup of the tensor-core kernel on one tile each: q kᵀ
    (wgmma, Q and K K-major from 128-byte-swizzled TMA tiles) and
    (p_hi + p_lo) v (P from registers, V an MN-major operand) equal the
    same products in f32 (exact bf16 products, f32 sums in another order:
    rtol/atol 1e-5 of the scale)."""
    bk = flash_ops.sm90_resources(hd)["block_keys"]
    g = torch.Generator(device=cuda).manual_seed(hd)
    q = torch.randn((64, hd), generator=g, device=cuda).bfloat16()
    k = torch.randn((bk, hd), generator=g, device=cuda).bfloat16()
    v = torch.randn((bk, hd), generator=g, device=cuda).bfloat16()
    p = torch.rand((64, bk), generator=g, device=cuda)
    p_hi = p.bfloat16().float()
    p_lo = (p - p_hi).bfloat16().float()
    want_s = q.float() @ k.float().T
    want_o = (p_hi + p_lo) @ v.float()
    s, o = flash_ops.sm90_probe(q, k, v, p)
    torch.testing.assert_close(s, want_s, rtol=1e-5, atol=1e-5 * hd ** 0.5)
    torch.testing.assert_close(o, want_o, rtol=1e-5, atol=1e-5 * bk ** 0.5)


@pytest.mark.cuda
def test_flash_sm90_resources(cuda):
    """The tensor-core kernel's compiled instances: within the register and
    shared-memory limits of one block an SM, and no spills at hd = 64 (the
    LM's)."""
    for hd in flash_ops.HEAD_DIMS:
        res = flash_ops.sm90_resources(hd)
        print(f"hd={hd}: {res}")
        assert 0 < res["registers"] <= 255
        assert res["dynamic_smem_bytes"] + res["static_smem_bytes"] <= 232448
        assert res["max_threads"] >= 384
    assert flash_ops.sm90_resources(64)["local_bytes"] == 0


@pytest.mark.cuda
def test_flash_attention_reads_strided_inputs(cuda):
    """q, k and v as column slices of one fused projection (no copy), and
    a transposed view, give what their contiguous copies give."""
    B, S, H, KV, hd = 2, 300, 6, 2, 64
    fused = torch.randn((B, S, H + 2 * KV, hd), device=cuda,
                        dtype=torch.bfloat16)
    q, k, v = fused.split([H, KV, KV], dim=2)
    assert not q.is_contiguous()
    copies = flash_ops.COPIES["flash_attention"]
    out = flash_ops.flash_attention(q, k, v, window=50)
    assert flash_ops.COPIES["flash_attention"] == copies
    want = flash_ops.flash_attention(q.contiguous(), k.contiguous(),
                                     v.contiguous(), window=50)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    qt = torch.randn((B, H, S, hd), device=cuda).transpose(1, 2)
    kt = torch.randn((B, KV, S, hd), device=cuda).transpose(1, 2)
    torch.testing.assert_close(
        flash_ops.flash_attention(qt, kt, kt),
        _flash_plain(qt, kt, kt, True, None), rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
def test_flash_attention_copies_what_tma_cannot_read(cuda):
    """bf16 inputs no TMA tensor map describes (a last stride of 2, a
    transposed view) are made contiguous, counted once each in COPIES, and
    give what their contiguous copies give."""
    B, S, H, KV, hd = 2, 200, 4, 2, 64
    wide = torch.randn((B, S, H, 2 * hd), device=cuda, dtype=torch.bfloat16)
    q = wide[..., ::2]
    kt = torch.randn((B, KV, S, hd), device=cuda,
                     dtype=torch.bfloat16).transpose(1, 2)
    v = torch.randn((B, S, KV, hd), device=cuda, dtype=torch.bfloat16)
    assert flash_ops.tma_strides(q) is None
    assert flash_ops.tma_strides(kt) is None
    assert flash_ops.tma_strides(v) is not None
    copies = flash_ops.COPIES["flash_attention"]
    out = flash_ops.flash_attention(q, kt, v, window=70)
    assert flash_ops.COPIES["flash_attention"] == copies + 2
    want = flash_ops.flash_attention(q.contiguous(), kt.contiguous(), v,
                                     window=70)
    assert flash_ops.COPIES["flash_attention"] == copies + 2
    torch.testing.assert_close(out, want, rtol=0, atol=0)


@pytest.mark.cuda
def test_flash_attention_refuses_what_the_kernel_does_not_take(cuda,
                                                               monkeypatch):
    """A head_dim with no kernel instance raises rather than running the
    plain version; a refused launch raises and is not counted."""
    q, k, v = _flash_inputs(1, 16, 2, 1, 48, torch.float32, cuda)
    before = flash_ops.LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match="head_dim"):
        flash_ops.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="head_dim"):
        common.flash_attention(q, k, v)

    class Refused:
        @staticmethod
        def flash_attn_fwd(*args):
            return 9                    # cudaErrorInvalidConfiguration

    monkeypatch.setattr(_build, "load", lambda name: Refused())
    q, k, v = _flash_inputs(1, 16, 2, 1, 64, torch.float32, cuda)
    with pytest.raises(RuntimeError, match="flash_attention"):
        flash_ops.flash_attention(q, k, v)
    assert flash_ops.LAUNCHES["flash_attention"] == before


@pytest.mark.cuda
def test_lm_on_card_launches_the_kernel(cuda):
    """prefill launches the kernel once a layer and agrees with its plain
    path; stepping the prompt through decode_step gives prefill's logits;
    greedy generate runs on the card."""
    cfg = get_arch("smollm-135m").smoke_cfg
    params = tf.init(cfg, torch.Generator(device=cuda).manual_seed(0),
                     device=cuda)
    lm = port_data.make_markov_lm(cfg.vocab, seed=0)
    toks = torch.from_numpy(port_data.lm_batch(lm, 2, 40, step=0)[0]).to(cuda)
    before = flash_ops.LAUNCHES["flash_attention"]
    kern = tf.prefill(cfg, params, toks)
    assert flash_ops.LAUNCHES["flash_attention"] == before + cfg.n_layers
    plain = tf.prefill(cfg, params, toks, backend="jnp")
    assert flash_ops.LAUNCHES["flash_attention"] == before + cfg.n_layers
    torch.testing.assert_close(kern, plain, rtol=1e-4, atol=1e-4)
    cache = tf.init_cache(cfg, 2, 64, device=cuda)
    for t in range(toks.shape[1]):
        logits, cache = tf.decode_step(cfg, params, cache, toks[:, t])
    torch.testing.assert_close(logits, kern, rtol=1e-4, atol=1e-4)
    out = generate(cfg, params, toks, max_new=5, max_seq=64)
    assert out.shape == (2, 45) and (out[:, :40] == toks).all()


@pytest.mark.cuda
def test_lm_bf16_prefill_on_card_matches_plain_attention(cuda):
    """The smoke config in bf16: prefill through the tensor-core kernel
    (one launch a layer, no copy) against plain attention, last-position
    logits within chip_smoke's bound."""
    cfg = dataclasses.replace(get_arch("smollm-135m").smoke_cfg,
                              dtype=torch.bfloat16)
    params = tf.init(cfg, torch.Generator(device=cuda).manual_seed(1),
                     device=cuda)
    lm = port_data.make_markov_lm(cfg.vocab, seed=1)
    toks = torch.from_numpy(port_data.lm_batch(lm, 2, 300, step=0)[0]).to(cuda)
    before = flash_ops.LAUNCHES["flash_attention"]
    copies = flash_ops.COPIES["flash_attention"]
    kern = tf.prefill(cfg, params, toks)
    assert flash_ops.LAUNCHES["flash_attention"] == before + cfg.n_layers
    assert flash_ops.COPIES["flash_attention"] == copies
    plain = tf.prefill(cfg, params, toks, backend="jnp")
    assert torch.isfinite(kern).all()
    assert float((kern.float() - plain.float()).abs().max()) <= LM_LOGIT_TOL
