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
on one tile against the same products in f32 (rtol/atol 1e-5); its lse
output against ``torch.logsumexp`` (rtol/atol 1e-5).  The backward
kernels against ``attention_bwd_ref``: in f32 to rtol 1e-4 / atol 1e-5,
in bf16 (the tensor-core kernels, from the forward's lse) to
``ref.grad_err_ratio``'s bound, two calls to the same bits, and the bf16
kernel's transposed products on one tile against ``torch.matmul`` in f32
(rtol/atol 1e-5).  Live
updates on the card launch the L2 kernels and recover from their journal
to the same bits; the resilient server at rung 0 gives ``AnnServer``'s
results exactly, with no retry and no fallback, and a failing kernel tier
fails its batch instead of falling back to the plain version.  The
sharded index on the card gives its plain path's ids, a repaired slot is
bitwise the slot the sharded build made, and the SPMD transport (two
ranks on the one card, gloo between them) equals the single-controller
search.  ``moe_apply`` on the card drops the entries its CPU run drops and
agrees with it (f32 to 1e-5, bf16 within 2^-5 of the output's largest
magnitude), and a bf16 MoE prefill gives the same logits twice.  The
recsys archs' smoke configs on the card agree with the port on the CPU
(f32 to rtol 1e-5 / atol 1e-6, retrieval ids identical with their exact
ties in order), and MIPS search at MIND's d + 1 = 65 gives its plain
path's ids.  The sharded single controller's lock-step search equals its
slots searched one at a time, bit for bit.  The GAT in edge chunks on the
card agrees with the edge list in one piece (loss and gradients to 1e-5,
a gradient leaf's of its own norm or of a floor), ``CSRGraph.from_edges``
sorted on the card gives numpy's stable order,
and a chunked GAT step, like a recsys arch's step, is bitwise repeatable
under ``torch.use_deterministic_algorithms``.  The top-C merge kernel
gives the card's stable sort of the concatenation to the bit (ids, d2
bits, flags), and the search loops with it the plain merge's results.  At
GIST1M's d = 960 (the benchmark's synth-d960.batch shapes) the block L2
kernels and fused_estimate's W = 30 instance equal their plain versions,
and the serve path launches that 4-chunk instance once a pass.
"""

import dataclasses
import importlib

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
from repro_torch.kernels.topc import ops as topc_ops
from repro_torch.kernels.topc import ref as topc_ref
from repro_torch.configs import get_arch
from repro_torch.models import common
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.core.updates import JournaledLiveIndex, as_live, recover
from repro_torch.core.verify import audit_live
from repro_torch.core.distributed import (ShardHealthRegistry, build_sharded,
                                          host_reference_merge,
                                          make_sharded_search, spmd_search)
from repro_torch.core.repair import RepairController, ShardVectorStore
from repro_torch.serve import AnnServer, ResilienceConfig, ResilientAnnServer
from repro_torch.serve import ShardedResilientAnnServer
from repro_torch.serve import generate
from repro_torch.testing import (FaultPlan, indexes_equal,
                                 inject_search_faults)

# the modules, not the functions that repro_torch.core exports
search_mod = importlib.import_module("repro_torch.core.search")
probing_mod = importlib.import_module("repro_torch.core.probing")

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


# (C, K) of the top-C merge: the probing loop's exact and approximate
# tiers at l_max 512, the build's searches at L 1,000, a small row, K > C,
# and a row of C + K = 129
MERGE_SHAPES = [(513, 1), (513, 64), (1001, 64), (7, 3), (5, 20), (100, 29)]


def _merge_inputs(B, C, K, seed, device, nan=False):
    """A buffer sorted by the card's own stable sort and new entries, with
    ties across and within them, -0.0 and +0.0, +inf pads, rows that take
    nothing (row % 4 == 1), rows whose every new entry beats the buffer
    (row % 4 == 2) and rows whose buffer is half +inf (row % 4 == 3); with
    ``nan``, NaNs of both signs among them."""
    rng = np.random.default_rng(seed)
    values = [-0.0, 0.0, 0.25, 0.5, 1.0, 1.5, 2.0, np.inf, -np.inf]
    if nan:
        values += [np.nan, -np.nan]
    grid = np.array(values, dtype=np.float32)
    raw_a = rng.choice(grid, (B, C))
    raw_a[3::4, C // 2:] = np.inf
    d2_b = rng.choice(grid, (B, K))
    d2_b[2::4] = -1.0 - rng.random((len(d2_b[2::4]), K))
    d2_a = torch.sort(torch.from_numpy(raw_a).to(device), dim=1,
                      stable=True).values
    last = d2_a[1::4, -1:].cpu().numpy()
    d2_b[1::4] = np.where(np.isnan(d2_b[1::4]), d2_b[1::4],
                          np.maximum(d2_b[1::4], last))
    ids_a = rng.permutation(B * C).reshape(B, C).astype(np.int32)
    ids_b = (B * C + rng.permutation(B * K)).reshape(B, K).astype(np.int32)
    t = [torch.from_numpy(x).to(device) for x in
         (ids_a, rng.random((B, C)) < 0.5, ids_b, d2_b.astype(np.float32),
          rng.random((B, K)) < 0.5)]
    return t[0], d2_a, t[1], t[2], t[3], t[4]


def _assert_merge_equal(got, want):
    ids, d2, vis = got
    assert torch.equal(ids, want[0])
    assert torch.equal(d2.view(torch.int32), want[1].view(torch.int32))
    assert torch.equal(vis, want[2])


@pytest.mark.cuda
@pytest.mark.parametrize("C,K", MERGE_SHAPES)
def test_merge_topc_equals_the_plain_merge_to_the_bit(cuda, C, K):
    """ids, the bits of d2 (-0.0 against +0.0 too) and flags equal to the
    stable sort of the concatenation on the card; the buffer is updated in
    place."""
    inputs = _merge_inputs(256, C, K, C * 100 + K, cuda)
    want = topc_ref.merge_topc_ref(*inputs, C)
    before = topc_ops.LAUNCHES["merge_topc"]
    got = topc_ops.merge_topc(*inputs, C)
    torch.cuda.synchronize()
    assert topc_ops.LAUNCHES["merge_topc"] == before + 1
    assert all(g is a for g, a in zip(got, inputs[:3]))
    _assert_merge_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("C,K", [(513, 64), (7, 3)])
def test_merge_topc_puts_nan_where_the_card_sort_does(cuda, C, K):
    """NaNs of both signs: a negative NaN before -inf, a positive one after
    +inf, as the card's sort puts them at every row width."""
    inputs = _merge_inputs(256, C, K, 11, cuda, nan=True)
    want = topc_ref.merge_topc_ref(*inputs, C)
    _assert_merge_equal(topc_ops.merge_topc(*inputs, C), want)


@pytest.mark.cuda
def test_merge_topc_raises_if_the_kernel_cannot_launch(cuda, monkeypatch):
    """A refused launch raises; nothing falls back to the plain version."""
    inputs = _merge_inputs(8, 33, 4, 0, cuda)

    class Refused:
        @staticmethod
        def merge_topc(*args):
            return 9                    # cudaErrorInvalidConfiguration

    monkeypatch.setattr(_build, "load", lambda name: Refused())
    before = topc_ops.LAUNCHES["merge_topc"]
    with pytest.raises(RuntimeError, match="merge_topc"):
        topc_ops.merge_topc(*inputs, 33)
    assert topc_ops.LAUNCHES["merge_topc"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("beam_width", [1, 4])
def test_search_loops_on_card_merge_as_the_plain_merge(card_emqg, monkeypatch,
                                                       beam_width):
    """probing_search and search with the merge kernel give the ids and d2
    bits of the same loops with the plain merge; a probing pass merges
    twice (one fused_estimate a pass), a beam pass once (one gather_l2_tiled
    a pass after the start's)."""
    idx, _ = card_emqg
    queries = clustered_vectors(200, 32, 16, seed=1)
    p = SearchParams(k=10, l0=10, l_max=64, alpha=1.2, adaptive=True,
                     max_hops=512, beam_width=beam_width)
    runs = {}
    for merge in ("kernel", "plain"):
        if merge == "plain":
            for mod in (search_mod, probing_mod):
                monkeypatch.setattr(mod, "batch_merge_topc",
                                    topc_ref.merge_topc_ref)
        before = dict(topc_ops.LAUNCHES, **bitdot_ops.LAUNCHES,
                      **l2ops.LAUNCHES)
        probe = probing_search(idx, queries, p)
        mid = dict(topc_ops.LAUNCHES, **bitdot_ops.LAUNCHES, **l2ops.LAUNCHES)
        beam = search(idx.graph, queries, p)
        after = dict(topc_ops.LAUNCHES, **bitdot_ops.LAUNCHES,
                     **l2ops.LAUNCHES)
        torch.cuda.synchronize()
        runs[merge] = (probe, beam)
        merges = (mid["merge_topc"] - before["merge_topc"],
                  after["merge_topc"] - mid["merge_topc"])
        if merge == "kernel":
            assert merges == (
                2 * (mid["fused_estimate"] - before["fused_estimate"]),
                after["gather_l2_tiled"] - mid["gather_l2_tiled"] - 1)
            assert merges[0] > 0 and merges[1] > 0
        else:
            assert merges == (0, 0)
    for got, want in zip(runs["kernel"], runs["plain"]):
        assert torch.equal(got.ids, want.ids)
        assert torch.equal(got.dists.view(torch.int32),
                           want.dists.view(torch.int32))
        assert torch.equal(got.n_hops, want.n_hops)


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


@pytest.fixture
def card_sharded(cuda):
    bp = BuildParams(max_degree=12, beam_width=24, t=12, iters=2, block=512,
                     align_degree=True)
    base = clustered_vectors(3000, 32, 16, seed=0)
    return base, bp, build_sharded(base, 4, bp, quantized=True, seed=0,
                                   device=cuda)


@pytest.mark.cuda
def test_sharded_search_on_card_matches_plain_path(cuda, card_sharded):
    """Each shard's kernel search merged on the card: both merges equal the
    host merge, the ids equal the plain path's (``backend="jnp"``) on ≥ 99%
    of queries, and the sharded server's breaker holds the two merge tiers
    alone."""
    base, _, sidx = card_sharded
    p = SearchParams(k=10, l0=10, l_max=64, alpha=1.2, adaptive=True,
                     max_hops=512)
    q = clustered_vectors(64, 32, 16, seed=1)
    before = bitdot_ops.LAUNCHES["fused_estimate"]
    got = {m: make_sharded_search(m, quantized=True)(sidx, q, p)
           for m in ("all_gather", "ring")}
    assert bitdot_ops.LAUNCHES["fused_estimate"] > before
    ref_i, ref_d = host_reference_merge(sidx, ShardHealthRegistry(4), q, p,
                                        quantized=True)
    for ids, d in got.values():
        assert np.array_equal(ids.cpu().numpy(), ref_i)
        np.testing.assert_allclose(d.cpu().numpy(), ref_d, rtol=1e-4)
    plain, _ = make_sharded_search(quantized=True, backend="jnp")(sidx, q, p)
    ids = got["all_gather"][0]
    assert (ids == plain).all(1).float().mean().item() >= 0.99
    srv = ShardedResilientAnnServer(sidx, p, quantized=True, device=cuda)
    assert [t.name for t in srv.breaker.tiers] == \
        ["sharded/all_gather", "sharded/ring"]


@pytest.mark.cuda
def test_sharded_lockstep_on_card_equals_one_slot_at_a_time(cuda,
                                                            card_sharded):
    """The single controller's lock-step search over every live slot's
    rows on the card gives each slot's list from its own search
    (``_local_search``), ids and distances to the bit, with a slot left
    out."""
    from repro_torch.core.distributed import _local_search, _lockstep_search

    _, _, sidx = card_sharded
    p = SearchParams(k=10, l0=10, l_max=64, alpha=1.2, adaptive=True,
                     max_hops=512)
    q = torch.as_tensor(clustered_vectors(64, 32, 16, seed=1), device=cuda)
    for live in ([0, 1, 2, 3], [0, 2, 3]):
        got = _lockstep_search(sidx, live, q, p, quantized=True)
        for slot, (ids, dists) in zip(live, got):
            want = _local_search(sidx.slots[slot], q, p, quantized=True)
            assert torch.equal(ids, want.ids)
            assert torch.equal(dists.view(torch.int32),
                               want.dists.view(torch.int32))


@pytest.mark.cuda
def test_repaired_slot_on_card_is_the_original(cuda, tmp_path):
    """The store's rebuild on the card is bitwise the slot the sharded build
    made, and the repair controller installs it (the reference's
    audit-clean parameters)."""
    X = np.random.default_rng(0).standard_normal((512, 8)).astype(np.float32)
    bp = BuildParams(max_degree=12, beam_width=24, t=10, iters=3, block=128,
                     delta=0.5)
    sidx = build_sharded(X, 4, bp, seed=7, device=cuda)
    store = ShardVectorStore.create(str(tmp_path), X, 4, params=bp, seed=7)
    for s in range(4):
        assert indexes_equal(store.build_shard(s, device=cuda), sidx.slots[s])
    holder = {"sidx": sidx}
    reg = ShardHealthRegistry(4)
    ctl = RepairController(store, reg, get_sidx=lambda: holder["sidx"],
                           set_sidx=lambda x: holder.__setitem__("sidx", x))
    reg.mark_dead(2)
    before = l2ops.LAUNCHES["batched_l2"]
    out = ctl.sweep()
    assert [o.status for o in out] == ["succeeded"], out
    assert l2ops.LAUNCHES["batched_l2"] > before
    assert holder["sidx"].slots[2] is not sidx.slots[2]
    assert indexes_equal(holder["sidx"].slots[2], sidx.slots[2])
    assert reg.coverage() == 1.0


@pytest.mark.cuda
def test_spmd_gloo_on_card_equals_single_controller(card_sharded):
    """Two ranks on the one card, gloo over host copies of the [B, k]
    lists, each rank's search on the card: both merges equal the
    single-controller search on every rank."""
    base, bp, _ = card_sharded
    _build.build_all()
    sidx = build_sharded(base, 2, bp, quantized=True, seed=0, device="cuda")
    p = SearchParams(k=10, l0=10, l_max=64, alpha=1.2, adaptive=True,
                     max_hops=512)
    q = clustered_vectors(32, 32, 16, seed=1)
    ranks = spmd_search(sidx, q, p, quantized=True, timeout_s=300)
    for merge in ("all_gather", "ring"):
        ids, d = make_sharded_search(merge, quantized=True)(sidx, q, p)
        for r in ranks:
            assert np.array_equal(r[merge][0], ids.cpu().numpy())
            assert np.array_equal(r[merge][1], d.cpu().numpy())


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
    shared-memory limits of one block an SM, and no spills at hd = 64
    (smollm's) and hd = 128 (moonshot's: 168 registers, 0 local bytes on
    an H100)."""
    for hd in flash_ops.HEAD_DIMS:
        res = flash_ops.sm90_resources(hd)
        print(f"hd={hd}: {res}")
        assert 0 < res["registers"] <= 255
        assert res["dynamic_smem_bytes"] + res["static_smem_bytes"] <= 232448
        assert res["max_threads"] >= 384
    for hd in (64, 128):
        assert flash_ops.sm90_resources(hd)["local_bytes"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("hd", flash_ops.HEAD_DIMS)
def test_flash_sm90_lse_on_card(cuda, hd):
    """The bf16 kernel's lse (``return_lse``) is each row's log-sum-exp of
    its masked scaled scores in log2 units, against ``torch.logsumexp`` of
    the f32 scores (rtol/atol 1e-5: f32 sums in another order and ex2's
    approximation), and asking for it leaves the output the same bits."""
    for B, S, H, KV, causal, window in FLASH_CASES + FLASH_BF16_CASES:
        q, k, v = _flash_inputs(B, S, H, KV, hd, torch.bfloat16, cuda,
                                seed=S + hd)
        before = flash_ops.LAUNCHES["flash_attention"]
        out, lse = flash_ops.flash_attention(q, k, v, causal=causal,
                                             window=window, return_lse=True)
        assert flash_ops.LAUNCHES["flash_attention"] == before + 1
        assert lse.shape == (B, H, S) and lse.dtype == torch.float32
        plain = flash_ops.flash_attention(q, k, v, causal=causal,
                                          window=window)
        assert torch.equal(out, plain)
        G = H // KV
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                         k.float().repeat_interleave(G, 2)) / hd ** 0.5
        pos = torch.arange(S, device=cuda)
        ok = torch.ones((S, S), dtype=torch.bool, device=cuda)
        if causal:
            ok &= pos[:, None] >= pos[None, :]
        if window is not None:
            ok &= pos[:, None] - pos[None, :] < window
        want = torch.logsumexp(s.masked_fill(~ok, float("-inf")), -1)
        torch.testing.assert_close(lse, want * flash_ref.LOG2_E, rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", flash_ops.HEAD_DIMS)
def test_flash_bwd_sm90_products_match_matmul(cuda, hd):
    """The bf16 backward's dK / dV products on one tile each, as its dkdv
    kernel lays them out (a 128-key K block, each warpgroup 64 keys of it):
    sᵀ = k qᵀ (wgmma, K as A and Q as B, both K-major) and (pᵀ_hi + pᵀ_lo)
    dO (pᵀ from registers, dO an MN-major operand) equal the same products
    in f32 (exact bf16 products, f32 sums in another order: rtol/atol 1e-5
    of the scale)."""
    bq = flash_ops.sm90_bwd_resources(hd)["block_queries"]
    g = torch.Generator(device=cuda).manual_seed(hd)
    k = torch.randn((128, hd), generator=g, device=cuda).bfloat16()
    q = torch.randn((bq, hd), generator=g, device=cuda).bfloat16()
    do = torch.randn((bq, hd), generator=g, device=cuda).bfloat16()
    p = torch.rand((128, bq), generator=g, device=cuda)
    p_hi = p.bfloat16().float()
    p_lo = (p - p_hi).bfloat16().float()
    st, dv = flash_ops.sm90_bwd_probe(k, q, do, p)
    torch.testing.assert_close(st, k.float() @ q.float().T, rtol=1e-5,
                               atol=1e-5 * hd ** 0.5)
    torch.testing.assert_close(dv, (p_hi + p_lo) @ do.float(), rtol=1e-5,
                               atol=1e-5 * bq ** 0.5)


@pytest.mark.cuda
def test_flash_bwd_sm90_resources(cuda):
    """The bf16 backward's product kernels: within the register and
    shared-memory limits of one block an SM, and no spills at hd = 64
    (smollm's, the train path's)."""
    for hd in flash_ops.HEAD_DIMS:
        res = flash_ops.sm90_bwd_resources(hd)
        print(f"hd={hd}: {res}")
        for kern in ("dkdv", "dq"):
            assert 0 < res[kern]["registers"] <= 255
            assert (res[kern]["dynamic_smem_bytes"]
                    + res[kern]["static_smem_bytes"]) <= 232448
    res = flash_ops.sm90_bwd_resources(64)
    assert res["dkdv"]["local_bytes"] == 0 and res["dq"]["local_bytes"] == 0


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_apply_on_card_matches_cpu(cuda, dtype):
    """``moe_apply`` at moonshot's smoke widths (d 64, f 96, E 8, top-6)
    with drops, on the card against its CPU run on the same values: the
    same entries dropped; f32 to rtol/atol 1e-5, bf16 within 2^-5 of the
    output's largest magnitude (four bf16 ulps at its top: the GEMMs round
    to bf16 in other places)."""
    gen = torch.Generator().manual_seed(5)
    p = moe.moe_init(gen, 64, 96, 8, dtype, device="cpu")
    x = torch.randn((256, 64), generator=gen).to(dtype)
    want, want_aux = moe.moe_apply(p, x, 6, capacity_factor=1.0,
                                   n_groups=2)
    got, aux = moe.moe_apply({k: v.to(cuda) for k, v in p.items()},
                             x.to(cuda), 6, capacity_factor=1.0, n_groups=2)
    assert got.dtype == dtype and float(want_aux["frac_dropped"]) > 0
    assert round(float(aux["frac_dropped"]) * 256 * 6) == \
        round(float(want_aux["frac_dropped"]) * 256 * 6)
    if dtype == torch.float32:
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    else:
        err = float((got.cpu().float() - want.float()).abs().max())
        assert err <= 2 ** -5 * float(want.float().abs().max()), err


@pytest.mark.cuda
def test_moe_bf16_prefill_on_card_is_deterministic(cuda):
    """The MoE smoke config in bf16 with drops: two prefills give the same
    logits to the bit (the combine adds each token's slots in expert order,
    with no atomics), and the kernel launches once a layer."""
    cfg = dataclasses.replace(get_arch("moonshot-v1-16b-a3b").smoke_cfg,
                              dtype=torch.bfloat16, capacity_factor=1.0)
    params = tf.init(cfg, torch.Generator(device=cuda).manual_seed(2),
                     device=cuda)
    lm = port_data.make_markov_lm(cfg.vocab, seed=2)
    toks = torch.from_numpy(port_data.lm_batch(lm, 2, 300, step=0)[0]).to(cuda)
    before = flash_ops.LAUNCHES["flash_attention"]
    first, aux = tf.prefill_aux(cfg, params, toks)
    assert flash_ops.LAUNCHES["flash_attention"] == before + cfg.n_layers
    assert float(aux["frac_dropped"]) > 0
    second = tf.prefill(cfg, params, toks)
    assert torch.isfinite(first).all()
    torch.testing.assert_close(second, first, rtol=0, atol=0)


# (B, S, H, KV, causal, window) of the backward kernel: one row, a ragged
# tile, bidirectional, GQA 3 and 4, windows inside and across 64-row tiles,
# S past a tile at 257 and 333, bidirectional with a window
FLASH_BWD_CASES = [(1, 1, 2, 1, True, None), (2, 100, 6, 3, True, None),
                   (1, 100, 4, 4, False, None), (1, 130, 4, 2, True, 7),
                   (1, 257, 8, 2, True, 65), (2, 200, 4, 1, True, None),
                   (1, 333, 6, 2, False, 65), (1, 300, 3, 3, True, 64)]


def _bwd_inputs(B, S, H, KV, hd, dtype, device, seed=0):
    """q, k, v, the forward kernel's output o and a gradient do."""
    q, k, v = _flash_inputs(B, S, H, KV, hd, dtype, device, seed=seed)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    do = torch.randn((B, S, H, hd), generator=g, device=device).to(dtype)
    return q, k, v, do


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", flash_ops.HEAD_DIMS)
def test_flash_attention_bwd_kernel_on_card(cuda, hd, dtype):
    """dQ, dK and dV of the kernel against ``attention_bwd_ref`` on the same
    values in f32: in f32 to rtol 1e-4 / atol 1e-5 (the same f32 math in
    another order, on O(1) inputs), in bf16 (the tensor-core kernel, from
    the forward's lse) to ``grad_err_ratio``'s bound (each element rounded
    once from an f32 sum).  At S = 1 dQ and dK are zero in exact arithmetic
    (one key: P = 1, dP = D) and f32 noise in both versions: they are held
    to 1e-5."""
    for B, S, H, KV, causal, window in FLASH_BWD_CASES:
        q, k, v, do = _bwd_inputs(B, S, H, KV, hd, dtype, cuda, seed=S + hd)
        o, lse = flash_ops.flash_attention(q, k, v, causal=causal,
                                           window=window, return_lse=True)
        assert (lse is None) == (dtype == torch.float32)
        before = flash_ops.LAUNCHES["flash_attention_bwd"]
        got = flash_ops.flash_attention_bwd(q, k, v, o, do, causal=causal,
                                            window=window, lse=lse)
        torch.cuda.synchronize()
        assert flash_ops.LAUNCHES["flash_attention_bwd"] == before + 1
        want = flash_ref.attention_bwd_ref(
            q.float(), k.float(), v.float(), o.float(), do.float(),
            causal=causal, window=window)
        for name, out, w, x in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
            assert out.dtype == dtype and out.shape == x.shape, name
            assert torch.isfinite(out).all(), name
            if S == 1 and name != "dv":
                assert float(out.float().abs().max()) <= 1e-5, name
            elif dtype == torch.float32:
                torch.testing.assert_close(out, w, rtol=1e-4, atol=1e-5)
            else:
                ratio = flash_ref.grad_err_ratio(out, w)
                assert ratio <= 1.0, (name, B, S, H, KV, causal, window,
                                      ratio)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_is_deterministic(cuda, dtype):
    """Two backward launches on the same inputs give the same bits (no
    atomics)."""
    q, k, v, do = _bwd_inputs(2, 1000, 6, 2, 64, dtype, cuda, seed=3)
    o, lse = flash_ops.flash_attention(q, k, v, return_lse=True)
    first = flash_ops.flash_attention_bwd(q, k, v, o, do, lse=lse)
    second = flash_ops.flash_attention_bwd(q, k, v, o, do, lse=lse)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_attention_fn_gradient_on_card(cuda):
    """torch.autograd.grad through ``common.flash_attention`` on the card
    launches the backward kernel once and agrees with autograd through the
    plain blockwise attention (f32: rtol 1e-4 / atol 1e-5); without a tensor that needs a gradient the call launches
    only the forward."""
    q, k, v, do = _bwd_inputs(2, 300, 6, 2, 64, torch.float32, cuda, seed=5)
    before = dict(flash_ops.LAUNCHES)
    out = common.flash_attention(q, k, v, window=100)
    assert flash_ops.LAUNCHES["flash_attention_bwd"] == \
        before["flash_attention_bwd"]
    assert out.grad_fn is None
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    got = torch.autograd.grad(
        common.flash_attention(*leaves, window=100), leaves, do)
    assert flash_ops.LAUNCHES["flash_attention_bwd"] == \
        before["flash_attention_bwd"] + 1
    plain = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(
        common.flash_attention(*plain, window=100, backend="jnp"), plain, do)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_flash_attention_fn_bf16_gradient_on_card(cuda):
    """In bf16, torch.autograd.grad through ``common.flash_attention``
    launches the forward once and the backward once, and gives what the
    backward kernel gives on the forward's own output and lse, to the bit;
    its inputs need no copy for TMA."""
    q, k, v, do = _bwd_inputs(2, 300, 6, 2, 64, torch.bfloat16, cuda, seed=6)
    before = dict(flash_ops.LAUNCHES)
    copies = flash_ops.COPIES["flash_attention_bwd"]
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    got = torch.autograd.grad(
        common.flash_attention(*leaves, window=100), leaves, do)
    assert flash_ops.LAUNCHES["flash_attention"] == \
        before["flash_attention"] + 1
    assert flash_ops.LAUNCHES["flash_attention_bwd"] == \
        before["flash_attention_bwd"] + 1
    assert flash_ops.COPIES["flash_attention_bwd"] == copies
    o, lse = flash_ops.flash_attention(q, k, v, window=100, return_lse=True)
    want = flash_ops.flash_attention_bwd(q, k, v, o, do, window=100, lse=lse)
    for a, w in zip(got, want):
        assert torch.equal(a, w)


@pytest.mark.cuda
def test_flash_attention_bwd_refuses_what_the_kernel_does_not_take(
        cuda, monkeypatch):
    """A head_dim with no kernel instance raises rather than running the
    plain backward; a refused launch raises and is not counted."""
    q, k, v, do = _bwd_inputs(1, 16, 2, 1, 48, torch.float32, cuda)
    before = flash_ops.LAUNCHES["flash_attention_bwd"]
    with pytest.raises(ValueError, match="head_dim"):
        flash_ops.flash_attention_bwd(q, k, v, do, do)
    q, k, v, do = _bwd_inputs(1, 16, 2, 1, 64, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="lse"):
        flash_ops.flash_attention_bwd(q, k, v, do, do)

    class Refused:
        @staticmethod
        def flash_attn_bwd_f32(*args):
            return 9                    # cudaErrorInvalidConfiguration

    q, k, v, do = _bwd_inputs(1, 16, 2, 1, 64, torch.float32, cuda)
    monkeypatch.setattr(_build, "load", lambda name: Refused())
    with pytest.raises(RuntimeError, match="flash_attention_bwd"):
        flash_ops.flash_attention_bwd(q, k, v, do, do)
    assert flash_ops.LAUNCHES["flash_attention_bwd"] == before


RECSYS_ARCHS = ("fm", "dcn-v2", "dien", "mind")


@pytest.mark.cuda
@pytest.mark.parametrize("arch_id", RECSYS_ARCHS)
def test_recsys_on_card_matches_cpu(cuda, arch_id):
    """Each recsys arch's smoke config on the card against the port on the
    CPU with the same parameters: the serve cell's output to rtol 1e-5 /
    atol 1e-6 (f32, TF32 off: sums in another order); the retrieval over
    the rows' last 8 candidates and 300 that clip onto one row (exact
    ties), every candidate returned: ids identical, ties lowest index
    first, scores to the same tolerance."""
    from repro_torch.launch import steps
    from repro_torch.optim.adamw import tree_map

    cfg = get_arch(arch_id).smoke_cfg
    host = steps._RECSYS_INIT[arch_id](cfg, torch.Generator().manual_seed(0),
                                       device="cpu")
    params = tree_map(lambda t: t.to(cuda), host)
    batch = steps.recsys_batch(arch_id, cfg, 64, device="cpu")
    want = steps._RECSYS_SERVE[arch_id](cfg, host, batch)
    got = steps._RECSYS_SERVE[arch_id](
        cfg, params, {k: v.to(cuda) for k, v in batch.items()})
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-6)

    past = cfg.rows if arch_id in ("fm", "dcn-v2") else cfg.n_items
    cand = torch.cat([torch.arange(past - 8, past),
                      past + 64 * torch.arange(300)]).to(torch.int32)
    user = steps.recsys_batch(arch_id, cfg, 1, step=1, device="cpu")
    fn = steps._RECSYS_RETRIEVAL[arch_id]
    ws, wi = fn(cfg, host, user, cand, len(cand))
    gs, gi = fn(cfg, params, {k: v.to(cuda) for k, v in user.items()},
                cand.to(cuda), len(cand))
    assert torch.equal(gi.cpu(), wi)
    torch.testing.assert_close(gs.cpu(), ws, rtol=1e-5, atol=1e-6)
    tie = gs[0, 1:] == gs[0, :-1]
    assert int(tie.sum()) >= 299 and bool((gi[0, 1:] > gi[0, :-1])[tie].all())


@pytest.mark.cuda
def test_mips_search_at_d65_on_card_matches_plain(cuda):
    """MIND's width through the MIPS index: d + 1 = 65 gives three code
    words and the ragged-d register kernels (never the block kernels) in
    the build and the exact tier, fused_estimate in the approximate tier;
    ids equal the plain path's (``backend="jnp"``) on ≥ 99% of queries."""
    from repro_torch.core.mips import build_mips, mips_search

    items = clustered_vectors(3000, 64, 16, seed=2)
    queries = clustered_vectors(64, 64, 16, seed=3)
    before = dict(l2ops.KERNEL_LAUNCHES)
    mips = build_mips(items, BuildParams(max_degree=12, beam_width=24, t=12,
                                         iters=2, block=512),
                      quantized=True, device=cuda)
    assert mips.index.codes.words == 3
    built = {k: v - before[k] for k, v in l2ops.KERNEL_LAUNCHES.items()}
    assert built["gather_l2_ragged"] > 0 and built["batched_l2_ragged"] > 0
    plain = mips_search(mips, queries, k=10, backend="jnp")
    before = dict(l2ops.KERNEL_LAUNCHES, **bitdot_ops.LAUNCHES)
    res = mips_search(mips, queries, k=10)
    after = dict(l2ops.KERNEL_LAUNCHES, **bitdot_ops.LAUNCHES)
    ran = {k: v - before[k] for k, v in after.items()}
    assert ran["gather_l2_ragged"] > 0 and ran["fused_estimate"] > 0
    for kernel in ("gather_l2_blocks", "batched_l2_blocks"):
        assert built[kernel] == 0 and ran[kernel] == 0
    assert (res.ids == plain.ids).all(1).float().mean().item() >= 0.99


# the floor of a GAT gradient leaf's norm in the chunked-against-one-piece
# card test, as a share of the whole gradient's norm.  The same per-edge
# values added by atomics in another grouping leave an error that does not
# shrink with the leaf: over 14 runs of each chunk size on an H100, layer
# 0's bias (0.05 of the whole norm) read up to 2.1e-6 of the whole norm,
# its w (0.785) 2.3e-6, the attention vectors (0.002-0.011) 4.3e-7
GAT_LEAF_FLOOR = 0.5


def _gat_mid(device, seed=0):
    """A mid-size graph for the GAT on the card: 20,000 nodes, 400,000
    edges, ogb_products' 100 features and 47 classes."""
    from repro_torch.launch import steps

    g = port_data.sbm_graph(20_000, 47, 100,
                            avg_degree=steps.sbm_avg_degree(20_000, 400_000),
                            seed=seed)
    b = {k: torch.from_numpy(g[k]).to(device)
         for k in ("x", "src", "dst", "labels")}
    b["label_mask"] = torch.ones(20_000, dtype=torch.bool, device=device)
    return b


def _gat_grads(cfg, params, batch, chunk):
    from repro_torch.launch import steps
    from repro_torch.optim.adamw import tree_leaves, tree_unflatten

    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, _ = steps.gnn_loss(cfg, chunk)(tree_unflatten(params, leaves),
                                         batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(leaves, grads)]


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [1 << 12, 100_003])
def test_gat_edge_chunks_on_card_match_one_piece(cuda, chunk):
    """ogb_products' GAT on a mid-size graph on the card: the loss and
    every gradient leaf in edge chunks against the edge list in one piece
    (the loss to rtol 1e-5; each leaf's ‖Δ‖ to 1e-5 of its own norm, or of
    ``GAT_LEAF_FLOOR`` of the whole gradient's norm where that is larger,
    so a small leaf is held to half the bound a whole-norm test gives it),
    and the one-piece loss against the port on the CPU (rtol 1e-5)."""
    from repro_torch.models import gnn
    from repro_torch.launch import steps

    cfg = get_arch("gat-cora").model_cfg["ogb_products"]
    params = gnn.init(cfg, torch.Generator(device=cuda).manual_seed(0),
                      device=cuda)
    batch = _gat_mid(cuda)
    want_loss, want = _gat_grads(cfg, params, batch, None)
    got_loss, got = _gat_grads(cfg, params, batch, chunk)
    torch.testing.assert_close(got_loss, want_loss, rtol=1e-5, atol=0)
    total = float(torch.stack([w.norm() for w in want]).norm())
    read = [(float(w.norm()), float((a - w).norm()))
            for a, w in zip(got, want)]
    for i, (own, err) in enumerate(read):
        print(f"chunk {chunk} leaf {i}: ‖leaf‖/‖total‖ {own / total:.3g}, "
              f"‖Δ‖/‖total‖ {err / total:.3g}")
    assert all(err <= 1e-5 * max(own, GAT_LEAF_FLOOR * total)
               for own, err in read)
    host = {k: v.cpu() for k, v in batch.items()}
    from repro_torch.optim.adamw import tree_map
    cpu_loss, _ = steps.gnn_loss(cfg)(tree_map(lambda t: t.cpu(), params),
                                      host)
    torch.testing.assert_close(want_loss.cpu(), cpu_loss, rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_csr_from_edges_on_card_is_the_hosts(cuda):
    """``CSRGraph.from_edges`` sorted on the card gives numpy's stable
    order and row pointers, bit for bit, on a graph of 4 M edges."""
    from repro_torch.data.sampler import CSRGraph

    g = port_data.sbm_graph(200_000, 41, 8, avg_degree=10.0, seed=3)
    got = CSRGraph.from_edges(g["src"], g["dst"], 200_000, device=cuda)
    order = np.argsort(g["dst"], kind="stable")
    np.testing.assert_array_equal(got.indices, g["src"][order])
    np.testing.assert_array_equal(
        got.indptr, np.searchsorted(g["dst"][order], np.arange(200_001)))
    assert got.indices.dtype == np.int32 and got.indptr.dtype == np.int64


@pytest.mark.cuda
def test_gat_train_step_on_card_is_deterministic(cuda):
    """Under ``torch.use_deterministic_algorithms`` two chunked GAT train
    steps from the same state give the same loss and state, bit for bit
    (``index_add`` and ``index_select``'s backward take their
    deterministic kernels)."""
    from repro_torch.launch import steps
    from repro_torch.models import gnn
    from repro_torch.optim import OptConfig
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import TrainState, make_train_step

    cfg = get_arch("gat-cora").model_cfg["ogb_products"]
    batch = _gat_mid(cuda)
    opt = OptConfig(total_steps=1000)
    step = make_train_step(steps.gnn_loss(cfg, 1 << 15), opt)
    torch.use_deterministic_algorithms(True)
    try:
        runs = []
        for _ in range(2):
            params = gnn.init(cfg, torch.Generator(device=cuda).manual_seed(0),
                              device=cuda)
            state, m = step(TrainState.create(params, opt), batch)
            runs.append((m["loss"], tree_leaves([state.params,
                                                 state.opt_state])))
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


@pytest.mark.cuda
@pytest.mark.parametrize("arch_id", RECSYS_ARCHS)
def test_recsys_train_step_on_card_is_deterministic(cuda, arch_id):
    """Each recsys arch's smoke config: two train steps (AdamW, the
    reference cell's OptConfig) from the same state on the card give the
    same loss and state bit for bit under
    ``torch.use_deterministic_algorithms``, and the loss is the CPU's to
    rtol 1e-5."""
    from repro_torch.launch import steps
    from repro_torch.optim import OptConfig
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.train import TrainState, make_train_step

    cfg = get_arch(arch_id).smoke_cfg
    host = steps._RECSYS_INIT[arch_id](cfg, torch.Generator().manual_seed(0),
                                       device="cpu")
    batch = steps.recsys_batch(arch_id, cfg, 256, device="cpu")
    opt = OptConfig(total_steps=100000)
    step = make_train_step(lambda p, b: steps._RECSYS_LOSS[arch_id](cfg, p, b),
                           opt)
    _, cpu_m = step(TrainState.create(host, opt), batch)
    card_batch = {k: v.to(cuda) for k, v in batch.items()}
    torch.use_deterministic_algorithms(True)
    try:
        runs = []
        for _ in range(2):
            state, m = step(TrainState.create(
                tree_map(lambda t: t.to(cuda), host), opt), card_batch)
            runs.append((m["loss"], tree_leaves([state.params,
                                                 state.opt_state])))
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    torch.testing.assert_close(runs[0][0].cpu(), cpu_m["loss"], rtol=1e-5,
                               atol=0)


# sift1m's shapes at M = 64 (configs/sift1m.py; chip_smoke's sift1m
# phase): the build's searches gather ids [block, 64], its selector keeps
# [block, 64, 128] and the degree alignment's [block, 65, 128], the two
# serve shapes estimate ids [256, 64] and [4096, 64] (W = 4); block =
# chip_smoke's SIFT_BLOCK and one far smaller
SIFT_BLOCKS = [512, 16384]


@pytest.mark.cuda
@pytest.mark.parametrize("B", SIFT_BLOCKS)
def test_sift1m_gather_l2_tiled_on_card(cuda, B):
    g = torch.Generator(device=cuda).manual_seed(B)
    base = torch.randn((32768, 128), generator=g, device=cuda)
    ids = torch.randint(0, 32768, (B, 64), generator=g, device=cuda,
                        dtype=torch.int32)
    ids[:, ::9] = -1
    qs = torch.randn((B, 128), generator=g, device=cuda)
    before = l2ops.KERNEL_LAUNCHES["gather_l2_rows"]
    out = l2ops.gather_l2_tiled(base, ids, qs)
    torch.cuda.synchronize()
    assert l2ops.KERNEL_LAUNCHES["gather_l2_rows"] == before + 1
    assert torch.isinf(out[ids < 0]).all()
    ok = ids >= 0
    torch.testing.assert_close(out[ok], l2ref.gather_l2_ref(base, ids, qs)[ok],
                               rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("B", SIFT_BLOCKS)
@pytest.mark.parametrize("M", [64, 65])
def test_sift1m_batched_l2_on_card(cuda, B, M):
    g = torch.Generator(device=cuda).manual_seed(B + M)
    rows = torch.randn((B, M, 128), generator=g, device=cuda)
    qs = torch.randn((B, 128), generator=g, device=cuda)
    assert l2ops.batched_kernel(rows, qs) == "batched_l2_rows"
    before = l2ops.KERNEL_LAUNCHES["batched_l2_rows"]
    out = l2ops.batched_l2(rows, qs)
    torch.cuda.synchronize()
    assert l2ops.KERNEL_LAUNCHES["batched_l2_rows"] == before + 1
    torch.testing.assert_close(out, l2ref.batched_l2_ref(rows, qs),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [256, 4096])
def test_sift1m_fused_estimate_on_card(cuda, B):
    args = _estimate_args(_estimate_inputs(B, 64, 128, n=32768, seed=B),
                          cuda)
    ids = args[3]
    before = bitdot_ops.LAUNCHES["fused_estimate"]
    out = bitdot_ops.fused_estimate(*args)
    torch.cuda.synchronize()
    assert bitdot_ops.LAUNCHES["fused_estimate"] == before + 1
    assert torch.isinf(out[ids < 0]).all()
    ok = ids >= 0
    torch.testing.assert_close(out[ok],
                               bitdot_ref.fused_estimate_ref(*args)[ok],
                               rtol=1e-4, atol=1e-3)
    expect = bitdot_ref.fused_estimate_kernel_order(*args)
    assert torch.equal(out[ok].view(torch.int32), expect[ok].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["beam", "faithful", "probing", "ags"])
def test_delta_bound_w4_on_card(cuda, engine):
    """The (1/δ) bound at beam width 4 with the kernels, on ``from_graph``
    of an exact build made on the card (δ = 0.2), through the port's
    oracle (``tests/test_torch_search.py::test_delta_bound_w4`` on the
    CPU; chip_smoke's exact-build phase at n = 4,000)."""
    from repro_torch.core import from_graph
    from repro_torch.testing import check_delta_bound, exact_knn

    base = clustered_vectors(400, 16, 8, seed=0)
    queries = clustered_vectors(32, 16, 8, seed=1)
    g = build_exact(torch.from_numpy(base).to(cuda), delta=0.2,
                    device="cuda")
    idx = from_graph(g)
    q = torch.from_numpy(queries).to(cuda)
    p = SearchParams(k=5, l0=8, l_max=32, alpha=1.2, adaptive=True,
                     max_hops=256, beam_width=4)
    before = l2ops.LAUNCHES["gather_l2_tiled"]
    res = {"beam": lambda: search(g, q, p),
           "faithful": lambda: search(g, q, p, faithful_prune=True),
           "probing": lambda: probing_search(idx, q, p),
           "ags": lambda: ags_search(idx, q, p)}[engine]()
    torch.cuda.synchronize()
    assert l2ops.LAUNCHES["gather_l2_tiled"] > before
    ids, dists = res.ids.cpu().numpy(), res.dists.cpu().numpy()
    assert ((ids >= 0) & (ids < 400)).all()
    assert all(len(set(r.tolist())) == len(r) for r in ids)
    true = np.linalg.norm(base[ids] - queries[:, None, :], axis=-1)
    np.testing.assert_allclose(dists, true, rtol=1e-4, atol=1e-4)
    oracle_d = exact_knn(base, queries, p.k)[0]
    assert check_delta_bound(dists, oracle_d, 0.2) is None


# -- d = 960, GIST1M's width: the benchmark's synth-d960.batch cell's shapes

WIDE_D = 960
WIDE_BLOCK = 8192              # the cell's build block
WIDE_BATCH = 40_000            # the cell's queries a call


@pytest.mark.cuda
def test_fused_estimate_at_w30_on_card(cuda):
    """W = 30 (three full chunks and a last of 6) over [4096, 64], the
    probing loop's estimate at d = 960: equal to the plain version, to the
    bit to its kernel-order sum, one launch of the 4-chunk instance."""
    args = _estimate_args(_estimate_inputs(4096, 64, WIDE_D, n=32_768,
                                           seed=3), cuda)
    assert args[0].shape[1] == 30
    ids = args[3]
    before = (bitdot_ops.LAUNCHES["fused_estimate"],
              dict(bitdot_ops.CHUNK_LAUNCHES))
    out = bitdot_ops.fused_estimate(*args)
    torch.cuda.synchronize()
    assert bitdot_ops.LAUNCHES["fused_estimate"] == before[0] + 1
    assert bitdot_ops.CHUNK_LAUNCHES[4] == before[1].get(4, 0) + 1
    assert {c: v for c, v in bitdot_ops.CHUNK_LAUNCHES.items() if c != 4} \
        == {c: v for c, v in before[1].items() if c != 4}
    assert torch.isinf(out[ids < 0]).all()
    torch.testing.assert_close(out, bitdot_ref.fused_estimate_ref(*args),
                               rtol=1e-4, atol=1e-3)
    ok = ids >= 0
    expect = bitdot_ref.fused_estimate_kernel_order(*args)
    assert torch.equal(out[ok].view(torch.int32), expect[ok].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("B,M", [(WIDE_BATCH, 1), (WIDE_BLOCK, 64)])
def test_gather_l2_tiled_at_d960_on_card(cuda, B, M):
    """The probing loop's exact tier [B, 1] and the build's searches
    [block, 64] at d = 960, over the cell's 32,768 rows: the block kernel,
    equal to the plain version."""
    g = torch.Generator(device=cuda).manual_seed(5)
    base = torch.randn((32_768, WIDE_D), generator=g, device=cuda)
    ids = torch.randint(0, 32_768, (B, M), generator=g, device=cuda,
                        dtype=torch.int32)
    ids.view(-1)[::7] = -1
    qs = torch.randn((B, WIDE_D), generator=g, device=cuda)
    assert l2ops.tiled_kernel(base, qs) == "gather_l2_blocks"
    before = l2ops.KERNEL_LAUNCHES["gather_l2_blocks"]
    out = l2ops.gather_l2_tiled(base, ids, qs)
    torch.cuda.synchronize()
    assert l2ops.KERNEL_LAUNCHES["gather_l2_blocks"] == before + 1
    assert torch.isinf(out[ids < 0]).all()
    torch.testing.assert_close(out, l2ref.gather_l2_ref(base, ids, qs),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_batched_l2_at_d960_on_card(cuda):
    """The selector's kept set in the degree alignment, [block, 65, 960]:
    the block kernel, equal to the plain version, its query lines read in
    place from a column of the candidate tile."""
    g = torch.Generator(device=cuda).manual_seed(6)
    rows = torch.randn((WIDE_BLOCK, 65, WIDE_D), generator=g, device=cuda)
    tile = torch.randn((WIDE_BLOCK, 3, WIDE_D), generator=g, device=cuda)
    qs = tile[:, 1]
    assert l2ops.batched_kernel(rows, qs) == "batched_l2_blocks"
    before = l2ops.KERNEL_LAUNCHES["batched_l2_blocks"]
    out = l2ops.batched_l2(rows, qs)
    torch.cuda.synchronize()
    assert l2ops.KERNEL_LAUNCHES["batched_l2_blocks"] == before + 1
    torch.testing.assert_close(out, l2ref.batched_l2_ref(rows, qs),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_serve_path_at_d960_runs_the_w30_instance(cuda):
    """``launch.steps.ann_serve`` over a d = 960 index built on the card:
    every estimate launch is the 4-chunk instance (one a pass), every exact
    distance the block kernel, and the ids those of the plain path."""
    import types

    from repro_torch.launch import steps

    rng = np.random.default_rng(0)
    centres = rng.normal(0, 0.12, (8, WIDE_D))
    bases = rng.normal(0, WIDE_D ** -0.5, (8, WIDE_D, 21))
    c = rng.integers(0, 8, 2048 + 64)
    x = (centres[c] + np.einsum("ndr,nr->nd", bases[c],
                                rng.normal(size=(c.size, 21)))
         + rng.normal(0, 0.05, (c.size, WIDE_D))).astype(np.float32)
    bp = BuildParams(max_degree=16, beam_width=32, t=8, iters=2,
                     block=1024)
    sidx = build_sharded(x[:2048], 1, bp, quantized=True, seed=0,
                         device=cuda)
    p = SearchParams(k=10, l0=10, l_max=64, alpha=1.2, adaptive=True,
                     max_hops=512)
    arch = types.SimpleNamespace(id="synth-d960", family="ann",
                                 model_cfg={"dim": WIDE_D, "search": p})
    shape = types.SimpleNamespace(kind="ann_serve", name="serve", dims={})
    run = steps.ann_serve(arch, shape, sidx)
    q = torch.from_numpy(x[2048:]).to(cuda)
    before = (bitdot_ops.LAUNCHES["fused_estimate"],
              dict(bitdot_ops.CHUNK_LAUNCHES),
              dict(l2ops.KERNEL_LAUNCHES))
    ids, _ = run(q)
    torch.cuda.synchronize()
    passes = bitdot_ops.LAUNCHES["fused_estimate"] - before[0]
    assert passes > 0
    assert bitdot_ops.CHUNK_LAUNCHES[4] - before[1].get(4, 0) == passes
    grew = {k for k, v in l2ops.KERNEL_LAUNCHES.items() if v != before[2][k]}
    assert grew == {"gather_l2_blocks"}
    plain = probing_search(sidx.slots[0], q, p, backend="jnp")
    assert (ids.cpu() == plain.ids.cpu()).all(1).float().mean() >= 0.99
