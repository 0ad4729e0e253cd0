"""The port's kernel wrappers against the JAX package's kernels.

On the CPU the JAX kernels run in Pallas interpret mode (as
``tests/test_kernels.py`` runs them) and the port's wrappers run their
plain PyTorch versions, because the tensors lie on the CPU.  The CUDA
kernels themselves are held against the plain versions in
``tests/test_torch_cuda.py`` (marker ``cuda``), which skip without a card.

Tolerances: the gather-L2 paths sum the same float32 squares in another
order (rtol 1e-5, atol 1e-5); bitdot uses the JAX kernel test's rtol 1e-5 /
atol 1e-4, fused_estimate its rtol 1e-4 / atol 1e-3.  batched_l2's plain
version takes the difference form and the JAX kernel the norm identity:
rtol 1e-5 / atol 1e-4 in f32 (the identity's cancellation at |r|² + |q|² ≈
2d), and the JAX kernel test's 5e-2 on bf16 inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.kernels.bitdot.ops import bitdot as ref_bitdot
from repro.kernels.bitdot.ops import fused_estimate as ref_fused_estimate
from repro.kernels.l2dist import ops as ref_l2ops

from repro_torch.core.search import make_batch_dist_fn, resolve_backend
from repro_torch.kernels import _build
from repro_torch.kernels.bitdot import ops as bitdot_ops
from repro_torch.kernels.bitdot import ref as bitdot_ref
from repro_torch.kernels.l2dist import ops as l2ops
from repro_torch.kernels.l2dist import ref as l2ref

from test_torch_cuda import (
    BATCHED_L2_SHAPES,
    BITDOT_SHAPES,
    ESTIMATE_DIMS,
    L2_SHAPES,
    RAGGED_D,
    _batched_l2_inputs,
    _codes,
    _estimate_args,
    _estimate_inputs,
    _l2_inputs,
)

# several test workers share the host's cores; one intra-op thread each
# keeps them from oversubscribing it
torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["gather_l2", "gather_l2_tiled"])
@pytest.mark.parametrize("B,M,d", L2_SHAPES)
def test_gather_l2_matches_reference(name, B, M, d):
    base, ids, qs = _l2_inputs(B, M, d)
    expect = np.asarray(getattr(ref_l2ops, name)(
        jnp.asarray(base), jnp.asarray(ids), jnp.asarray(qs)))
    before = dict(l2ops.LAUNCHES)
    out = getattr(l2ops, name)(torch.from_numpy(base), torch.from_numpy(ids),
                               torch.from_numpy(qs)).numpy()
    assert l2ops.LAUNCHES == before          # CPU tensors: no kernel launch
    assert np.isinf(out[ids < 0]).all() and np.isinf(expect[ids < 0]).all()
    ok = ids >= 0
    np.testing.assert_allclose(out[ok], expect[ok], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m,d", BITDOT_SHAPES)
def test_bitdot_matches_reference(m, d):
    codes, q = _codes(m, d, seed=m + d)
    expect = np.asarray(ref_bitdot(jnp.asarray(codes), jnp.asarray(q)))
    before = dict(bitdot_ops.LAUNCHES)
    out = bitdot_ops.bitdot(torch.from_numpy(codes.view(np.int32))[None],
                            torch.from_numpy(q)[None])[0].numpy()
    assert bitdot_ops.LAUNCHES == before
    np.testing.assert_allclose(out, expect, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("d", ESTIMATE_DIMS)
def test_fused_estimate_matches_reference(d):
    """Gathered by id in the port; the JAX kernel (interpret mode) takes the
    rows gathered per query, and its pad rows are masked here."""
    inputs = _estimate_inputs(4, 40, d, seed=d)
    codes, norms, ip_xo, ids, q, norm_q = inputs
    expect = []
    for b in range(ids.shape[0]):
        safe = np.maximum(ids[b], 0)
        e = np.asarray(ref_fused_estimate(
            jnp.asarray(codes[safe]), jnp.asarray(norms[safe]),
            jnp.asarray(ip_xo[safe]), jnp.asarray(q[b]),
            jnp.float32(norm_q[b]), d, interpret=True))
        expect.append(np.where(ids[b] >= 0, e, np.inf))
    before = dict(bitdot_ops.LAUNCHES)
    out = bitdot_ops.fused_estimate(*_estimate_args(inputs, "cpu")).numpy()
    assert bitdot_ops.LAUNCHES == before
    assert np.isinf(out[ids < 0]).all()
    np.testing.assert_allclose(out, np.stack(expect), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("m,d", BITDOT_SHAPES)
def test_kernel_order_sum_matches_reference(m, d):
    """S₊ summed in the CUDA kernels' order (per lane over ascending words,
    then the xor butterfly) against the JAX kernel (interpret mode) and the
    plain product, at the JAX kernel test's tolerance."""
    codes, q = _codes(m, d, seed=m + d)
    expect = np.asarray(ref_bitdot(jnp.asarray(codes), jnp.asarray(q)))
    c = torch.from_numpy(codes.view(np.int32))[None]
    out = bitdot_ref.s_plus_kernel_order(c, torch.from_numpy(q)[None])
    np.testing.assert_allclose(out[0].numpy(), expect, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(out, bitdot_ref.bitdot_ref(
        c, torch.from_numpy(q)[None]), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("d", ESTIMATE_DIMS)
def test_fused_estimate_kernel_order_matches_reference(d):
    """The kernel's order of sums and roundings against the JAX kernel
    (interpret mode) at its test's tolerance; +inf at ids < 0, NaN at
    ids ≥ n."""
    inputs = _estimate_inputs(4, 40, d, seed=d)
    codes, norms, ip_xo, ids, q, norm_q = inputs
    expect = [np.asarray(ref_fused_estimate(
        jnp.asarray(codes[np.maximum(row, 0)]),
        jnp.asarray(norms[np.maximum(row, 0)]),
        jnp.asarray(ip_xo[np.maximum(row, 0)]), jnp.asarray(q[b]),
        jnp.float32(norm_q[b]), d, interpret=True))
        for b, row in enumerate(ids)]
    args = list(_estimate_args(inputs, "cpu"))
    args[3] = args[3].clone()
    args[3][1, :2] = torch.tensor([len(codes), 2**31 - 1])
    out = bitdot_ref.fused_estimate_kernel_order(*args).numpy()
    ok = ids >= 0
    ok[1, :2] = False
    assert np.isinf(out[ids < 0]).all() and np.isnan(out[1, :2]).all()
    np.testing.assert_allclose(out[ok], np.stack(expect)[ok], rtol=1e-4,
                               atol=1e-3)


def test_fma32_rounds_once():
    """fma32 against exact rational arithmetic: the nearest float32 (ties
    to even) on random triples, and a float64 sum that lands on a float32
    tie which the exact value lies past (rounding twice gives the other
    float)."""
    from fractions import Fraction

    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 500)).astype(np.float32)
    x[:, 0] = [1 + 2**-12, 1 + 2**-12, 2**-60]
    x[:, 1] = [1 + 2**-12, 1 + 2**-12, -2**-60]
    r = bitdot_ref.fma32(*map(torch.from_numpy, x)).numpy()
    assert r[0] == np.float32(1 + 2**-11 + 2**-23)
    assert r[1] == np.float32(1 + 2**-11)
    for a, b, c, got in zip(*x, r):
        exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
        err = abs(Fraction(float(got)) - exact)
        for nb in (np.nextafter(got, np.float32(np.inf)),
                   np.nextafter(got, np.float32(-np.inf))):
            other = abs(Fraction(float(nb)) - exact)
            assert err < other or (err == other
                                   and got.view(np.int32) % 2 == 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,M,d", BATCHED_L2_SHAPES)
def test_batched_l2_matches_reference(B, M, d, dtype):
    rows, qs = _batched_l2_inputs(B, M, d, getattr(torch, dtype))
    expect = np.asarray(ref_l2ops.batched_l2(
        jnp.asarray(rows.float().numpy()).astype(dtype),
        jnp.asarray(qs.float().numpy()).astype(dtype)))
    before = dict(l2ops.LAUNCHES)
    out = l2ops.batched_l2(rows, qs)
    assert l2ops.LAUNCHES == before
    assert out.dtype == torch.float32
    tol = (1e-5, 1e-4) if dtype == "float32" else (5e-2, 5e-2)
    np.testing.assert_allclose(out.numpy(), expect, rtol=tol[0], atol=tol[1])


def _f32(shape, offset=0):
    """A contiguous float32 view of ``shape`` that starts ``offset``
    elements into a flat buffer (offset 1: not 16-byte aligned)."""
    flat = torch.zeros(int(np.prod(shape)) + offset)
    return flat[offset:].view(*shape)


@pytest.mark.parametrize("B,d,base_off,q_off,want", [
    (128, 128, 0, 0, "gather_l2_rows"),              # the drain, the build
    (3, 64, 0, 0, "gather_l2_rows"),                 # half a warp a row
    (1024, 129, 0, 0, "gather_l2_ragged"),           # MIPS's ragged d + 1
    (1024, 132, 0, 0, "gather_l2_ragged"),           # past the float4 row
    (1024, 128, 1, 0, "gather_l2_ragged"),           # base not 16-byte aligned
    (1024, 128, 0, 1, "gather_l2_ragged"),           # query lines not aligned
    (1024, 129, 3, 1, "gather_l2_ragged"),           # both, at d + 1
    (8, 130, 0, 0, "gather_l2_ragged"),              # one column past 4 a lane
    (8, 200, 0, 0, "gather_l2_ragged"),
    (8, 256, 0, 0, "gather_l2_ragged"),              # the widest scalar row
    (8, 264, 0, 0, "gather_l2_blocks"),              # past it
])
def test_tiled_kernel_choice(B, d, base_off, q_off, want):
    """gather_l2_tiled's kernel by d and alignment: the float4 register
    kernel only where every row and query line is 16-byte aligned and
    d % 4 == 0, d <= 128; the ragged-d one for every other d <= 256."""
    base, queries = _f32((5, d), base_off), _f32((B, d), q_off)
    assert l2ops.tiled_kernel(base, queries) == want


@pytest.mark.parametrize("d,base_off,q_off,want", [
    (128, 0, 0, "gather_l2_row1"),           # backend="kernel"'s [128, 24]
    (64, 0, 0, "gather_l2_row1"),            # half a warp a row
    (129, 0, 0, "gather_l2_ragged1"),        # MIPS's ragged d + 1
    (128, 1, 0, "gather_l2_ragged1"),        # base not 16-byte aligned
    (128, 0, 1, "gather_l2_ragged1"),        # query lines not aligned
    (200, 0, 0, "gather_l2_ragged1"),        # past the float4 row
    (256, 0, 0, "gather_l2_ragged1"),        # the widest scalar row
    (264, 0, 0, "gather_l2_blocks"),         # past it
])
def test_one_row_kernel_choice(d, base_off, q_off, want):
    """gather_l2's kernel, one row a warp, by gather_l2_tiled's rule: the
    float4 register kernel at d % 4 == 0, d <= 128 with aligned rows and
    query lines, the ragged-d one at every other d <= 256, the block kernel
    past it."""
    base, queries = _f32((5, d), base_off), _f32((128, d), q_off)
    assert l2ops.one_row_kernel(base, queries) == want
    tiled = l2ops.tiled_kernel(base, queries)
    assert want == {"gather_l2_rows": "gather_l2_row1",
                    "gather_l2_ragged": "gather_l2_ragged1"}.get(tiled, tiled)


@pytest.mark.parametrize("B,M,d,rows_off,q_cols,want", [
    (1024, 25, 128, 0, 128, "batched_l2_rows"),      # the build's selector
    (524, 128, 128, 0, 128, "batched_l2_rows"),      # the exact build's
    (2, 25, 128, 0, 384, "batched_l2_rows"),         # a column slice, aligned
    (2, 25, 128, 0, 130, "batched_l2_ragged"),       # query stride 130
    (2, 25, 128, 1, 128, "batched_l2_ragged"),       # rows not aligned
    (3, 9, 129, 0, 129, "batched_l2_ragged"),        # MIPS's ragged d + 1
    (2, 9, 132, 0, 132, "batched_l2_ragged"),        # past the float4 row
    (1024, 25, 129, 0, 388, "batched_l2_ragged"),    # the MIPS build, 3d + 1
    (2, 9, 130, 1, 391, "batched_l2_ragged"),        # both off, d = 130
    (2, 9, 200, 0, 200, "batched_l2_ragged"),
    (2, 9, 256, 0, 512, "batched_l2_ragged"),        # the widest scalar row
    (2, 9, 264, 0, 264, "batched_l2_blocks"),        # past it
])
def test_batched_kernel_choice(B, M, d, rows_off, q_cols, want):
    """batched_l2's kernel: the float4 register kernel wherever each load
    can be 16-byte aligned (rows, query lines and their stride) at d % 4 ==
    0, d <= 128; the ragged-d one for every other d <= 256."""
    rows = _f32((B, M, d), rows_off)
    queries = _f32((B, q_cols))[:, q_cols - d:]       # a trailing column slice
    assert l2ops.batched_kernel(rows, queries) == want


@pytest.mark.parametrize("d", RAGGED_D)
@pytest.mark.parametrize("name", ["gather_l2_tiled", "gather_l2",
                                  "batched_l2"])
def test_ragged_layouts_match_reference(name, d):
    """The layouts the ragged-d kernels take on the card — d of 129-256,
    views off 16-byte alignment, query lines 3d + 1 apart — through the
    port's wrappers and the JAX kernels, on the same values."""
    rng = np.random.default_rng(d)
    B, M, n = 3, 9, 40
    if name != "batched_l2":
        base = _f32((n, d), 1)
        base.copy_(torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)))
        ids = rng.integers(-1, n, (B, M)).astype(np.int32)
        ids[0, 0] = -1
        wide = torch.from_numpy(rng.normal(size=(B, 3 * d + 1)).astype(np.float32))
        queries = wide[:, 3:3 + d]                   # 3d + 1 apart, 4-byte offset
        expect = np.asarray(getattr(ref_l2ops, name)(
            jnp.asarray(base.numpy()), jnp.asarray(ids),
            jnp.asarray(queries.numpy())))
        before = dict(l2ops.LAUNCHES)
        out = getattr(l2ops, name)(base, torch.from_numpy(ids),
                                   queries.contiguous()).numpy()
        assert l2ops.LAUNCHES == before
        assert np.isinf(out[ids < 0]).all() and np.isinf(expect[ids < 0]).all()
        ok = ids >= 0
        np.testing.assert_allclose(out[ok], expect[ok], rtol=1e-5, atol=1e-5)
    else:
        rows = _f32((B, M, d), 3)
        rows.copy_(torch.from_numpy(rng.normal(size=(B, M, d)).astype(np.float32)))
        wide = torch.from_numpy(rng.normal(size=(B, 3 * d + 1)).astype(np.float32))
        queries = wide[:, 2 * d + 1:]                # 3d + 1 apart
        expect = np.asarray(ref_l2ops.batched_l2(
            jnp.asarray(rows.numpy()), jnp.asarray(queries.numpy())))
        before = dict(l2ops.LAUNCHES)
        out = l2ops.batched_l2(rows, queries).numpy()
        assert l2ops.LAUNCHES == before
        np.testing.assert_allclose(out, expect, rtol=1e-5, atol=1e-4)


def test_int32_view_is_bit_exact():
    """The uint32 → int32 view keeps every bit, bit 31 included."""
    codes, _ = _codes(64, 128, seed=3)
    codes[0, 0] = 0x80000000
    v = torch.from_numpy(codes.view(np.int32))
    assert int(v[0, 0]) == -2**31
    np.testing.assert_array_equal(v.numpy().view(np.uint32), codes)
    bits = bitdot_ref.unpack_bits_ref(v, 128).numpy()
    expect = (codes[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
    np.testing.assert_array_equal(bits, expect.reshape(64, 128))


def test_auto_backend_is_plain_on_cpu():
    assert resolve_backend("auto", torch.device("cpu")) == "jnp"
    assert resolve_backend("auto", torch.device("cuda")) == "kernel_tiled"
    with pytest.raises(ValueError):
        resolve_backend("xla", torch.device("cpu"))
    base, ids, qs = _l2_inputs(2, 16, 24)
    before = dict(l2ops.LAUNCHES)
    d_auto = make_batch_dist_fn(torch.from_numpy(base), "auto")(
        torch.from_numpy(qs), torch.from_numpy(ids))
    d_plain = l2ref.gather_l2_ref(torch.from_numpy(base),
                                  torch.from_numpy(ids), torch.from_numpy(qs))
    assert torch.equal(d_auto, d_plain)
    assert l2ops.LAUNCHES == before


def test_wrappers_check_their_inputs():
    base, ids, qs = _l2_inputs(2, 8, 16)
    tb, ti, tq = map(torch.from_numpy, (base, ids, qs))
    with pytest.raises(TypeError):
        l2ops.gather_l2_tiled(tb.double(), ti, tq)
    with pytest.raises(TypeError):
        l2ops.gather_l2(tb, ti.long(), tq)
    with pytest.raises(ValueError):
        l2ops.gather_l2_tiled(tb, ti, tq[:, :8])
    codes, q = _codes(4, 64, seed=1)
    with pytest.raises(TypeError):
        bitdot_ops.bitdot(torch.from_numpy(codes.view(np.int32)).long()[None],
                          torch.from_numpy(q)[None])
    with pytest.raises(ValueError):
        bitdot_ops.bitdot(torch.from_numpy(codes.view(np.int32))[None],
                          torch.zeros(1, 65))
    args = list(_estimate_args(_estimate_inputs(2, 8, 64), "cpu"))
    bad = args.copy()
    bad[3] = bad[3].long()                       # ids must be int32
    with pytest.raises(TypeError):
        bitdot_ops.fused_estimate(*bad)
    bad = args.copy()
    bad[4] = torch.zeros(2, 65)                  # d > 32·W
    with pytest.raises(ValueError):
        bitdot_ops.fused_estimate(*bad)
    rows, qs = _batched_l2_inputs(2, 8, 16)
    with pytest.raises(TypeError):
        l2ops.batched_l2(rows.double(), qs)
    with pytest.raises(ValueError):
        l2ops.batched_l2(rows, qs[:, :8])


def test_missing_nvcc_raises(monkeypatch):
    """No compiler means an error, never a silent fall back to ref."""
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()


def test_library_name_covers_included_headers_and_flags(monkeypatch,
                                                        tmp_path):
    """A library's name changes with an edit to any csrc header its source
    includes, directly or through another header, and with its own extra
    flags; an edit to a header it does not include leaves it as it was."""
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <cuda.h>\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "c.cuh").write_text("// c\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "EXTRA_FLAGS", {})
    first = _build.library_path("k")
    (tmp_path / "c.cuh").write_text("// c, edited\n")
    assert _build.library_path("k") == first
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    second = _build.library_path("k")
    assert second != first and second.name.startswith("k-")
    monkeypatch.setattr(_build, "EXTRA_FLAGS", {"k": ("-lcuda",)})
    assert _build.library_path("k") != second
    assert _build.build_log("k") == ""
