"""The port's kernel wrappers against the JAX package's kernels.

On the CPU the JAX kernels run in Pallas interpret mode (as
``tests/test_kernels.py`` runs them) and the port's wrappers run their
plain PyTorch versions, because the tensors lie on the CPU.  The CUDA
kernels themselves are held against the plain versions in
``tests/test_torch_cuda.py`` (marker ``cuda``), which skip without a card.

Tolerances: the gather-L2 paths sum the same float32 squares in another
order (rtol 1e-5, atol 1e-5); bitdot uses the JAX kernel test's rtol 1e-5 /
atol 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.kernels.bitdot.ops import bitdot as ref_bitdot
from repro.kernels.l2dist import ops as ref_l2ops

from repro_torch.core.search import make_batch_dist_fn, resolve_backend
from repro_torch.kernels import _build
from repro_torch.kernels.bitdot import ops as bitdot_ops
from repro_torch.kernels.bitdot import ref as bitdot_ref
from repro_torch.kernels.l2dist import ops as l2ops
from repro_torch.kernels.l2dist import ref as l2ref

from test_torch_cuda import BITDOT_SHAPES, L2_SHAPES, _codes, _l2_inputs

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


def test_missing_nvcc_raises(monkeypatch):
    """No compiler means an error, never a silent fall back to ref."""
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()
