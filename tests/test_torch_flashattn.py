"""The port's attention against the JAX package's, on the CPU.

The port's ``kernels.flashattn.ops.flash_attention`` runs its plain
full-matrix version here (the tensors lie on the CPU), held against the
JAX Pallas kernel in interpret mode and against its ``use_ref=True`` oracle
over the five shapes of ``tests/test_flashattn.py``, to rtol/atol 2e-5 (the
same f32 math summed in another order).  The port's blockwise
``models.common.flash_attention`` is held against the reference's
``repro.models.common.flash_attention``: 2e-5 in f32, 2e-2 with bf16
inputs (both round p to bf16 before the PV product, but at other points of
the sum).  The CUDA kernel itself is held against the plain version in
``tests/test_torch_cuda.py`` (marker ``cuda``); on bf16 inputs, to the
bound of ``ref.err_ratio``, whose reach is checked here on the kernels'
arithmetic: the CUDA-core kernel's (p and sums in f32, the output rounded
to bf16) and the tensor-core kernel's (bf16 products, p split into two
bf16 terms for the PV product, f32 sums, the output rounded once).

The backward: ``ref.attention_bwd_ref`` (the backward kernel's plain
version), the CPU backward of ``ops.FlashAttentionFn`` and autograd through
the port's blockwise attention are held against ``jax.grad`` of the
reference's blockwise ``flash_attention`` (whose scan the JAX package
trains through) to rtol/atol 1e-4 in f32 (the same gradient by explicit
formulas against autodiff of an online softmax, summed in other orders);
``ref.grad_err_ratio``'s reach is checked on the backward kernels'
arithmetic: the float32 kernel's (f32 sums, each gradient rounded to bf16
once) and the bf16 tensor-core kernel's (bf16 products with f32 sums, P from
the forward's lse, P and dS as two bf16 terms, one rounding), the latter
against ``jax.vjp`` of the reference's blockwise attention.  The plain
forward's lse (log2 units) is held against ``torch.logsumexp`` in f64 to
rtol/atol 1e-6.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.kernels.flashattn.ops import flash_attention as ref_flash_kernel
from repro.models.common import flash_attention as ref_blockwise

from repro_torch.kernels.flashattn import ops as flash_ops
from repro_torch.kernels.flashattn import ref as flash_ref
from repro_torch.models import common

torch.set_num_threads(1)

CASES = [
    # B, S, H, KV, hd, causal, window, bq, bk  (tests/test_flashattn.py)
    (2, 64, 4, 2, 32, True, None, 16, 16),
    (1, 100, 6, 3, 16, True, None, 32, 32),      # S not divisible by blocks
    (2, 128, 4, 4, 32, True, 32, 32, 32),        # sliding window
    (1, 64, 2, 1, 64, False, None, 16, 16),      # bidirectional
    (1, 48, 8, 2, 16, True, 16, 16, 16),         # window + GQA
]


def _qkv(B, S, H, KV, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, H, hd)).astype(np.float32),
            rng.normal(size=(B, S, KV, hd)).astype(np.float32),
            rng.normal(size=(B, S, KV, hd)).astype(np.float32))


@pytest.mark.parametrize("B,S,H,KV,hd,causal,window,bq,bk", CASES)
def test_flash_ops_match_reference_kernel(B, S, H, KV, hd, causal, window,
                                          bq, bk):
    q, k, v = _qkv(B, S, H, KV, hd, seed=S + H)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    kern = ref_flash_kernel(jq, jk, jv, causal=causal, window=window,
                            bq=bq, bk=bk)
    oracle = ref_flash_kernel(jq, jk, jv, causal=causal, window=window,
                              use_ref=True)
    before = flash_ops.LAUNCHES["flash_attention"]
    out = flash_ops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                    causal=causal, window=window)
    assert flash_ops.LAUNCHES["flash_attention"] == before
    assert out.shape == (B, S, H, hd) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(kern),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(oracle),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("B,S,H,KV,hd,causal,window,bq,bk", CASES)
def test_blockwise_matches_reference(B, S, H, KV, hd, causal, window, bq, bk,
                                     dtype, tol):
    q, k, v = _qkv(B, S, H, KV, hd, seed=S + H + 1)
    jx = [jnp.asarray(x).astype(getattr(jnp, dtype)) for x in (q, k, v)]
    want = ref_blockwise(*jx, causal=causal, window=window,
                         block_q=bq, block_k=bk)
    tx = [torch.from_numpy(x).to(getattr(torch, dtype)) for x in (q, k, v)]
    got = common.flash_attention(*tx, causal=causal, window=window,
                                 block_q=bq, block_k=bk)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("S,window", [(1000, None), (1000, 100), (321, 7)])
def test_bf16_bound_holds_rounding_and_sees_one_missing_key(S, window):
    """The full-matrix version computes as the kernel does: f32 scores, p
    and sums, the output rounded to bf16.  Against the plain blockwise
    version in f32 on the same values it stays within ``err_ratio``'s
    bound; a window one key short (one key missing from the last row, or
    from each row the window reaches), or p rounded to bf16 before the PV
    product, breaks it."""
    q, k, v = (torch.from_numpy(x).bfloat16()
               for x in _qkv(1, S, 4, 2, 64, seed=S))
    want = common.flash_attention(q.float(), k.float(), v.float(),
                                  window=window)
    assert flash_ref.err_ratio(flash_ops.flash_attention(
        q, k, v, window=window), want) <= 1.0
    cut = S - 1 if window is None else window - 1
    assert flash_ref.err_ratio(flash_ops.flash_attention(
        q, k, v, window=cut), want) > 1.0
    assert flash_ref.err_ratio(common.flash_attention(
        q, k, v, window=window), want) > 1.0


def _tensor_core_arithmetic(q, k, v, window, split=True, block=128,
                            return_lse=False):
    """The bf16 tensor-core kernel's arithmetic on the CPU: scores from bf16
    q·k products summed in f32, an online softmax over 128-key tiles in f32
    (exp2 with the scale folded in), p carried into the PV product as
    bf16(p) + bf16(p − bf16(p)) (or as bf16(p) alone when ``split`` is
    False), PV summed in f32, the row sums from the f32 p, and the output
    rounded to bf16 once; with ``return_lse`` also each row's m + log2(l)
    [B, H, S] from the final running max and sum, as the kernel writes it
    for the backward."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    qf = q.float().transpose(1, 2)                           # [B, H, S, hd]
    kf = k.float().repeat_interleave(G, 2).transpose(1, 2)
    vf = v.float().repeat_interleave(G, 2).transpose(1, 2)
    scale = math.log2(math.e) / math.sqrt(hd)
    pos = torch.arange(S)
    m = torch.full((B, H, S, 1), -1e30)
    l = torch.zeros((B, H, S, 1))
    acc = torch.zeros((B, H, S, hd))
    for k0 in range(0, S, block):
        kpos = pos[k0:k0 + block]
        ok = kpos[None, :] <= pos[:, None]
        if window is not None:
            ok &= pos[:, None] - kpos[None, :] < window
        s = torch.where(ok, qf @ kf[:, :, k0:k0 + block].transpose(-1, -2),
                        torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True) * scale)
        corr = torch.exp2(m - m_new)
        p = torch.where(ok, torch.exp2(s * scale - m_new), torch.tensor(0.0))
        p_hi = p.bfloat16().float()
        p_lo = (p - p_hi).bfloat16().float() if split else 0.0
        acc = acc * corr + (p_hi + p_lo) @ vf[:, :, k0:k0 + block]
        l = l * corr + p.sum(-1, keepdim=True)
        m = m_new
    out = (acc / l).transpose(1, 2).bfloat16()
    if return_lse:
        return out, (m + torch.log2(l))[..., 0]
    return out


@pytest.mark.parametrize("S,window", [(1000, None), (1000, 100), (321, 7)])
def test_bf16_bound_holds_the_tensor_core_arithmetic(S, window):
    """The tensor-core kernel's arithmetic (bf16 products, p split in two
    bf16 terms, f32 sums, one rounding) stays within ``err_ratio``'s bound
    against the plain blockwise version in f32 on the same values; the same
    arithmetic with p in one bf16 term breaks it."""
    q, k, v = (torch.from_numpy(x).bfloat16()
               for x in _qkv(1, S, 4, 2, 64, seed=S))
    want = common.flash_attention(q.float(), k.float(), v.float(),
                                  window=window)
    assert flash_ref.err_ratio(_tensor_core_arithmetic(q, k, v, window),
                               want) <= 1.0
    assert flash_ref.err_ratio(_tensor_core_arithmetic(
        q, k, v, window, split=False), want) > 1.0


def test_blockwise_jnp_backend_and_ragged_blocks():
    """``backend="jnp"`` is the same plain code; a block size that divides
    neither S nor the other block leaves no NaN in any row."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 77, 4, 2, 16, seed=5))
    a = common.flash_attention(q, k, v, window=9, block_q=20, block_k=12)
    b = common.flash_attention(q, k, v, window=9, block_q=20, block_k=12,
                               backend="jnp")
    full = flash_ops.flash_attention(q, k, v, window=9)
    assert torch.isfinite(a).all()
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(a, full, rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError, match="backend"):
        common.flash_attention(q, k, v, backend="kernel")


def test_flash_ops_check_their_inputs():
    q = torch.zeros(1, 8, 4, 16)
    k = torch.zeros(1, 8, 3, 16)
    with pytest.raises(ValueError, match="multiple"):
        flash_ops.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="match"):
        flash_ops.flash_attention(q, torch.zeros(1, 9, 2, 16),
                                  torch.zeros(1, 9, 2, 16))
    with pytest.raises(TypeError, match="dtype"):
        flash_ops.flash_attention(q.half(), k[:, :, :2].half(),
                                  k[:, :, :2].half())
    with pytest.raises(ValueError, match="window"):
        flash_ops.flash_attention(q, k[:, :, :2], k[:, :, :2], window=0)


# CASES and a ragged S whose blocks divide neither S nor each other
BWD_CASES = CASES + [(1, 77, 4, 2, 16, True, 9, 20, 12)]


@pytest.mark.parametrize("B,S,H,KV,hd,causal,window,bq,bk", BWD_CASES)
def test_attention_bwd_matches_jax_grad(B, S, H, KV, hd, causal, window, bq,
                                        bk):
    """dq, dk and dv (GQA groups summed) of the plain backward, of the
    autograd Function's CPU backward and of autograd through the port's
    blockwise attention, against ``jax.vjp`` of the reference's blockwise
    attention under the same cotangent."""
    q, k, v = _qkv(B, S, H, KV, hd, seed=S + H + 2)
    do = np.random.default_rng(S).normal(size=q.shape).astype(np.float32)
    out, vjp = jax.vjp(lambda a, b, c: ref_blockwise(
        a, b, c, causal=causal, window=window, block_q=bq, block_k=bk),
        *(jnp.asarray(x) for x in (q, k, v)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    before = flash_ops.LAUNCHES["flash_attention_bwd"]
    o = flash_ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(o.numpy(), np.asarray(out), rtol=2e-5,
                               atol=2e-5)
    plain = flash_ref.attention_bwd_ref(tq, tk, tv, o, tdo, causal=causal,
                                        window=window)
    leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    fn = torch.autograd.grad(flash_ops.attention(
        *leaves, causal=causal, window=window), leaves, tdo)
    leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    blockwise = torch.autograd.grad(common.flash_attention(
        *leaves, causal=causal, window=window, block_q=bq, block_k=bk),
        leaves, tdo)
    assert flash_ops.LAUNCHES["flash_attention_bwd"] == before
    for got in (plain, fn, blockwise):
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("S,window", [(1000, None), (1000, 100), (321, 7)])
def test_grad_bound_holds_rounding_and_sees_a_cut_tile(S, window):
    """The backward kernel's arithmetic (f32 sums, each gradient rounded to
    bf16 once) stays within ``grad_err_ratio``'s bound against the plain
    backward in f32 on the same bf16 values; the last 64-row query tile cut
    from the backward (its dO zeroed) breaks it in each of dq, dk and dv,
    and a window one 64-key tile short (the first key tile cut from the last
    rows, causal only) breaks it in dq."""
    q, k, v, do = (torch.from_numpy(x).bfloat16()
                   for x in _qkv(1, S, 4, 2, 64, seed=S) +
                   (np.random.default_rng(S).normal(
                       size=(1, S, 4, 64)).astype(np.float32),))
    o = flash_ops.flash_attention(q, k, v, window=window)
    f32 = [x.float() for x in (q, k, v, o, do)]
    want = flash_ref.attention_bwd_ref(*f32, window=window)
    for g, w in zip(flash_ref.attention_bwd_ref(q, k, v, o, do,
                                                window=window), want):
        assert g.dtype == torch.bfloat16
        assert flash_ref.grad_err_ratio(g, w) <= 1.0
    cut = do.clone()
    cut[:, -64:] = 0
    for g, w in zip(flash_ref.attention_bwd_ref(q, k, v, o, cut,
                                                window=window), want):
        assert flash_ref.grad_err_ratio(g, w) > 1.0
    if window is None:
        dq = flash_ref.attention_bwd_ref(q, k, v, o, do, window=S - 64)[0]
        assert flash_ref.grad_err_ratio(dq, want[0]) > 1.0


def test_flash_attention_bwd_checks_its_inputs():
    q = torch.zeros(1, 8, 4, 16)
    k = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="shape"):
        flash_ops.flash_attention_bwd(q, k, k, q[:, :4], q)
    with pytest.raises(TypeError, match="dtype"):
        flash_ops.flash_attention_bwd(q, k, k, q, q.double())
    with pytest.raises(ValueError, match="multiple"):
        flash_ops.flash_attention_bwd(q, k[:, :, :1].expand(1, 8, 3, 16),
                                      k[:, :, :1].expand(1, 8, 3, 16), q, q)


def _two_terms(x, split):
    """x as the bf16 A fragment a kernel feeds a wgmma: bf16(x) + bf16(x −
    bf16(x)) in f32, or bf16(x) alone when ``split`` is False."""
    hi = x.bfloat16().float()
    return hi + (x - hi).bfloat16().float() if split else hi


def _tensor_core_bwd_arithmetic(q, k, v, o, do, lse, window, split_p=True,
                                split_ds=True):
    """The bf16 backward kernel's arithmetic on the CPU: S = q kᵀ and dP =
    dO vᵀ from bf16 operands summed in f32; P = 2^(S log2(e) / √hd − lse)
    from the forward's lse (log2 units); D = rowsum(dO ∘ o) in f32 from the
    forward's bf16 output; dS = P ∘ (dP − D); P and dS carried into the dV,
    dK and dQ products as two bf16 terms each (one when ``split_p`` /
    ``split_ds`` is False), those products summed in f32, dK and dV over
    each KV head's group, and each gradient rounded to bf16 once."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qf, of, dof = (x.float().transpose(1, 2) for x in (q, o, do))
    kf = k.float().repeat_interleave(G, 2).transpose(1, 2)    # [B, H, S, hd]
    vf = v.float().repeat_interleave(G, 2).transpose(1, 2)
    scale = 1.0 / math.sqrt(hd)
    pos = torch.arange(S)
    ok = pos[None, :] <= pos[:, None]
    if window is not None:
        ok &= pos[:, None] - pos[None, :] < window
    s = qf @ kf.transpose(-1, -2)
    p = torch.where(ok, torch.exp2(s * (scale * math.log2(math.e))
                                   - lse[..., None]), torch.tensor(0.0))
    dp = dof @ vf.transpose(-1, -2)
    ds = p * (dp - (dof * of).sum(-1, keepdim=True))
    pe, dse = _two_terms(p, split_p), _two_terms(ds, split_ds)
    dq = (dse @ kf * scale).transpose(1, 2)
    dk = (dse.transpose(-1, -2) @ qf * scale).transpose(1, 2)
    dv = (pe.transpose(-1, -2) @ dof).transpose(1, 2)
    dk, dv = (x.reshape(B, S, KV, G, hd).sum(3) for x in (dk, dv))
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("S,window", [(1000, None), (1000, 100), (321, 7)])
def test_grad_bound_holds_the_tensor_core_bwd_arithmetic(S, window, hd):
    """The bf16 backward kernel's arithmetic (bf16 products with f32 sums,
    P from the tensor-core forward's lse, P and dS as two bf16 terms, one
    rounding) stays within ``grad_err_ratio``'s bound in dq, dk and dv
    against ``jax.vjp`` of the reference's blockwise attention on the same
    values, with D taken from the reference's own f32 output; P in one bf16
    term breaks it in dv, and dS in one term breaks it in dq and dk.  On
    the forward's bf16 output (the kernel's input on the train path) it
    stays within the bound against the plain backward in f32 on the same
    values, as the card tests hold the kernel.  (Against ``jax.vjp`` that
    rounded output moves D, and dq and dk with it, past the bound in the
    plain backward as much as in this arithmetic: a property of the bf16
    forward, not of the backward.)"""
    rng = np.random.default_rng(S + hd)
    q, k, v, do = (rng.normal(size=shape).astype(np.float32) for shape in (
        (1, S, 4, hd), (1, S, 2, hd), (1, S, 2, hd), (1, S, 4, hd)))
    tq, tk, tv, tdo = (torch.from_numpy(x).bfloat16() for x in (q, k, v, do))
    out, vjp = jax.vjp(lambda a, b, c: ref_blockwise(a, b, c, window=window),
                       *(jnp.asarray(x.float().numpy()) for x in (tq, tk, tv)))
    want = [torch.from_numpy(np.array(g))
            for g in vjp(jnp.asarray(tdo.float().numpy()))]
    o, lse = _tensor_core_arithmetic(tq, tk, tv, window, return_lse=True)

    def ratios(o, want, **split):
        got = _tensor_core_bwd_arithmetic(tq, tk, tv, o, tdo, lse, window,
                                          **split)
        return [flash_ref.grad_err_ratio(g, w) for g, w in zip(got, want)]

    o32 = torch.from_numpy(np.array(out))
    assert max(ratios(o32, want)) <= 1.0
    assert ratios(o32, want, split_p=False)[2] > 1.0
    dq, dk, _ = ratios(o32, want, split_ds=False)
    assert dq > 1.0 and dk > 1.0
    plain = flash_ref.attention_bwd_ref(
        *(x.float() for x in (tq, tk, tv, o, tdo)), window=window)
    assert max(ratios(o, plain)) <= 1.0


@pytest.mark.parametrize("B,S,H,KV,hd,causal,window,bq,bk", BWD_CASES)
def test_plain_forward_lse_is_the_row_logsumexp(B, S, H, KV, hd, causal,
                                                window, bq, bk):
    """``flash_attention(..., return_lse=True)`` on the CPU gives each row's
    log-sum-exp of its masked scaled scores in log2 units, as
    ``torch.logsumexp`` gives it in f64, and the same output as without
    it."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(B, S, H, KV, hd, seed=S))
    out, lse = flash_ops.flash_attention(q, k, v, causal=causal,
                                         window=window, return_lse=True)
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    torch.testing.assert_close(out, flash_ops.flash_attention(
        q, k, v, causal=causal, window=window), rtol=0, atol=0)
    G = H // KV
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(),
                     k.double().repeat_interleave(G, 2)) / math.sqrt(hd)
    pos = torch.arange(S)
    ok = torch.ones((S, S), dtype=torch.bool)
    if causal:
        ok &= pos[:, None] >= pos[None, :]
    if window is not None:
        ok &= pos[:, None] - pos[None, :] < window
    want = torch.logsumexp(s.masked_fill(~ok, float("-inf")), -1) / math.log(2)
    torch.testing.assert_close(lse.double(), want, rtol=1e-6, atol=1e-6)
