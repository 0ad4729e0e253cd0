"""The port's LM (``repro_torch.models``, ``serve.lm_server``) against the
JAX package's, on the CPU, on the reference's own parameters carried across
with ``interop.lm_params_from_numpy``.

Tolerances: f32 models throughout; logits of ``forward``, ``prefill`` and
each ``decode_step`` to rtol/atol 1e-4 (the same f32 math, summed in
another order by another BLAS); the building blocks to 1e-5; greedy tokens
identical.  The windowed GQA config pins the reference's per-period window
choice (ROADMAP C.6): with ``window_period=2`` every layer of a dense model
is windowed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.configs.base import get_arch as ref_get_arch
from repro.data import synthetic as ref_synthetic
from repro.models import common as ref_common
from repro.models import transformer as ref_tf
from repro.serve.lm_server import generate as ref_generate

from repro_torch import data as port_data
from repro_torch.configs import get_arch
from repro_torch.interop import lm_params_from_numpy
from repro_torch.models import common
from repro_torch.models import transformer as tf
from repro_torch.serve import generate

torch.set_num_threads(1)

SMOKE = ref_get_arch("smollm-135m").smoke_cfg
GQA_WINDOW = ref_tf.LMConfig(name="gqa-window", n_layers=2, d_model=32,
                             n_heads=4, n_kv_heads=2, d_ff=64, vocab=128,
                             window=8, window_period=2, dtype=jnp.float32)
TINY = ref_tf.LMConfig(name="tiny", n_layers=1, d_model=16, n_heads=2,
                       n_kv_heads=1, d_ff=32, vocab=64, dtype=jnp.float32)
# (reference config, B, S): S = 600 is no multiple of the 512-row blocks
FORWARD_CASES = [(SMOKE, 2, 24), (GQA_WINDOW, 2, 24), (TINY, 1, 600)]


def port_cfg(cfg) -> tf.LMConfig:
    """The port's LMConfig with the reference config's fields."""
    fields = {f.name for f in dataclasses.fields(tf.LMConfig)} - {"dtype"}
    kw = {k: getattr(cfg, k) for k in fields}
    return tf.LMConfig(**kw, dtype=getattr(torch, jnp.dtype(cfg.dtype).name))


def carried(cfg, seed=0):
    """(reference params, the port's params from them on the CPU)."""
    params = ref_tf.init(cfg, jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, params)
    return params, lm_params_from_numpy(port_cfg(cfg), tree, device="cpu")


def tokens(cfg, B, S, seed=0):
    lm = ref_synthetic.make_markov_lm(cfg.vocab, seed=seed)
    return ref_synthetic.lm_batch(lm, B, S, step=0, seed=seed)[0]


def test_building_blocks_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    gamma = rng.normal(size=(16,)).astype(np.float32)
    np.testing.assert_allclose(
        common.rms_norm(torch.from_numpy(x), torch.from_numpy(gamma)).numpy(),
        np.asarray(ref_common.rms_norm(jnp.asarray(x), jnp.asarray(gamma))),
        rtol=1e-5, atol=1e-5)
    pos = np.array([[0, 1, 2, 3, 40000]] * 2, np.int32)
    np.testing.assert_allclose(
        common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos)).numpy(),
        np.asarray(ref_common.apply_rope(jnp.asarray(x), jnp.asarray(pos))),
        rtol=1e-5, atol=1e-5)
    B, S, H, KV, hd = 3, 20, 4, 2, 16
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    kc = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    vc = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    p = np.array([1, 7, 20], np.int32)
    for window in (None, 5):
        want = ref_common.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                           jnp.asarray(vc), jnp.asarray(p),
                                           window=window)
        got = common.decode_attention(*(torch.from_numpy(a)
                                        for a in (q, kc, vc, p)),
                                      window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cfg", [SMOKE, GQA_WINDOW, TINY],
                         ids=lambda c: c.name)
def test_carried_params_count(cfg):
    _, params = carried(cfg)
    leaves = [params["embed"], params["unembed"], params["ln_f"]]
    for layer in params["layers"]:
        leaves += [t for t in layer.values() if torch.is_tensor(t)]
        leaves += list(layer["ffn"].values())
    assert sum(t.numel() for t in leaves) == port_cfg(cfg).param_count() \
        == cfg.param_count()
    assert params["layers"][0]["wq"].dtype == torch.float32


def test_smollm_config_is_the_reference():
    spec, ref = get_arch("smollm-135m"), ref_get_arch("smollm-135m")
    assert spec.model_cfg == port_cfg(ref.model_cfg)
    assert spec.smoke_cfg == port_cfg(ref.smoke_cfg)
    assert spec.model_cfg.param_count() == ref.model_cfg.param_count()
    assert spec.shapes["prefill_32k"].dims == ref.shapes["prefill_32k"].dims
    assert spec.source == ref.source


@pytest.mark.parametrize("cfg,B,S", FORWARD_CASES,
                         ids=[c.name for c, _, _ in FORWARD_CASES])
def test_forward_and_prefill_match_reference(cfg, B, S):
    params, pparams = carried(cfg)
    toks = tokens(cfg, B, S)
    want, _ = jax.jit(lambda p, t: ref_tf.forward(cfg, p, t))(
        params, jnp.asarray(toks))
    want_last = ref_tf.prefill(cfg, params, jnp.asarray(toks))
    pc = port_cfg(cfg)
    got = tf.forward(pc, pparams, torch.from_numpy(toks))
    assert got.shape == (B, S, cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    last = tf.prefill(pc, pparams, torch.from_numpy(toks))
    np.testing.assert_allclose(last.numpy(), np.asarray(want_last),
                               rtol=1e-4, atol=1e-4)
    plain = tf.prefill(pc, pparams, torch.from_numpy(toks), backend="jnp")
    torch.testing.assert_close(plain, last, rtol=0, atol=0)


@pytest.mark.parametrize("cfg", [SMOKE, GQA_WINDOW], ids=lambda c: c.name)
def test_decode_steps_match_reference(cfg):
    """Step a prompt through ``decode_step``: the logits agree with the
    reference's at every step, and the last step's with ``prefill``."""
    params, pparams = carried(cfg)
    B, P, max_seq = 2, 12, 16
    toks = tokens(cfg, B, P, seed=1)
    step = jax.jit(lambda p, c, t: ref_tf.decode_step(cfg, p, c, t))
    cache = ref_tf.init_cache(cfg, B, max_seq)
    pc = port_cfg(cfg)
    pcache = tf.init_cache(pc, B, max_seq, device="cpu")
    for t in range(P):
        want, cache = step(params, cache, jnp.asarray(toks[:, t]))
        got, pcache = tf.decode_step(pc, pparams, pcache,
                                     torch.from_numpy(toks[:, t]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)
    assert pcache["pos"].tolist() == [P] * B
    np.testing.assert_allclose(
        pcache["k"].numpy(), np.asarray(cache["scan"][0]["k"]),
        rtol=1e-5, atol=1e-5)
    last = tf.prefill(pc, pparams, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), last.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_generate_greedy_matches_reference():
    params, pparams = carried(SMOKE)
    prompt = tokens(SMOKE, 2, 6, seed=2)
    want = ref_generate(SMOKE, params, jnp.asarray(prompt), max_new=8,
                        max_seq=16)
    got = generate(port_cfg(SMOKE), pparams, torch.from_numpy(prompt),
                   max_new=8, max_seq=16)
    assert got.dtype == torch.int32 and got.shape == (2, 14)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    sampled = generate(port_cfg(SMOKE), pparams, torch.from_numpy(prompt),
                       max_new=8, max_seq=16, temperature=1.0,
                       gen=torch.Generator().manual_seed(3))
    assert sampled.shape == (2, 14)
    np.testing.assert_array_equal(sampled[:, :6].numpy(), prompt)
    assert int(sampled.min()) >= 0 and int(sampled.max()) < SMOKE.vocab


def test_markov_data_matches_reference():
    for vocab, branch, seed in ((512, 4, 0), (49152, 3, 7)):
        ref_lm = ref_synthetic.make_markov_lm(vocab, branch, seed)
        lm = port_data.make_markov_lm(vocab, branch, seed)
        np.testing.assert_array_equal(lm.succ, ref_lm.succ)
        assert lm.entropy() == ref_lm.entropy()
        for a, b in zip(port_data.lm_batch(lm, 3, 50, step=4, seed=seed),
                        ref_synthetic.lm_batch(ref_lm, 3, 50, step=4,
                                               seed=seed)):
            np.testing.assert_array_equal(a, b)


def test_moe_config_runs_on_cpu():
    """``init``, ``param_count``, ``init_cache`` and ``forward`` on a MoE
    smoke config (leading dense layer, shared experts) on the CPU."""
    cfg = get_arch("moonshot-v1-16b-a3b").smoke_cfg
    params = tf.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    n = sum(t.numel() for p in params["layers"] for t in
            [*(x for x in p.values() if torch.is_tensor(x)),
             *(t for x in p.values() if isinstance(x, dict)
               for t in x.values())])
    n += sum(params[k].numel() for k in ("embed", "unembed", "ln_f"))
    assert n == cfg.param_count()
    assert ["moe" in p for p in params["layers"]] == [False, True, True]
    cache = tf.init_cache(cfg, 2, 8, device="cpu")
    assert cache["k"].shape == (cfg.n_layers, 2, 8, cfg.n_kv_heads, cfg.hd)
    logits = tf.forward(cfg, params, torch.zeros(2, 5, dtype=torch.int32))
    assert logits.shape == (2, 5, cfg.vocab) and torch.isfinite(logits).all()


def test_lm_params_from_numpy_refuses_a_wrong_layer_count():
    tree = jax.tree.map(np.asarray, ref_tf.init(SMOKE, jax.random.PRNGKey(0)))
    for cfg in (dataclasses.replace(port_cfg(SMOKE), n_layers=4),
                dataclasses.replace(port_cfg(SMOKE), first_dense=1),
                # the right depth, the wrong MoE layout: one dense stack
                # where the config has 3 sub-stacks, or has every layer MoE
                dataclasses.replace(port_cfg(SMOKE), n_experts=4,
                                    moe_period=3),
                dataclasses.replace(port_cfg(SMOKE), n_experts=4)):
        with pytest.raises(ValueError, match="layers"):
            lm_params_from_numpy(cfg, tree, device="cpu")


def test_port_init_runs_on_cpu():
    cfg = get_arch("smollm-135m").smoke_cfg
    params = tf.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    logits = tf.prefill(cfg, params, torch.zeros(2, 5, dtype=torch.int32))
    assert logits.shape == (2, cfg.vocab) and torch.isfinite(logits).all()


def test_lm_entry_points_raise_without_a_card(monkeypatch):
    """The LM entry points that make state default to the card and do not
    drop to the CPU on their own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_arch("smollm-135m").smoke_cfg
    with pytest.raises(RuntimeError, match="cuda"):
        tf.init(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        tf.init_cache(cfg, 1, 8)
    tree = jax.tree.map(np.asarray, ref_tf.init(SMOKE, jax.random.PRNGKey(0)))
    with pytest.raises(RuntimeError, match="cuda"):
        lm_params_from_numpy(cfg, tree)
