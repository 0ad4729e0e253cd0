"""The port's MoE transformer (``repro_torch.models.moe``, the MoE forms of
``models.transformer``, ``interop.lm_params_from_numpy`` on MoE trees and
the four LM configs beside smollm) against the JAX package's, on the CPU,
on the reference's own parameters carried across.

Tolerances: f32 throughout.  ``moe_apply``'s output to rtol/atol 1e-5 (the
same f32 products summed in another order), its ``lb_loss`` and
``z_loss`` to 1e-6 and ``frac_dropped`` to the same count of dropped
entries (the same routing, the same capacity drops); the model's logits from ``forward``, ``prefill`` and each
``decode_step`` to rtol/atol 1e-4, as the dense model's; greedy tokens
identical.  Ties in the router break as ``jax.lax.top_k`` breaks them,
lowest expert first.  The windows follow the reference's two rules
(ROADMAP C.6): a leading dense layer by its index, a scanned layer by its
sub-layer index in one MoE period.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.configs.base import get_arch as ref_get_arch
from repro.data import synthetic as ref_synthetic
from repro.models import moe as ref_moe
from repro.models import transformer as ref_tf
from repro.serve.lm_server import generate as ref_generate

from repro_torch.configs import get_arch
from repro_torch.interop import lm_params_from_numpy
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.serve import generate

torch.set_num_threads(1)

NEW_ARCHS = ("moonshot-v1-16b-a3b", "llama4-maverick-400b-a17b",
             "internlm2-20b", "phi3-mini-3.8b")
ALL_ARCHS = NEW_ARCHS + ("smollm-135m",)
MOONSHOT = ref_get_arch("moonshot-v1-16b-a3b").smoke_cfg
LLAMA4 = ref_get_arch("llama4-maverick-400b-a17b").smoke_cfg
# head layers windowed by their index: layer 1 (1 % 2 == 1) is global,
# the scanned layers (sub-layer j = 0 of a period of 1) windowed
HEAD_WINDOW = dataclasses.replace(MOONSHOT, name="head-window", n_layers=4,
                                  first_dense=2, window=8, window_period=2)
# a period of 2 after one head layer: sub-layer j = 1 is global
PERIOD_WINDOW = dataclasses.replace(LLAMA4, name="period-window",
                                    n_layers=5, first_dense=1, window=8,
                                    window_period=2)


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


def leaves(tree, path=""):
    """{path: tensor} of every tensor in a parameter tree."""
    if isinstance(tree, dict):
        return {k: t for key, v in tree.items()
                for k, t in leaves(v, f"{path}/{key}").items()}
    if isinstance(tree, list):
        return {k: t for i, v in enumerate(tree)
                for k, t in leaves(v, f"{path}/{i}").items()}
    return {path: tree}


# the reference's moe_apply compiled once a shape (op by op it takes seconds)
ref_moe_apply = jax.jit(ref_moe.moe_apply, static_argnums=(2, 3),
                        static_argnames=("n_groups",))


def moe_params(d, f, E, seed):
    """(reference MoE params, the same as tensors)."""
    p = ref_moe.moe_init(jax.random.PRNGKey(seed), d, f, E, jnp.float32)
    return p, {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


# (name, d, f, E, top_k, groups, T, capacity_factor); the widths are
# moonshot's and llama4's smoke configs' (d 64, f 96, E 8)
MOE_CASES = [
    ("moonshot-k2", 64, 96, 8, 2, 1, 64, 1.25),
    ("moonshot-k6-g2", 64, 96, 8, 6, 2, 96, 1.25),
    ("llama4-k1", 64, 96, 8, 1, 1, 200, 1.25),
    ("llama4-k1-g2", 64, 96, 8, 1, 2, 64, 1.25),
    ("groups-lowered", 64, 96, 8, 2, 4, 30, 1.25),     # G 4 → 3
    ("drops-k2-g2", 64, 96, 8, 2, 2, 256, 1.0),
    ("drops-k6", 64, 96, 8, 6, 1, 128, 0.5),
]


@pytest.mark.parametrize("case", MOE_CASES, ids=[c[0] for c in MOE_CASES])
def test_moe_apply_matches_reference(case):
    name, d, f, E, k, G, T, cf = case
    ref_p, p = moe_params(d, f, E, seed=T)
    x = np.random.default_rng(T).normal(size=(T, d)).astype(np.float32)
    want, want_aux = ref_moe_apply(ref_p, jnp.asarray(x), k, cf,
                                   n_groups=G)
    got, aux = moe.moe_apply(p, torch.from_numpy(x), k, cf, n_groups=G)
    assert got.shape == (T, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # the same entries dropped (the compiled reference's mean rounds
    # otherwise in the last bits, to -7e-9 where nothing is dropped)
    n_drop = round(float(aux["frac_dropped"]) * T * k)
    assert n_drop == round(float(want_aux["frac_dropped"]) * T * k)
    np.testing.assert_allclose(float(aux["frac_dropped"]),
                               float(want_aux["frac_dropped"]), atol=1e-7)
    if name.startswith("drops"):
        assert float(aux["frac_dropped"]) > 0
    for key in ("lb_loss", "z_loss"):
        np.testing.assert_allclose(float(aux[key]), float(want_aux[key]),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("k", [1, 2, 6])
def test_zeroed_router_routes_to_the_lowest_experts(k):
    """All probabilities equal: experts 0 .. k−1, each with gate 1/k, as
    ``jax.lax.top_k`` picks them (``torch.topk`` would pick others)."""
    d, f, E, T = 16, 24, 8, 4
    ref_p, p = moe_params(d, f, E, seed=k)
    ref_p = {**ref_p, "router": jnp.zeros_like(ref_p["router"])}
    p["router"] = torch.zeros_like(p["router"])
    x = torch.from_numpy(
        np.random.default_rng(k).normal(size=(T, d)).astype(np.float32))
    got, aux = moe.moe_apply(p, x, k)
    want = sum(torch.nn.functional.silu(x @ p["w_gate"][e])
               * (x @ p["w_up"][e]) @ p["w_down"][e] for e in range(k)) / k
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    ref_out, _ = ref_moe_apply(ref_p, jnp.asarray(x.numpy()), k, 1.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_out), rtol=1e-5,
                               atol=1e-5)
    assert float(aux["frac_dropped"]) == 0.0


def test_capacity_is_the_reference():
    """The integer ceiling before the float multiply, at least 8, at most
    Tg·k; groups lowered until they divide T."""
    assert moe.capacity(32768, 6, 64) == (1, 3840)
    assert moe.capacity(1024, 6, 64) == (1, 120)
    assert moe.capacity(8, 6, 64) == (1, 8)
    assert moe.capacity(8, 6, 64, capacity_factor=64) == (1, 48)
    assert moe.capacity(30, 2, 8, n_groups=4) == (3, 8)
    assert moe.capacity(2, 1, 8, n_groups=4) == (2, 1)


FORWARD_CFGS = [ref_get_arch(a).smoke_cfg for a in NEW_ARCHS] + [
    HEAD_WINDOW, PERIOD_WINDOW]


@pytest.mark.parametrize("cfg", FORWARD_CFGS, ids=lambda c: c.name)
def test_forward_prefill_and_aux_match_reference(cfg):
    """B = 2, S = 40: past llama4's smoke window of 16, so C.6's rule shows
    (every layer windowed)."""
    params, pparams = carried(cfg)
    toks = tokens(cfg, 2, 40)
    want, want_aux = jax.jit(lambda p, t: ref_tf.forward(cfg, p, t))(
        params, jnp.asarray(toks))
    pc = port_cfg(cfg)
    got, aux = tf.forward_aux(pc, pparams, torch.from_numpy(toks))
    assert got.shape == (2, 40, cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    for key in tf.AUX_KEYS:
        np.testing.assert_allclose(float(aux[key]), float(want_aux[key]),
                                   rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(tf.forward(pc, pparams,
                                          torch.from_numpy(toks)), got,
                               rtol=0, atol=0)
    last, last_aux = tf.prefill_aux(pc, pparams, torch.from_numpy(toks))
    np.testing.assert_allclose(
        last.numpy(), np.asarray(ref_tf.prefill(cfg, params,
                                                jnp.asarray(toks))),
        rtol=1e-4, atol=1e-4)
    assert float(last_aux["frac_dropped"]) == float(aux["frac_dropped"])


@pytest.mark.parametrize("cfg,want", [
    (LLAMA4, [16] * 4),
    (HEAD_WINDOW, [8, None, 8, 8]),
    (dataclasses.replace(HEAD_WINDOW, n_layers=3, first_dense=1), [8] * 3),
    (PERIOD_WINDOW, [8, 8, None, 8, None]),
], ids=["llama4", "head-2", "head-1", "period-2"])
def test_windows_follow_the_reference_rules(cfg, want):
    """C.6: llama4's every layer windowed; a head layer by its index, a
    scanned layer by its sub-layer index; and the windows bite at S = 40
    (the logits move when they are taken away)."""
    pc = port_cfg(cfg)
    assert [tf._layer_window(pc, i) for i in range(cfg.n_layers)] == want
    _, pparams = carried(cfg)
    toks = torch.from_numpy(tokens(cfg, 1, 40))
    full = dataclasses.replace(pc, window=None)
    assert float((tf.prefill(pc, pparams, toks)
                  - tf.prefill(full, pparams, toks)).abs().max()) > 1e-3


@pytest.mark.parametrize("cfg", [MOONSHOT, LLAMA4], ids=lambda c: c.name)
def test_decode_steps_match_reference(cfg):
    """Step a prompt through ``decode_step`` (a T = B dispatch a layer):
    the logits agree with the reference's at every step, and the cache's
    K of the last layer with the reference's stack."""
    params, pparams = carried(cfg)
    B, P, max_seq = 2, 20, 24
    toks = tokens(cfg, B, P, seed=1)
    step = jax.jit(lambda p, c, t: ref_tf.decode_step(cfg, p, c, t))
    cache = ref_tf.init_cache(cfg, B, max_seq)
    pc = port_cfg(cfg)
    pcache = tf.init_cache(pc, B, max_seq, device="cpu")
    assert pcache["k"].shape == (cfg.n_layers, B, max_seq, cfg.n_kv_heads,
                                 cfg.hd)
    for t in range(P):
        want, cache = step(params, cache, jnp.asarray(toks[:, t]))
        got, pcache = tf.decode_step(pc, pparams, pcache,
                                     torch.from_numpy(toks[:, t]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)
    period = cfg.moe_period
    np.testing.assert_allclose(
        pcache["k"][-1].numpy(), np.asarray(cache["scan"][period - 1]["k"][-1]),
        rtol=1e-5, atol=1e-5)


def test_decode_equals_prefill_without_drops():
    """With a capacity at which prefill drops nothing, stepping the prompt
    gives prefill's last logits (decode never drops: T = B)."""
    cfg = port_cfg(dataclasses.replace(MOONSHOT, capacity_factor=8.0))
    _, pparams = carried(MOONSHOT)
    toks = torch.from_numpy(tokens(MOONSHOT, 2, 16, seed=3))
    last, aux = tf.prefill_aux(cfg, pparams, toks)
    assert float(aux["frac_dropped"]) == 0.0
    cache = tf.init_cache(cfg, 2, 16, device="cpu")
    for t in range(16):
        logits, cache = tf.decode_step(cfg, pparams, cache, toks[:, t])
    torch.testing.assert_close(logits, last, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cfg", [MOONSHOT, LLAMA4], ids=lambda c: c.name)
def test_generate_greedy_matches_reference(cfg):
    params, pparams = carried(cfg)
    prompt = tokens(cfg, 2, 6, seed=2)
    want = ref_generate(cfg, params, jnp.asarray(prompt), max_new=8,
                        max_seq=16)
    got = generate(port_cfg(cfg), pparams, torch.from_numpy(prompt),
                   max_new=8, max_seq=16)
    assert got.dtype == torch.int32 and got.shape == (2, 14)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_counts_are_the_reference(arch):
    ref = ref_get_arch(arch)
    cfg = get_arch(arch).model_cfg
    assert cfg.param_count() == ref.model_cfg.param_count()
    assert cfg.active_param_count() == ref.model_cfg.active_param_count()


@pytest.mark.parametrize("cfg", FORWARD_CFGS, ids=lambda c: c.name)
def test_carried_and_port_params_count(cfg):
    """The carried tree and the port's own init hold ``param_count()``
    parameters, in the same layer structure."""
    _, carried_p = carried(cfg)
    pc = port_cfg(cfg)
    own = tf.init(pc, torch.Generator().manual_seed(0), device="cpu")
    for params in (carried_p, own):
        assert sum(t.numel() for t in leaves(params).values()) \
            == pc.param_count() == cfg.param_count()
    assert {k: (t.shape, t.dtype) for k, t in leaves(carried_p).items()} \
        == {k: (t.shape, t.dtype) for k, t in leaves(own).items()}


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_lm_config_is_the_reference(arch):
    spec, ref = get_arch(arch), ref_get_arch(arch)
    assert spec.model_cfg == port_cfg(ref.model_cfg)
    assert spec.smoke_cfg == port_cfg(ref.smoke_cfg)
    assert spec.shapes["prefill_32k"].dims == ref.shapes["prefill_32k"].dims
    assert spec.source == ref.source
