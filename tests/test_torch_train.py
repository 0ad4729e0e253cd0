"""The port's training path (``repro_torch.optim``, ``train``,
``transformer.loss_fn``, ``checkpoint`` with bf16 state,
``launch.train``) against the JAX package's, on the CPU, on numpy-seeded
inputs and the reference's own parameters carried across.

Tolerances, each the same f32 math summed in another order by another
BLAS unless said otherwise: AdamW's f32 leaves to rtol 1e-5 / atol 1e-7,
its bf16 leaves to one bf16 ulp (rtol 2^-7: an f32 value a few ulps off
can round to the neighbouring bf16); ``loss_fn`` to rtol 1e-5 and its
gradients to rtol 1e-4 / atol 1e-6 of each leaf's largest magnitude;
train steps' losses to rtol 1e-5 and parameters to atol 1e-5 after three
AdamW steps at lr 1e-3 (an update moves each weight by at most ~lr, and
m / √v of a gradient near zero amplifies its rounding).  Remat changes no
bit, and the port's own runs (crash-resume, checkpoints) are bitwise.
"""

import dataclasses
import json
import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.checkpoint import manager as ref_ckpt
from repro.configs.base import get_arch as ref_get_arch
from repro.data import synthetic as ref_synthetic
from repro.models import transformer as ref_tf
from repro.optim import OptConfig as RefOptConfig
from repro.optim import adamw_init as ref_adamw_init
from repro.optim import adamw_update as ref_adamw_update
from repro.train import TrainState as RefTrainState
from repro.train import make_train_step as ref_make_train_step

from repro_torch.checkpoint import CheckpointManager, restore_latest
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_arch
from repro_torch.data import lm_batch, make_markov_lm
from repro_torch.interop import (lm_params_from_numpy, lm_params_to_numpy,
                                 train_state_from_numpy)
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as tf
from repro_torch.optim import OptConfig, adamw_init, adamw_update
from repro_torch.optim.adamw import tree_leaves, tree_unflatten
from repro_torch.serve import generate
from repro_torch.train import TrainState, make_train_step

torch.set_num_threads(1)

SMOLLM = ref_get_arch("smollm-135m").smoke_cfg
MOONSHOT = ref_get_arch("moonshot-v1-16b-a3b").smoke_cfg


def port_cfg(cfg) -> tf.LMConfig:
    """The port's LMConfig with the reference config's fields."""
    fields = {f.name for f in dataclasses.fields(tf.LMConfig)} - {"dtype"}
    kw = {k: getattr(cfg, k) for k in fields}
    return tf.LMConfig(**kw, dtype=getattr(torch, jnp.dtype(cfg.dtype).name))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(vocab, B, S, step=0):
    lm = ref_synthetic.make_markov_lm(vocab, seed=0)
    return ref_synthetic.lm_batch(lm, B, S, step=step, seed=0)


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------

def _opt_tree(rng):
    """A small tree of f32 and bf16 leaves (as numpy f32 values)."""
    return {"a": rng.normal(size=(5, 3)).astype(np.float32),
            "b": [rng.normal(size=(7,)).astype(np.float32),
                  rng.normal(size=(2, 2, 3)).astype(np.float32)],
            "c": {"w": rng.normal(size=(4, 6)).astype(np.float32)}}


BF16_LEAVES = ("b/0", "c/w")      # carried as bf16 in both packages


def _as_ref(tree, bf16):
    return {"a": jnp.asarray(tree["a"]),
            "b": [jnp.asarray(tree["b"][0]).astype(
                jnp.bfloat16 if bf16 else jnp.float32),
                jnp.asarray(tree["b"][1])],
            "c": {"w": jnp.asarray(tree["c"]["w"]).astype(
                jnp.bfloat16 if bf16 else jnp.float32)}}


def _as_port(tree, bf16):
    t = lambda x, b=False: torch.from_numpy(x).to(  # noqa: E731
        torch.bfloat16 if b else torch.float32)
    return {"a": t(tree["a"]), "b": [t(tree["b"][0], bf16), t(tree["b"][1])],
            "c": {"w": t(tree["c"]["w"], bf16)}}


def _close(port_leaf, ref_leaf, bf16):
    got = port_leaf.float().numpy()
    want = np.asarray(jnp.asarray(ref_leaf).astype(jnp.float32))
    if bf16:
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=1e-30)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("state_bf16", [False, True])
@pytest.mark.parametrize("clip", [None, 1.0, 1e-2])
@pytest.mark.parametrize("schedule", ["cosine", "linear", "const"])
def test_adamw_matches_reference(schedule, clip, state_bf16):
    """Four updates of bf16 and f32 leaves from the same gradients: params,
    moments, step, lr and grad_norm.  clip 1e-2 binds, 1.0 does not.  The
    data's seed is a CRC of the case, the same in every process.  A bf16
    leaf's rtol 2⁻⁷ is one bf16 ulp at the bottom of a binade and two at
    its top: each update rounds a moment and a parameter once from an f32
    value that the packages' orders leave a few f32 ulps apart, which can
    land on neighbouring bf16 values; over 1,800 random seeds of
    [linear-0.01-True] and 300 of every other case none failed, and the
    largest reading was one bf16 ulp."""
    rng = np.random.default_rng(zlib.crc32(
        repr((schedule, clip, state_bf16)).encode()))
    params = _opt_tree(rng)
    kw = dict(lr=1e-2, schedule=schedule, clip_norm=clip, warmup_steps=2,
              total_steps=6, weight_decay=0.1)
    rcfg = RefOptConfig(**kw, state_dtype=jnp.bfloat16 if state_bf16
                        else jnp.float32)
    pcfg = OptConfig(**kw, state_dtype=torch.bfloat16 if state_bf16
                     else torch.float32)
    rp, pp = _as_ref(params, True), _as_port(params, True)
    rs, ps = ref_adamw_init(rp, rcfg), adamw_init(pp, pcfg)
    for _ in range(4):
        g = _opt_tree(rng)
        rp, rs, rm = ref_adamw_update(_as_ref(g, True), rs, rp, rcfg)
        pp, ps, pm = adamw_update(_as_port(g, True), ps, pp, pcfg)
        np.testing.assert_allclose(float(pm["lr"]), float(rm["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-5)
    assert int(ps["step"]) == int(rs["step"]) == 4
    for key, getter in (("a", lambda t: t["a"]), ("b/0", lambda t: t["b"][0]),
                        ("b/1", lambda t: t["b"][1]),
                        ("c/w", lambda t: t["c"]["w"])):
        _close(getter(pp), getter(rp), key in BF16_LEAVES)
        assert getter(pp).dtype == (torch.bfloat16 if key in BF16_LEAVES
                                    else torch.float32)
        for moment in ("m", "v"):
            _close(getter(ps[moment]), getter(rs[moment]), state_bf16)
            assert getter(ps[moment]).dtype == pcfg.state_dtype


# --------------------------------------------------------------------------
# loss_fn, gradients, remat
# --------------------------------------------------------------------------

def _carried(cfg, seed=0):
    params = ref_tf.init(cfg, jax.random.PRNGKey(seed))
    return params, lm_params_from_numpy(port_cfg(cfg), _np(params),
                                        device="cpu")


def _port_loss_and_grads(cfg, params, toks, tgts, remat=True):
    leaves = [p.detach().clone().requires_grad_(True)
              for p in tree_leaves(params)]
    loss, metrics = tf.loss_fn(port_cfg(cfg), tree_unflatten(params, leaves),
                               torch.from_numpy(toks), torch.from_numpy(tgts),
                               remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        tree_unflatten(params, list(grads))


@pytest.mark.parametrize("cfg", [SMOLLM, MOONSHOT], ids=["smollm", "moonshot"])
def test_loss_and_grads_match_reference(cfg):
    """``loss_fn`` and every gradient leaf, through ``lm_params_to_numpy``,
    against ``jax.value_and_grad`` of the reference's ``loss_fn`` (the MoE
    aux terms included for moonshot's smoke config)."""
    rparams, pparams = _carried(cfg)
    toks, tgts = _batch(cfg.vocab, 2, 24)
    (rloss, rmet), rgrads = jax.value_and_grad(
        lambda p: ref_tf.loss_fn(cfg, p, jnp.asarray(toks),
                                 jnp.asarray(tgts)), has_aux=True)(rparams)
    loss, met, grads = _port_loss_and_grads(cfg, pparams, toks, tgts)
    np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-5)
    assert set(met) == set(rmet)
    for k in rmet:
        np.testing.assert_allclose(float(met[k]), float(rmet[k]), rtol=1e-5,
                                   atol=1e-7)
    if cfg.n_experts:
        assert float(met["lb_loss"]) > 0 and float(met["z_loss"]) > 0
    got = jax.tree.leaves(lm_params_to_numpy(port_cfg(cfg), grads))
    want = jax.tree.leaves(_np(rgrads))
    assert len(got) == len(want)
    for a, w in zip(got, want):
        assert a.shape == w.shape
        np.testing.assert_allclose(a, w, rtol=1e-4,
                                   atol=1e-6 * float(np.abs(w).max()))


@pytest.mark.parametrize("cfg", [SMOLLM, MOONSHOT], ids=["smollm", "moonshot"])
def test_remat_changes_no_value(cfg):
    """loss_fn with each layer checkpointed gives the same loss, metrics and
    gradients as without, to the bit."""
    _, pparams = _carried(cfg, seed=1)
    toks, tgts = _batch(cfg.vocab, 2, 20, step=1)
    a = _port_loss_and_grads(cfg, pparams, toks, tgts, remat=True)
    b = _port_loss_and_grads(cfg, pparams, toks, tgts, remat=False)
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(a[1][k], b[1][k]) for k in a[1])
    for x, y in zip(jax.tree.leaves(lm_params_to_numpy(port_cfg(cfg), a[2])),
                    jax.tree.leaves(lm_params_to_numpy(port_cfg(cfg), b[2]))):
        np.testing.assert_array_equal(x, y)


def test_lm_params_to_numpy_inverts_from_numpy():
    """The reference's tree → the port's → back: every leaf equal, the
    layout (head layers, moe_period sub-stacks) the reference's."""
    for cfg in (SMOLLM, MOONSHOT):
        rparams, pparams = _carried(cfg, seed=2)
        back = lm_params_to_numpy(port_cfg(cfg), pparams)
        want = _np(rparams)
        assert jax.tree.structure(back) == jax.tree.structure(want)
        for a, w in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a, w)


# --------------------------------------------------------------------------
# the train step
# --------------------------------------------------------------------------

OPT_KW = dict(lr=1e-3, warmup_steps=2, total_steps=20)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_steps_match_reference(accum):
    """Two reference steps, the state carried across with
    ``train_state_from_numpy``, then three steps in each package on the same
    batches: the losses and every metric, and the final params and
    moments."""
    cfg = SMOLLM
    rcfg_opt, pcfg_opt = RefOptConfig(**OPT_KW), OptConfig(**OPT_KW)
    rstep = jax.jit(ref_make_train_step(
        lambda p, b: ref_tf.loss_fn(cfg, p, b["tokens"], b["targets"]),
        rcfg_opt, accum_steps=accum))
    pstep = make_train_step(
        lambda p, b: tf.loss_fn(port_cfg(cfg), p, b["tokens"], b["targets"]),
        pcfg_opt, accum_steps=accum)
    shape = (accum, 8 // accum, 16) if accum > 1 else (8, 16)

    def batch(s):
        toks, tgts = _batch(cfg.vocab, 8, 16, step=s)
        return toks.reshape(shape), tgts.reshape(shape)

    rstate = RefTrainState.create(ref_tf.init(cfg, jax.random.PRNGKey(3)),
                                  rcfg_opt)
    for s in range(2):
        toks, tgts = batch(s)
        rstate, _ = rstep(rstate, {"tokens": jnp.asarray(toks),
                                   "targets": jnp.asarray(tgts)})
    pstate = train_state_from_numpy(
        port_cfg(cfg), _np(rstate.params), _np(rstate.opt_state),
        np.asarray(rstate.step), device="cpu")
    assert int(pstate.step) == 2 and int(pstate.opt_state["step"]) == 2
    for s in range(2, 5):
        toks, tgts = batch(s)
        rstate, rm = rstep(rstate, {"tokens": jnp.asarray(toks),
                                    "targets": jnp.asarray(tgts)})
        pstate, pm = pstep(pstate, {"tokens": torch.from_numpy(toks),
                                    "targets": torch.from_numpy(tgts)})
        assert set(pm) == set(rm)
        for k in rm:
            np.testing.assert_allclose(float(pm[k]), float(rm[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=k)
    assert int(pstate.step) == int(rstate.step) == 5
    for port_tree, ref_tree in ((pstate.params, rstate.params),
                                (pstate.opt_state["m"], rstate.opt_state["m"]),
                                (pstate.opt_state["v"], rstate.opt_state["v"])):
        for a, w in zip(jax.tree.leaves(lm_params_to_numpy(port_cfg(cfg),
                                                            port_tree)),
                        jax.tree.leaves(_np(ref_tree))):
            np.testing.assert_allclose(a, w, rtol=1e-4, atol=1e-5)


# The port's own copies of tests/test_train_integration.py's four checks.

IT_CFG = tf.LMConfig(name="it", n_layers=2, d_model=64, n_heads=4,
                     n_kv_heads=2, d_ff=128, vocab=128, dtype=torch.float32)
IT_OPT = OptConfig(lr=2e-3, total_steps=200, warmup_steps=10)


def _run(state, step_fn, lm, steps, start=0):
    losses = []
    for s in range(start, start + steps):
        toks, tgts = lm_batch(lm, 16, 32, s, seed=0)
        state, m = step_fn(state, {"tokens": torch.from_numpy(toks),
                                   "targets": torch.from_numpy(tgts)})
        losses.append(float(m["loss"]))
    return state, losses


@pytest.fixture(scope="module")
def it_setup():
    lm = make_markov_lm(128, branch=4, seed=0)
    params = tf.init(IT_CFG, torch.Generator().manual_seed(0), device="cpu")
    step_fn = make_train_step(
        lambda p, b: tf.loss_fn(IT_CFG, p, b["tokens"], b["targets"]), IT_OPT)
    return lm, params, step_fn


def test_loss_decreases_toward_entropy_floor(it_setup):
    lm, params, step_fn = it_setup
    state, losses = _run(TrainState.create(params, IT_OPT), step_fn, lm, 60)
    assert losses[-1] < losses[0] - 1.0          # big drop from ln(128)≈4.85
    assert losses[-1] < 3.0                      # well on the way to ln4≈1.39


def test_crash_resume_bitexact(it_setup, tmp_path):
    """Train 10 steps, checkpoint, 'crash', restore, continue: the same bits
    as a run that never crashed (data keyed by step, deterministic ops)."""
    lm, params, step_fn = it_setup
    ref, ref_losses = _run(TrainState.create(params, IT_OPT), step_fn, lm, 20)
    mgr = CheckpointManager(str(tmp_path), every=10, keep=2, async_save=False)
    st, _ = _run(TrainState.create(params, IT_OPT), step_fn, lm, 10)
    mgr.maybe_save(10, st)
    del st                                        # 'crash'
    step0, st2 = mgr.restore(TrainState.create(params, IT_OPT), device="cpu")
    assert step0 == 10 and int(st2.step) == 10
    assert int(st2.opt_state["step"]) == 10
    st2, resumed = _run(st2, step_fn, lm, 10, start=10)
    assert resumed == ref_losses[10:]
    for a, b in zip(jax.tree.leaves(lm_params_to_numpy(IT_CFG, ref.params)),
                    jax.tree.leaves(lm_params_to_numpy(IT_CFG, st2.params))):
        np.testing.assert_array_equal(a, b)


def test_accum_equivalence(it_setup):
    """accum=2 over half-size microbatches ≈ accum=1 over the full batch
    (f32 accumulation; identical data)."""
    lm, params, step_fn1 = it_setup
    step_fn2 = make_train_step(
        lambda p, b: tf.loss_fn(IT_CFG, p, b["tokens"], b["targets"]), IT_OPT,
        accum_steps=2)
    toks, tgts = (torch.from_numpy(x) for x in lm_batch(lm, 16, 32, 0, seed=0))
    s1, m1 = step_fn1(TrainState.create(params, IT_OPT),
                      {"tokens": toks, "targets": tgts})
    s2, m2 = step_fn2(TrainState.create(params, IT_OPT),
                      {"tokens": toks.reshape(2, 8, 32),
                       "targets": tgts.reshape(2, 8, 32)})
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-3)
    torch.testing.assert_close(s1.params["embed"], s2.params["embed"],
                               rtol=0, atol=5e-4)


def test_generate_after_training(it_setup):
    lm, params, step_fn = it_setup
    state, _ = _run(TrainState.create(params, IT_OPT), step_fn, lm, 40)
    prompt, _ = lm_batch(lm, 2, 4, 999, seed=0)
    toks = generate(IT_CFG, state.params, torch.from_numpy(prompt),
                    max_new=8, max_seq=16)
    assert toks.shape == (2, 12)
    arr = toks.numpy()
    follows = sum(int(arr[b, t + 1] in lm.succ[arr[b, t]])
                  for b in range(2) for t in range(4, 11))
    assert follows / 14 > 0.3     # chance = 4/128 ≈ 0.03


def test_bf16_train_state_checkpoints_bitwise(tmp_path):
    """A bf16 model's TrainState (bf16 params, f32 moments, int32 steps)
    saves and restores to the same bits and dtypes, under the reference's
    keys for a TrainState."""
    cfg = dataclasses.replace(IT_CFG, dtype=torch.bfloat16)
    params = tf.init(cfg, torch.Generator().manual_seed(1), device="cpu")
    step_fn = make_train_step(
        lambda p, b: tf.loss_fn(cfg, p, b["tokens"], b["targets"]), IT_OPT)
    lm = make_markov_lm(128, branch=4, seed=0)
    state, _ = _run(TrainState.create(params, IT_OPT), step_fn, lm, 2)
    save_checkpoint(str(tmp_path), 2, state)
    step, got = restore_latest(str(tmp_path), TrainState.create(params, IT_OPT),
                               device="cpu")
    assert step == 2 and int(got.step) == 2
    for a, b in zip(_leaves(state), _leaves(got)):
        assert a.dtype == b.dtype
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b)
    manifest = json.load(open(tmp_path / "step_000000002" / "manifest.json"))
    assert manifest["dtypes"][".params/embed"] == "bfloat16"
    assert manifest["dtypes"][".opt_state/m/embed"] == "float32"
    assert {".step", ".opt_state/step"} <= set(manifest["keys"])


def _leaves(state):
    return tree_leaves([state.params, state.opt_state, state.step])


# --------------------------------------------------------------------------
# bf16 checkpoints across the packages
# --------------------------------------------------------------------------

def _bf16_values(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(3, 5)).astype(np.float32)
    x[0, :3] = [0.0, -0.0, 1e-30]
    return x


def test_reference_bf16_checkpoint_restores_bitwise_in_port(tmp_path):
    """A TrainState-shaped tree with bf16 leaves saved by the reference is
    restored by the port to torch.bfloat16 with the same bits."""
    x = jnp.asarray(_bf16_values(0)).astype(jnp.bfloat16)
    st = RefTrainState.create({"w": x, "b": jnp.ones(4, jnp.float32)},
                              RefOptConfig())
    ref_ckpt.save_checkpoint(str(tmp_path), 7, st)
    template = TrainState.create(
        {"w": torch.zeros((3, 5), dtype=torch.bfloat16),
         "b": torch.zeros(4)}, OptConfig())
    step, got = restore_latest(str(tmp_path), template, device="cpu")
    assert step == 7 and got.params["w"].dtype == torch.bfloat16
    want = np.asarray(x).view(np.int16)
    np.testing.assert_array_equal(got.params["w"].view(torch.int16).numpy(),
                                  want)
    np.testing.assert_array_equal(got.params["b"].numpy(), np.ones(4))


def test_port_bf16_checkpoint_reads_bitwise_in_reference(tmp_path):
    """The port's bf16 leaves pass the reference's CRC check and read back
    as the same bfloat16 bits, under the manifest the reference writes for
    the same tree (keys, dtypes, shapes, checksums)."""
    x = _bf16_values(1)
    state = TrainState.create({"w": torch.from_numpy(x).to(torch.bfloat16),
                               "b": torch.ones(4)}, OptConfig())
    save_checkpoint(str(tmp_path / "port"), 3, state)
    flat = ref_ckpt._load_verified(
        str(tmp_path / "port" / "step_000000003"), verify=True)
    got = flat[".params/w"].view(jnp.bfloat16)
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16))
    np.testing.assert_array_equal(got.view(np.int16), want.view(np.int16))
    ref_state = RefTrainState.create(
        {"w": jnp.asarray(want), "b": jnp.ones(4, jnp.float32)},
        RefOptConfig())
    ref_ckpt.save_checkpoint(str(tmp_path / "ref"), 3, ref_state)
    manifests = [json.load(open(tmp_path / d / "step_000000003" /
                                "manifest.json")) for d in ("port", "ref")]
    assert manifests[0] == manifests[1]


def test_reference_cannot_restore_its_own_bf16_checkpoint(tmp_path):
    """ROADMAP C.9, a fault of the reference: its ``restore_latest`` casts
    the stored ``|V2`` bytes with ``astype(bfloat16)``, which numpy
    refuses, so a bf16 leaf never restores there.  The port reads the same
    bytes (above)."""
    x = jnp.ones((2, 2), jnp.bfloat16)
    ref_ckpt.save_checkpoint(str(tmp_path), 1, {"w": x})
    with pytest.raises(ValueError):
        ref_ckpt.restore_latest(str(tmp_path), {"w": x})


# --------------------------------------------------------------------------
# launch.train
# --------------------------------------------------------------------------

def test_launch_train_smoke_runs_and_resumes(tmp_path, capsys):
    """``--smoke --device cpu`` for 12 steps leaves its checkpoint at step
    10; the same run again resumes from it, and its state equals an
    uninterrupted 12-step run's bit for bit."""
    d = str(tmp_path / "a")
    assert launch_train.main(["--arch", "smollm-135m", "--smoke", "--steps",
                              "12", "--ckpt-dir", d, "--device", "cpu"]) == 0
    assert os.listdir(d) == ["step_000000010"]
    arch = get_arch("smollm-135m")
    resumed = launch_train.lm_smoke_loop(arch, 12, d, device="cpu")
    out = capsys.readouterr().out
    assert "[train] resumed from step 10" in out
    assert int(resumed.step) == 12
    whole = launch_train.lm_smoke_loop(arch, 12, str(tmp_path / "b"),
                                       device="cpu")
    for a, b in zip(_leaves(resumed), _leaves(whole)):
        assert torch.equal(a, b)


def test_launch_train_refuses(capsys, tmp_path):
    """An arch the port does not have, the full config off the card (an
    LM's and the GAT's, whose smoke config trains on the CPU), and archs
    whose training state exceeds an 80 GB card."""
    with pytest.raises(SystemExit, match="unknown arch"):
        launch_train.main(["--arch", "gat-pubmed", "--smoke", "--device",
                           "cpu"])
    with pytest.raises(SystemExit, match="on the card"):
        launch_train.main(["--arch", "smollm-135m", "--device", "cpu"])
    with pytest.raises(SystemExit, match="on the card"):
        launch_train.main(["--arch", "gat-cora", "--shape", "ogb_products",
                           "--device", "cpu"])
    assert launch_train.main(["--arch", "gat-cora", "--smoke", "--steps", "3",
                              "--ckpt-dir", str(tmp_path), "--device",
                              "cpu"]) == 0
    assert "[train] smoke step 2: loss=" in capsys.readouterr().out
    card = 80 * 10**9
    for arch_id in ("moonshot-v1-16b-a3b", "llama4-maverick-400b-a17b",
                    "internlm2-20b"):
        arch = get_arch(arch_id)
        with pytest.raises(SystemExit, match="does not fit one card"):
            launch_train.plan_micro_batch(arch.model_cfg,
                                          arch.shapes["train_4k"], card)
    smollm = get_arch("smollm-135m")
    shape = smollm.shapes["train_4k"]
    assert (shape.dims, shape.accum_steps) == ({"seq": 4096, "batch": 256}, 4)
    micro = launch_train.plan_micro_batch(smollm.model_cfg, shape, card)
    assert 1 <= micro <= 64


def test_train_step_leaves_no_tensor_to_the_garbage_collector(tmp_path):
    """A step frees the old state and the gradients by reference counting:
    nothing of it waits in a reference cycle for the garbage collector
    (on the card such a cycle held a 0.9 B-parameter table's old copy and
    its gradient, 7.2 GB a step), and neither does a checkpoint's
    restore."""
    import gc

    gc.collect()
    gc.disable()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        params = {"w": torch.randn(8, 4), "b": [torch.zeros(4)]}
        opt = OptConfig(lr=1e-2, total_steps=10)
        step = make_train_step(
            lambda p, b: ((b @ p["w"] + p["b"][0]).square().mean(), {}), opt)
        state = TrainState.create(params, opt)
        for _ in range(2):
            state, _ = step(state, torch.randn(5, 8))
        mgr = CheckpointManager(str(tmp_path), every=1, async_save=False)
        mgr.maybe_save(1, state)
        mgr.restore(state, device="cpu")
        gc.collect()
        left = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert not left
