"""Training entry point of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --smoke --steps 100 --ckpt-dir build/ckpt --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --shape train_4k --steps 20 --ckpt-dir build/ckpt      # on the card

Counterpart of ``repro.launch.train``.  ``--smoke`` is the reference's
``_lm_smoke_loop``: the arch's ``smoke_cfg``, batch 16 of 64 tokens, lr
1e-3, Markov data keyed by the step (``data.lm_batch``), a checkpoint
every ``max(steps // 5, 10)`` steps and auto-resume from the newest intact
one.  Without ``--smoke`` it trains the arch's full config on one card at
the shape's sequence length and microbatch accumulation, with the batch
cut to what the card holds (printed), under the reference's full-scale
``OptConfig`` (f32 moments, ``total_steps`` 10,000); the same data,
checkpoint and resume loop.  The reference's full path lowers its 256-chip
dry-run cell, which has no meaning on one card.

It refuses, with a message: an arch that is not an LM (the recsys archs,
whose models are ported but whose training is a later slice) or that the
port does not have (the GNN arch), the full path off the card, and an
arch whose parameters, gradients and AdamW state do not fit the card
(``plan_micro_batch``: moonshot, llama4, internlm2 on an 80 GB card).
"""

from __future__ import annotations

import argparse
import time

import torch

from ..checkpoint import CheckpointManager
from ..configs import get_arch
from ..core.types import resolve_device
from ..data import lm_batch, make_markov_lm
from ..models import transformer as tf
from ..optim import OptConfig
from ..train import TrainState, make_train_step

_LM_ONLY = ("the port trains its LM archs; training the recsys and GNN "
            "archs (on the card, at train_batch) comes with a later slice")
# the share of the card a run plans to fill: the rest is the allocator's
# slack and the CUDA context
CARD_SHARE = 0.9


def state_bytes(cfg, accum_steps: int) -> int:
    """Bytes of the parameters and their gradients in ``cfg.dtype``, the
    AdamW moments in f32 and, with accumulation, the f32 accumulator."""
    width = torch.finfo(cfg.dtype).bits // 8
    return cfg.param_count() * (2 * width + 8 + (4 if accum_steps > 1 else 0))


def activation_bytes(cfg, seq: int) -> int:
    """An estimate of one sequence's activation bytes in a remat step: the
    f32 logits, their logsumexp and gradient and the bf16 product (20 bytes
    a vocabulary entry a token), each layer's saved input, and one layer's
    recomputed intermediates."""
    width = torch.finfo(cfg.dtype).bits // 8
    per_token = 20 * cfg.vocab + width * (
        cfg.n_layers * cfg.d_model + 16 * max(cfg.d_model, cfg.d_ff))
    return seq * per_token


def plan_micro_batch(cfg, shape, card_bytes: int) -> int:
    """The microbatch (sequences) one card of ``card_bytes`` holds at
    ``shape``'s sequence length, at most the shape's own ``batch //
    accum_steps``; raises ``SystemExit`` naming the bytes when the training
    state alone, or with one sequence, does not fit."""
    accum = shape.accum_steps
    need = state_bytes(cfg, accum)
    room = int(CARD_SHARE * card_bytes)
    per_seq = activation_bytes(cfg, shape.dims["seq"])
    if need + per_seq > room:
        raise SystemExit(
            f"[train] {cfg.name} does not fit one card: its parameters, "
            f"gradients and AdamW state take {need:,} bytes "
            f"({cfg.param_count():,} parameters), one sequence of "
            f"{shape.dims['seq']} tokens ≈ {per_seq:,} more, against "
            f"{room:,} usable of the card's {card_bytes:,}")
    return max(1, min(shape.dims["batch"] // accum, (room - need) // per_seq))


def _loop(cfg, state, step_fn, mgr, steps: int, batch_of, floor: float,
          tag: str) -> TrainState:
    start, state = mgr.restore(state, device=state.step.device)
    start = int(state.step)
    if start:
        print(f"[train] resumed from step {start}")
    t0 = time.time()
    for s in range(start, steps):
        state, m = step_fn(state, batch_of(s))
        if s % 10 == 0 or s == steps - 1:
            print(f"[train] {tag} step {s}: loss={float(m['loss']):.4f} "
                  f"lr={float(m['lr']):.2e} "
                  f"({(s - start + 1) / (time.time() - t0):.2f} steps/s) "
                  f"floor={floor:.3f}")
        mgr.maybe_save(s + 1, state)
    mgr.wait()
    return state


def lm_smoke_loop(arch, steps: int, ckpt_dir: str, batch: int = 16,
                  seq: int = 64, lr: float = 1e-3,
                  device="cuda") -> TrainState:
    """The reference's ``_lm_smoke_loop`` on the port (see the module
    docstring); returns the final state."""
    dev = resolve_device(device)
    cfg = arch.smoke_cfg
    opt = OptConfig(lr=lr, total_steps=max(steps, 10),
                    warmup_steps=min(20, steps // 5 + 1))
    params = tf.init(cfg, torch.Generator(device=dev).manual_seed(0),
                     device=dev)
    step_fn = make_train_step(
        lambda p, b: tf.loss_fn(cfg, p, b["tokens"], b["targets"]), opt)
    lm = make_markov_lm(cfg.vocab, branch=4, seed=0)

    def batch_of(s):
        toks, tgts = lm_batch(lm, batch, seq, s, seed=0)
        return {"tokens": torch.from_numpy(toks).to(dev),
                "targets": torch.from_numpy(tgts).to(dev)}

    mgr = CheckpointManager(ckpt_dir, every=max(steps // 5, 10), keep=3)
    return _loop(cfg, TrainState.create(params, opt), step_fn, mgr, steps,
                 batch_of, lm.entropy(), "smoke")


def lm_full_loop(arch, shape_name: str, steps: int, ckpt_dir: str,
                 device="cuda") -> TrainState:
    """The arch's full config at ``shape_name`` on one card (see the module
    docstring); returns the final state."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise SystemExit("[train] the full config trains on the card; pass "
                         "--smoke to train the reduced config on the CPU")
    cfg, shape = arch.model_cfg, arch.shapes[shape_name]
    seq, accum = shape.dims["seq"], shape.accum_steps
    micro = plan_micro_batch(
        cfg, shape, torch.cuda.get_device_properties(dev).total_memory)
    print(f"[train] {arch.id} × {shape_name}: batch {shape.dims['batch']} "
          f"cut to {accum} × {micro} sequences of {seq} tokens (what one "
          f"card holds), {cfg.param_count():,} parameters in {cfg.dtype}")
    opt = OptConfig(total_steps=10000)
    params = tf.init(cfg, torch.Generator(device=dev).manual_seed(0),
                     device=dev)
    step_fn = make_train_step(
        lambda p, b: tf.loss_fn(cfg, p, b["tokens"], b["targets"]), opt,
        accum_steps=accum)
    lm = make_markov_lm(cfg.vocab, branch=4, seed=0)

    def batch_of(s):
        toks, tgts = lm_batch(lm, accum * micro, seq, s, seed=0)
        shape_ = (accum, micro, seq) if accum > 1 else (micro, seq)
        return {"tokens": torch.from_numpy(toks).reshape(shape_).to(dev),
                "targets": torch.from_numpy(tgts).reshape(shape_).to(dev)}

    mgr = CheckpointManager(ckpt_dir, every=max(steps // 5, 10), keep=3)
    return _loop(cfg, TrainState.create(params, opt), step_fn, mgr, steps,
                 batch_of, lm.entropy(), shape_name)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt-dir", default="build/ckpt")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced config (runs on the CPU too)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    try:
        arch = get_arch(args.arch)
    except KeyError as e:
        raise SystemExit(f"[train] {e.args[0]}: {_LM_ONLY}")
    if arch.family != "lm":
        raise SystemExit(f"[train] {arch.id} is a {arch.family} arch: "
                         f"{_LM_ONLY}")
    if args.smoke:
        lm_smoke_loop(arch, args.steps, args.ckpt_dir, device=args.device)
    else:
        lm_full_loop(arch, args.shape, args.steps, args.ckpt_dir,
                     device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
