"""Training entry point of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --smoke --steps 100 --ckpt-dir build/ckpt --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --shape train_4k --steps 20 --ckpt-dir build/ckpt      # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch dien \\
        --steps 20 --ckpt-dir build/ckpt/dien                  # train_batch
    PYTHONPATH=src python -m repro_torch.launch.train --arch gat-cora \\
        --shape ogb_products --steps 20 --ckpt-dir build/ckpt/gat

Counterpart of ``repro.launch.train``.  ``--smoke`` trains the arch's
``smoke_cfg``: an LM as the reference's ``_lm_smoke_loop`` does (batch 16
of 64 tokens, lr 1e-3, Markov data keyed by the step), a recsys arch as
``tests/test_models_smoke.py`` does (16 samples of the synthetic logs
keyed by the step, lr 1e-3), the GAT on a 64-node ``sbm_graph`` at lr
1e-2 (the reference's launcher refuses both); each with a checkpoint
every ``max(steps // 5, 10)`` steps and auto-resume from the newest
intact one.  Without ``--smoke`` it trains the arch's full config on one
card, with the same checkpoint and resume loop:

* an LM at the shape's sequence length and microbatch accumulation, the
  batch cut to what the card holds (printed), under the reference's
  full-scale ``OptConfig`` (f32 moments, ``total_steps`` 10,000);
* a recsys arch at ``train_batch`` (65,536) under
  ``_recsys_train_cell``'s ``OptConfig(total_steps=100000)``, cut to
  microbatches (``make_train_step(accum_steps=…)``) where the card does
  not hold the batch's activations beside the f32 state (printed;
  ``plan_recsys_accum``);
* the GAT at ``--shape`` (full_graph_sm, minibatch_lg, ogb_products,
  molecule) under ``_gnn_cell``'s ``OptConfig(total_steps=1000)``, its
  edges in chunks where the card does not hold them in one piece
  (``models.gnn.plan_edge_chunk``, printed).

The reference's full path lowers its 256-chip dry-run cell, which has no
meaning on one card.  It refuses, with a message: an arch the port does
not have, an ann arch (sift1m: an index, nothing to train), the full
path off the card, and an arch whose parameters, gradients and AdamW
state do not fit the card (``plan_micro_batch``:
moonshot, llama4, internlm2 on an 80 GB card; ``plan_recsys_accum``).
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from ..checkpoint import CheckpointManager
from ..configs import get_arch
from ..core.types import resolve_device
from ..data import lm_batch, make_markov_lm, sbm_graph
from ..models import gnn
from ..models import transformer as tf
from ..optim import OptConfig
from ..optim.adamw import tree_leaves
from ..train import TrainState, make_train_step
from .steps import (_RECSYS_INIT, _RECSYS_LOSS, _gnn_sizes, check_untruncated,
                    gnn_batch, gnn_loss, recsys_batch)

# the share of the card a run plans to fill: the rest is the allocator's
# slack and the CUDA context
CARD_SHARE = gnn.CARD_SHARE


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


def recsys_sample_bytes(arch_id: str, cfg) -> int:
    """An estimate of one training sample's activation bytes (f32): what
    autograd keeps and the backward's transients.  DIEN's are its two
    GRUs' saved gates and states, 8 vectors of ``gru_dim`` a step each
    (a step of 65,536 samples peaked at 48.0 GB on an H100, PERF.md
    §5)."""
    if arch_id == "fm":
        return 4 * 8 * cfg.n_sparse * (cfg.embed_dim + 1)
    if arch_id == "dcn-v2":
        return 4 * (6 * cfg.d_input * (cfg.n_cross + 1)
                    + 4 * sum(cfg.mlp_dims))
    if arch_id == "dien":
        return 4 * (2 * 8 * cfg.seq_len * cfg.gru_dim
                    + 4 * cfg.seq_len * cfg.d_beh + 4 * sum(cfg.mlp_dims))
    return 4 * (8 * cfg.seq_len * cfg.embed_dim                     # mind
                + 6 * cfg.routing_iters * cfg.n_interests * cfg.seq_len
                + 4 * (cfg.n_neg + 1 + cfg.n_interests) * cfg.embed_dim)


def plan_recsys_accum(arch, card_bytes: int) -> int:
    """The microbatch accumulation (a power of two) at which one card of
    ``card_bytes`` holds a recsys arch's ``train_batch``: the parameters,
    gradients and AdamW moments in f32 (16 bytes a parameter, 4 more for
    the accumulator), AdamW's transients on the largest table, and a
    microbatch's activations (``recsys_sample_bytes``); raises
    ``SystemExit`` naming the bytes when one sample does not fit."""
    cfg, B = arch.model_cfg, arch.shapes["train_batch"].dims["batch"]
    sizes = [p.numel() for p in tree_leaves(
        _RECSYS_INIT[arch.id](cfg, device="meta"))]
    room = int(CARD_SHARE * card_bytes)
    per = recsys_sample_bytes(arch.id, cfg)
    accum = 1
    while True:
        need = (16 + (4 if accum > 1 else 0)) * sum(sizes) + 20 * max(sizes)
        if need + (B // accum) * per <= room:
            return accum
        if B % (2 * accum):
            raise SystemExit(
                f"[train] {arch.id} does not fit one card: its parameters, "
                f"gradients and AdamW state take {need:,} bytes "
                f"({sum(sizes):,} parameters), a sample ≈ {per:,} more, "
                f"against {room:,} usable of the card's {card_bytes:,}")
        accum *= 2


def _loop(state, step_fn, mgr, steps: int, batch_of, tag: str,
          floor: Optional[float] = None) -> TrainState:
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
                  f"({(s - start + 1) / (time.time() - t0):.2f} steps/s)"
                  + ("" if floor is None else f" floor={floor:.3f}"))
        mgr.maybe_save(s + 1, state)
    mgr.wait()
    return state


def _smoke_opt(steps: int, lr: float) -> OptConfig:
    """The smoke loops' schedule: ``lr`` after a short warmup."""
    return OptConfig(lr=lr, total_steps=max(steps, 10),
                     warmup_steps=min(20, steps // 5 + 1))


def _on_card(device) -> torch.device:
    """The device of a full-config loop, which runs on the card only."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise SystemExit("[train] the full config trains on the card; pass "
                         "--smoke to train the reduced config on the CPU")
    return dev


def lm_smoke_loop(arch, steps: int, ckpt_dir: str, batch: int = 16,
                  seq: int = 64, lr: float = 1e-3,
                  device="cuda") -> TrainState:
    """The reference's ``_lm_smoke_loop`` on the port (see the module
    docstring); returns the final state."""
    dev = resolve_device(device)
    cfg = arch.smoke_cfg
    opt = _smoke_opt(steps, lr)
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
    return _loop(TrainState.create(params, opt), step_fn, mgr, steps,
                 batch_of, "smoke", lm.entropy())


def lm_full_loop(arch, shape_name: str, steps: int, ckpt_dir: str,
                 device="cuda") -> TrainState:
    """The arch's full config at ``shape_name`` on one card (see the module
    docstring); returns the final state."""
    dev = _on_card(device)
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
    return _loop(TrainState.create(params, opt), step_fn, mgr, steps,
                 batch_of, shape_name, lm.entropy())


def recsys_loop(arch, steps: int, ckpt_dir: str, smoke: bool,
                device="cuda") -> TrainState:
    """A recsys arch trained as the module docstring says (``smoke``: its
    ``smoke_cfg``, 16 samples, lr 1e-3; else ``train_batch`` on the card);
    returns the final state."""
    dev = resolve_device(device) if smoke else _on_card(device)
    if smoke:
        cfg, B, accum, opt = arch.smoke_cfg, 16, 1, _smoke_opt(steps, 1e-3)
    else:
        cfg, B = arch.model_cfg, arch.shapes["train_batch"].dims["batch"]
        accum = plan_recsys_accum(
            arch, torch.cuda.get_device_properties(dev).total_memory)
        opt = OptConfig(total_steps=100000)
        print(f"[train] {arch.id} × train_batch: batch {B:,} as {accum} × "
              f"{B // accum:,} samples (what one card holds), f32")
    params = _RECSYS_INIT[arch.id](
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    step_fn = make_train_step(
        lambda p, b: _RECSYS_LOSS[arch.id](cfg, p, b), opt,
        accum_steps=accum)

    def batch_of(s):
        b = recsys_batch(arch.id, cfg, B, s, device=dev)
        if accum == 1:
            return b
        return {k: v.reshape(accum, B // accum, *v.shape[1:])
                for k, v in b.items()}

    mgr = CheckpointManager(ckpt_dir, every=max(steps // 5, 10), keep=3)
    return _loop(TrainState.create(params, opt), step_fn, mgr, steps,
                 batch_of, "smoke" if smoke else "train_batch")


def _smoke_graph(cfg, device) -> dict:
    """The GAT smoke loop's full batch: a 64-node ``sbm_graph`` (seed 0)
    of the smoke config's classes and features, 256 edges, every node
    labelled."""
    g = sbm_graph(64, cfg.n_classes, cfg.d_in, avg_degree=2.0, seed=0)
    out = {k: torch.from_numpy(g[k]).to(device)
           for k in ("x", "src", "dst", "labels")}
    out["label_mask"] = torch.ones(64, dtype=torch.bool, device=device)
    return out


def gnn_loop(arch, shape_name: str, steps: int, ckpt_dir: str,
             smoke: bool, device="cuda") -> TrainState:
    """The GAT trained as the module docstring says (``smoke``: its
    ``smoke_cfg`` on a 64-node graph at lr 1e-2; else ``shape_name`` on
    the card); returns the final state."""
    dev = resolve_device(device) if smoke else _on_card(device)
    if smoke:
        cfg, chunk, opt = arch.smoke_cfg, None, _smoke_opt(steps, 1e-2)
        full = _smoke_graph(cfg, dev)
        batch_of = lambda s: full  # noqa: E731
    else:
        cfg, shape = arch.model_cfg[shape_name], arch.shapes[shape_name]
        n_nodes, n_edges, _ = _gnn_sizes(shape)
        chunk = gnn.plan_edge_chunk(
            cfg, n_nodes, n_edges,
            torch.cuda.get_device_properties(dev).total_memory)
        opt = OptConfig(total_steps=1000)
        print(f"[train] {arch.id} × {shape_name}: {n_nodes:,} nodes, "
              f"{n_edges:,} edges, "
              + ("in one piece" if chunk is None else
                 f"in chunks of {chunk:,} edges (what one card holds)"))
        full = (gnn_batch(arch, shape_name, 0, device=dev)
                if shape.kind == "full_graph" else None)

        def batch_of(s):
            b = full if full is not None else gnn_batch(arch, shape_name, s,
                                                        device=dev)
            if shape.kind == "minibatch":
                check_untruncated(b, shape)
            return b

    params = gnn.init(cfg, torch.Generator(device=dev).manual_seed(0),
                      device=dev)
    step_fn = make_train_step(gnn_loss(cfg, chunk), opt)
    mgr = CheckpointManager(ckpt_dir, every=max(steps // 5, 10), keep=3)
    return _loop(TrainState.create(params, opt), step_fn, mgr, steps,
                 batch_of, "smoke" if smoke else shape_name)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default=None,
                    help="an LM's train shape (train_4k) or a GAT cell "
                         "(full_graph_sm, minibatch_lg, ogb_products, "
                         "molecule; default full_graph_sm)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt-dir", default="build/ckpt")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced config (runs on the CPU too)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    try:
        arch = get_arch(args.arch)
    except KeyError as e:
        raise SystemExit(f"[train] {e.args[0]}")
    if arch.family == "ann":
        raise SystemExit(f"[train] {arch.id} is an ann arch (family "
                         f"'{arch.family}'): an index is built and served, "
                         "there is nothing to train")
    if arch.family == "recsys":
        recsys_loop(arch, args.steps, args.ckpt_dir, args.smoke,
                    device=args.device)
    elif arch.family == "gnn":
        gnn_loop(arch, args.shape or "full_graph_sm", args.steps,
                 args.ckpt_dir, args.smoke, device=args.device)
    elif args.smoke:
        lm_smoke_loop(arch, args.steps, args.ckpt_dir, device=args.device)
    else:
        lm_full_loop(arch, args.shape or "train_4k", args.steps,
                     args.ckpt_dir, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
