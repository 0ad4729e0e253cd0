"""End-to-end example on the PyTorch port: train a small LM (46M
parameters) for a few hundred steps on the synthetic Markov language,
with periodic checkpoints and resume.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 300]   # the card
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 2 \\
        --batch 1 --seq 16

Counterpart of ``examples/train_lm.py``: the same model (d=512, 12
layers, vocab 8k, 46,150,144 parameters by ``param_count``, f32),
optimizer, data and flags, plus ``--device`` and ``--ckpt-every``
(default the reference's 100).  Loss should fall from ln(8192) ≈ 9.0
toward the chain entropy ln(4) ≈ 1.39.
A second run with the same ``--ckpt-dir`` resumes from the newest
checkpoint.  On the card attention runs the hand-written flash kernels
(forward and backward).  Without a card it raises unless given
``--device cpu``.
"""

import argparse
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.types import resolve_device
from repro_torch.data import lm_batch, make_markov_lm
from repro_torch.models.transformer import LMConfig, init, loss_fn
from repro_torch.optim import OptConfig
from repro_torch.train import TrainState, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default="build/ckpt/lm100m")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = LMConfig(name="lm-100m", n_layers=12, d_model=512, n_heads=8,
                   n_kv_heads=4, d_ff=1536, vocab=8192, dtype=torch.float32)
    n_params = cfg.param_count()
    print(f"model: {n_params / 1e6:.0f}M params")

    opt = OptConfig(lr=3e-4, warmup_steps=30, total_steps=args.steps,
                    weight_decay=0.01)
    params = init(cfg, torch.Generator(device=dev).manual_seed(0),
                  device=dev)
    step_fn = make_train_step(
        lambda p, b: loss_fn(cfg, p, b["tokens"], b["targets"]), opt)
    state = TrainState.create(params, opt)

    mgr = CheckpointManager(args.ckpt_dir, every=args.ckpt_every, keep=2)
    _, state = mgr.restore(state, device=dev)
    start = int(state.step)
    if start:
        print(f"resumed at step {start}")

    lm = make_markov_lm(cfg.vocab, branch=4, seed=0)
    print(f"entropy floor: {lm.entropy():.3f} nats")
    t0, tokens_seen, losses = time.time(), 0, []
    for s in range(start, args.steps):
        toks, tgts = lm_batch(lm, args.batch, args.seq, s, seed=0)
        state, m = step_fn(state, {"tokens": torch.from_numpy(toks).to(dev),
                                   "targets": torch.from_numpy(tgts).to(dev)})
        tokens_seen += toks.size
        if s % 20 == 0 or s == args.steps - 1:
            losses.append(float(m["loss"]))
            dt = time.time() - t0
            print(f"step {s:4d}  loss={losses[-1]:.4f}  "
                  f"lr={float(m['lr']):.2e}  "
                  f"{tokens_seen / max(dt, 1e-9):.0f} tok/s")
        mgr.maybe_save(s + 1, state)
    mgr.wait()
    print("done.")
    return dict(start=start, losses=losses, params=n_params)


if __name__ == "__main__":
    main()
