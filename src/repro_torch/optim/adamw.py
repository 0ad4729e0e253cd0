"""AdamW with global-norm clipping and learning-rate schedules, on PyTorch.
Counterpart of ``repro.optim.adamw``.

Plain functions over a parameter tree (nested dicts, lists and tuples of
tensors, as ``transformer.init`` gives), under ``torch.no_grad()``, with
the reference's arithmetic: f32 moments (stored in ``state_dtype``), bias
correction by ``b ** step`` in f32, decoupled weight decay, clipping by
the f32 global norm.  The state is a tree too, ``{"m", "v", "step"}``, so
it checkpoints with the parameters (``repro_torch.checkpoint``).

``state_dtype=torch.bfloat16`` halves the moments' memory: the reference
uses it for its largest configs.  Each update allocates new tensors, as
the reference's does; nothing is changed in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    state_dtype: Any = torch.float32    # bf16 → compressed optimizer state
    schedule: str = "cosine"            # cosine | linear | const
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _warm_and_t(cfg: OptConfig, step: torch.Tensor):
    """The warmup factor and the decay's progress t in [0, 1], in f32."""
    s = step.float()
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((s - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    return warm, t


def cosine_schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    warm, t = _warm_and_t(cfg, step)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def linear_schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    warm, t = _warm_and_t(cfg, step)
    return cfg.lr * warm * (1 - (1 - cfg.min_lr_frac) * t)


def _lr_at(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    if cfg.schedule == "cosine":
        return cosine_schedule(cfg, step)
    if cfg.schedule == "linear":
        return linear_schedule(cfg, step)
    return _f32(cfg.lr, step.device)


def tree_leaves(tree) -> list:
    """The tensors of a tree in ``jax.tree_util``'s order (dict keys
    sorted, lists and tuples by index, depth first; None holds none)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of trees of its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return tuple(out) if isinstance(tree, tuple) else out
    return None if tree is None else fn(tree, *rest)


def tree_unflatten(tree, leaves: list):
    """``tree``'s structure with its leaves, in ``tree_leaves``'s order,
    replaced by ``leaves``."""
    return _unflatten_from(tree, iter(leaves))


def _unflatten_from(node, it):
    # a module function, not a closure that calls itself: such a closure
    # is a reference cycle, which would keep ``leaves`` (a step's
    # gradients, say) alive until the garbage collector runs
    if isinstance(node, dict):
        new = {k: _unflatten_from(node[k], it) for k in sorted(node)}
        return {k: new[k] for k in node}
    if isinstance(node, (list, tuple)):
        out = [_unflatten_from(v, it) for v in node]
        return tuple(out) if isinstance(node, tuple) else out
    return None if node is None else next(it)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the f32 sum of squares over every leaf, leaves added in
    tree order."""
    total = None
    for x in tree_leaves(tree):
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def adamw_init(params, cfg: OptConfig) -> dict:
    """Zero moments of each parameter's shape in ``cfg.state_dtype`` and an
    int32 step of 0, on the parameters' device."""
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")
    zeros = lambda p: torch.zeros(p.shape, dtype=cfg.state_dtype,  # noqa: E731
                                  device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def adamw_update(grads, state: dict, params, cfg: OptConfig):
    """Returns (new_params, new_state, {"lr", "grad_norm"}).

    Clipping scales each gradient in f32, as the reference's bf16 gradient
    times an f32 scale is promoted to f32 there.  The reference's
    arithmetic, each operation on the same operands in the same order, one
    leaf at a time, its temporaries updated in place and dropped as soon as
    they are used: a leaf's update holds about four more copies of it (a
    900 M-entry embedding table's update at train_batch would otherwise
    hold a clipped copy of every gradient and eight of the table)."""
    step = state["step"] + 1
    lr = _lr_at(cfg, step)
    gnorm = global_norm(grads)
    scale = None
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)

    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - _f32(b1, step.device) ** step.float()
    bc2 = 1 - _f32(b2, step.device) ** step.float()

    def upd(p, g, m, v):
        g32 = g.float() if scale is None else g.float() * scale
        m32 = (b1 * m.float()).add_((1 - b1) * g32)
        v32 = ((1 - b2) * g32).mul_(g32)
        del g32
        v32 = (b2 * v.float()).add_(v32)
        m_out, v_out = m32.to(cfg.state_dtype), v32.to(cfg.state_dtype)
        delta = m32.div(bc1)                       # m̂
        del m32
        denom = v32.div(bc2).sqrt_().add_(cfg.eps)  # √v̂ + eps
        del v32
        delta = delta.div_(denom).add_(cfg.weight_decay * p.float())
        del denom
        new_p = p.float().sub(delta.mul_(lr)).to(p.dtype)
        return new_p, m_out, v_out

    out = [upd(*leaves) for leaves in zip(
        tree_leaves(params), tree_leaves(grads), tree_leaves(state["m"]),
        tree_leaves(state["v"]))]
    new_params, m, v = (tree_unflatten(params, [o[i] for o in out])
                        for i in range(3))
    return new_params, {"m": m, "v": v, "step": step}, \
        {"lr": lr, "grad_norm": gnorm}
