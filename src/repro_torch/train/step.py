"""Train-step factory: loss → grad → clip → AdamW, with optional microbatch
gradient accumulation.  Counterpart of ``repro.train.step``.

    step = make_train_step(loss_fn, opt_cfg, accum_steps=1)
    state, metrics = step(state, batch)

``loss_fn(params, batch) → (loss, metrics)``; gradients come from
``torch.autograd.grad`` of the loss with respect to every parameter.  With
``accum_steps > 1`` each tensor of the batch has a leading
``[accum_steps, micro, ...]`` axis, and the microbatches run one after
another, as the reference's ``lax.scan`` does: gradients summed into an f32
accumulator (``accum_dtype`` for bf16 parameters, if given), each divided by
``accum_steps`` before it is added, the loss averaged the same way, the
metrics the last microbatch's, and the sum cast back to each parameter's
dtype before the update.  Nothing is donated: there is no ``jit``; each
step's state is new tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..optim import OptConfig, adamw_init, adamw_update
from ..optim.adamw import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class TrainState:
    """``params``, the AdamW state ``opt_state`` ({"m", "v", "step"}) and
    the int32 ``step``: a tree that ``repro_torch.checkpoint`` saves and
    restores, under the reference's keys (``.params/...``,
    ``.opt_state/...``, ``.step``)."""
    params: Any
    opt_state: Any
    step: torch.Tensor

    @staticmethod
    def create(params, opt_cfg: OptConfig) -> "TrainState":
        opt_state = adamw_init(params, opt_cfg)
        return TrainState(params=params, opt_state=opt_state,
                          step=torch.zeros_like(opt_state["step"]))


def make_train_step(loss_fn: Callable, opt_cfg: OptConfig,
                    accum_steps: int = 1, accum_dtype=None) -> Callable:
    """The step ``(state, batch) → (state, metrics)``; ``metrics`` holds
    ``loss``, the loss function's metrics, ``lr`` and ``grad_norm`` as
    detached tensors (read them with ``float``)."""

    def grads_of(params, batch):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        loss, metrics = loss_fn(tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, tree_unflatten(params, grads)

    def step(state: TrainState, batch):
        if accum_steps == 1:
            loss, metrics, grads = grads_of(state.params, batch)
        else:
            adt = accum_dtype or torch.float32
            acc = tree_map(lambda p: torch.zeros(
                p.shape, dtype=adt if p.dtype == torch.bfloat16
                else torch.float32, device=p.device), state.params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=state.step.device)
            for i in range(accum_steps):
                micro = {k: v[i] for k, v in batch.items()}
                loss_i, metrics, grads = grads_of(state.params, micro)
                acc = tree_map(lambda a, g: a + g.to(a.dtype) / accum_steps,
                               acc, grads)
                loss = loss + loss_i / accum_steps
                del grads
            grads = tree_map(lambda g, p: g.to(p.dtype), acc, state.params)
        new_params, new_opt, opt_metrics = adamw_update(
            grads, state.opt_state, state.params, opt_cfg)
        new_state = TrainState(params=new_params, opt_state=new_opt,
                               step=state.step + 1)
        return new_state, {"loss": loss, **metrics, **opt_metrics}

    return step
