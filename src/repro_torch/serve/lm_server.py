"""LM serving: greedy / temperature generation over the KV-cache decode
step.  Counterpart of ``repro.serve.lm_server``.

The prompt is stepped token by token through ``decode_step`` (as the
reference does), then ``max_new`` tokens are sampled.  Greedy output
(``temperature <= 0``) is the reference's, token for token, on the same
parameters.  Temperature sampling draws from a ``torch.Generator``, which
gives other numbers than ``jax.random`` from the same seed: it matches the
reference only in distribution.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models import transformer as tf


def generate(cfg: tf.LMConfig, params: dict, prompt: torch.Tensor,
             max_new: int = 32, max_seq: int = 256, temperature: float = 0.0,
             gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """prompt int[B, P] on the parameters' device → tokens int32[B, P +
    max_new] (greedy if temperature <= 0)."""
    B, P = prompt.shape
    device = params["embed"].device
    prompt = prompt.to(device=device, dtype=torch.int32)
    cache = tf.init_cache(cfg, B, max_seq, device=device)
    logits = torch.zeros((B, cfg.vocab), device=device)
    for t in range(P):
        logits, cache = tf.decode_step(cfg, params, cache, prompt[:, t])

    if temperature > 0.0 and gen is None:
        gen = torch.Generator(device=device).manual_seed(0)

    def sample(logits):
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)

    toks = [sample(logits)]
    for _ in range(max_new - 1):
        logits, cache = tf.decode_step(cfg, params, cache, toks[-1])
        toks.append(sample(logits))
    return torch.cat([prompt, torch.stack(toks, dim=1)], dim=1)
