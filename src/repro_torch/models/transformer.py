"""Decoder-only transformer LM, dense models, on PyTorch.  Counterpart of
``repro.models.transformer``: RMSNorm · RoPE · GQA · SwiGLU · optional
sliding-window attention.

Entry points (plain functions over a parameter dict):
  init(cfg, gen, device)                        → params
  forward(cfg, params, tokens, backend)         → logits [B, S, V] f32
  prefill(cfg, params, tokens, backend)         → last-position logits [B, V]
  init_cache(cfg, batch, max_seq, device=...)   → KV cache
  decode_step(cfg, params, cache, tokens)       → logits [B, V], cache

Differences from the reference, none of which changes a result:

* Parameters are a dict with one dict per layer (``params["layers"]``),
  where the reference stacks them ``[L, ...]`` for ``lax.scan``;
  ``interop.lm_params_from_numpy`` carries a reference tree across.
* ``hints.constrain`` (the reference's sharding hints) has no meaning on
  one card and is left out, and so is ``jax.checkpoint`` (no training here).
* ``prefill`` unembeds only the last position, where the reference computes
  ``[B, S, V]`` logits and keeps the last row; the rows are independent.
* ``decode_step`` writes the new K/V into the cache tensors in place (the
  returned cache holds the same tensors, and ``pos`` advanced).
* A config with experts (``n_experts > 0``) raises ``NotImplementedError``:
  ``models/moe.py`` is not ported yet (ROADMAP A.9).

The reference picks each scanned layer's window by the sub-layer index
``j`` inside one scan period, not by the layer's index (ROADMAP C.6): in a
dense model the period is 1, so with ``window_period > 1`` every layer is
windowed and with ``window_period == 1`` none is.  The port reproduces that.

``backend`` selects attention: ``"auto"`` is the CUDA flash-attention kernel
on a CUDA tensor and the plain blockwise version on the CPU; ``"jnp"`` the
plain version on any device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.types import resolve_device
from .common import apply_rope, decode_attention, dense_init, flash_attention
from .common import rms_norm, swiglu


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str = "lm"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 2
    d_ff: int = 512
    vocab: int = 1024
    head_dim: Optional[int] = None   # default d_model // n_heads
    rope_theta: float = 10000.0
    n_experts: int = 0               # > 0: MoE, not ported yet
    window: Optional[int] = None     # sliding-window size
    window_period: int = 0           # see the module docstring (C.6)
    dtype: torch.dtype = torch.bfloat16

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def param_count(self) -> int:
        _require_dense(self)
        d, hd, H, KV = self.d_model, self.hd, self.n_heads, self.n_kv_heads
        attn = d * (H + 2 * KV) * hd + H * hd * d + 2 * d
        return (self.n_layers * (attn + 3 * d * self.d_ff)
                + 2 * self.vocab * d + d)


def _require_dense(cfg: LMConfig) -> None:
    if cfg.n_experts > 0:
        raise NotImplementedError(
            f"{cfg.name}: MoE configs (n_experts={cfg.n_experts}) need "
            "models/moe.py, which is not ported yet (ROADMAP A.9)")


def _layer_window(cfg: LMConfig) -> Optional[int]:
    """The window of every scanned layer of a dense model: the reference's
    rule at sub-layer index j = 0 (C.6)."""
    j = 0
    if (cfg.window is not None and cfg.window_period
            and j % cfg.window_period != cfg.window_period - 1):
        return cfg.window
    return None


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _layer_init(cfg: LMConfig, gen: torch.Generator, device) -> dict:
    d, hd, H, KV = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads

    def w(d_in, d_out):
        return dense_init(gen, d_in, d_out, cfg.dtype, device=device)

    return {
        "ln1": torch.ones(d, device=device),
        "wq": w(d, H * hd), "wk": w(d, KV * hd), "wv": w(d, KV * hd),
        "wo": w(H * hd, d),
        "ln2": torch.ones(d, device=device),
        "ffn": {"w_gate": w(d, cfg.d_ff), "w_up": w(d, cfg.d_ff),
                "w_down": w(cfg.d_ff, d)},
    }


def init(cfg: LMConfig, gen: Optional[torch.Generator] = None,
         device="cuda") -> dict:
    """Parameters on ``device``, drawn from ``gen`` (a generator on that
    device; seed 0 if None).  Norm gains are f32, weights ``cfg.dtype``."""
    _require_dense(cfg)
    dev = resolve_device(device)
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(0)
    return {
        "embed": dense_init(gen, cfg.vocab, cfg.d_model, cfg.dtype,
                            scale=0.02, device=dev),
        "unembed": dense_init(gen, cfg.d_model, cfg.vocab, cfg.dtype,
                              device=dev),
        "ln_f": torch.ones(cfg.d_model, device=dev),
        "layers": [_layer_init(cfg, gen, dev) for _ in range(cfg.n_layers)],
    }


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _attn(cfg: LMConfig, p: dict, x: torch.Tensor, positions: torch.Tensor,
          window: Optional[int], backend: str) -> torch.Tensor:
    B, S, _ = x.shape
    h = rms_norm(x, p["ln1"])
    q = (h @ p["wq"]).reshape(B, S, cfg.n_heads, cfg.hd)
    k = (h @ p["wk"]).reshape(B, S, cfg.n_kv_heads, cfg.hd)
    v = (h @ p["wv"]).reshape(B, S, cfg.n_kv_heads, cfg.hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = flash_attention(q, k, v, causal=True, window=window, backend=backend)
    return x + o.reshape(B, S, cfg.n_heads * cfg.hd) @ p["wo"]


def _ffn(p: dict, x: torch.Tensor) -> torch.Tensor:
    f = p["ffn"]
    return x + swiglu(rms_norm(x, p["ln2"]), f["w_gate"], f["w_up"],
                      f["w_down"])


def _hidden(cfg: LMConfig, params: dict, tokens: torch.Tensor,
            backend: str) -> torch.Tensor:
    """tokens int[B, S] → the final-normed hidden states [B, S, d]."""
    _require_dense(cfg)
    B, S = tokens.shape
    x = params["embed"][tokens.long()]
    positions = torch.arange(S, device=x.device).expand(B, S)
    window = _layer_window(cfg)
    for p in params["layers"]:
        x = _ffn(p, _attn(cfg, p, x, positions, window, backend))
    return rms_norm(x, params["ln_f"])


def forward(cfg: LMConfig, params: dict, tokens: torch.Tensor,
            backend: str = "auto") -> torch.Tensor:
    """tokens int[B, S] → logits f32[B, S, V] (a ``cfg.dtype`` product cast
    to f32, as the reference's)."""
    return (_hidden(cfg, params, tokens, backend)
            @ params["unembed"]).float()


def prefill(cfg: LMConfig, params: dict, tokens: torch.Tensor,
            backend: str = "auto") -> torch.Tensor:
    """The full forward over the prompt; returns last-position logits
    f32[B, V]."""
    x = _hidden(cfg, params, tokens, backend)
    return (x[:, -1, :] @ params["unembed"]).float()


# ---------------------------------------------------------------------------
# serving: KV cache + decode step
# ---------------------------------------------------------------------------

def init_cache(cfg: LMConfig, batch: int, max_seq: int,
               device="cuda") -> dict:
    """KV cache: ``k``/``v`` [L, B, max_seq, KV, hd] in ``cfg.dtype`` and
    ``pos`` int32[B]."""
    _require_dense(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "pos": torch.zeros(batch, dtype=torch.int32, device=dev)}


def _attn_decode(cfg: LMConfig, p: dict, x: torch.Tensor, k_cache, v_cache,
                 pos: torch.Tensor, window: Optional[int]) -> torch.Tensor:
    """x [B, 1, d]; writes this token's K/V at ``pos[b]`` of each row of the
    caches [B, S, KV, hd] in place and returns x + attention."""
    B = x.shape[0]
    h = rms_norm(x[:, 0, :], p["ln1"])
    q = (h @ p["wq"]).reshape(B, cfg.n_heads, cfg.hd)
    k = (h @ p["wk"]).reshape(B, cfg.n_kv_heads, cfg.hd)
    v = (h @ p["wv"]).reshape(B, cfg.n_kv_heads, cfg.hd)
    q = apply_rope(q[:, None], pos[:, None], cfg.rope_theta)[:, 0]
    k = apply_rope(k[:, None], pos[:, None], cfg.rope_theta)[:, 0]
    rows = torch.arange(B, device=x.device)
    k_cache[rows, pos.long()] = k
    v_cache[rows, pos.long()] = v
    o = decode_attention(q, k_cache, v_cache, pos + 1, window=window)
    return x + (o.reshape(B, cfg.n_heads * cfg.hd) @ p["wo"])[:, None, :]


def decode_step(cfg: LMConfig, params: dict, cache: dict,
                tokens: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """One serving step: tokens int[B] (the current token of each row) →
    next-token logits f32[B, V] and the cache advanced by one (K/V written
    in place)."""
    _require_dense(cfg)
    pos = cache["pos"]
    x = params["embed"][tokens.long()][:, None, :]
    window = _layer_window(cfg)
    for i, p in enumerate(params["layers"]):
        x = _attn_decode(cfg, p, x, cache["k"][i], cache["v"][i], pos, window)
        x = _ffn(p, x)
    x = rms_norm(x[:, 0, :], params["ln_f"])
    logits = (x @ params["unembed"]).float()
    return logits, {"k": cache["k"], "v": cache["v"], "pos": pos + 1}
