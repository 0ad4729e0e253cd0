"""Decoder-only transformer LM, dense and MoE, on PyTorch.  Counterpart of
``repro.models.transformer``: RMSNorm · RoPE · GQA · SwiGLU · optional MoE
(top-k, shared experts, periodic MoE placement, leading dense layers) ·
optional sliding-window attention.

Entry points (plain functions over a parameter dict):
  init(cfg, gen, device)                        → params
  forward(cfg, params, tokens, backend)         → logits [B, S, V] f32
  forward_aux(cfg, params, tokens, backend)     → logits, aux
  loss_fn(cfg, params, tokens, targets, remat, backend) → loss, metrics
  prefill(cfg, params, tokens, backend)         → last-position logits [B, V]
  prefill_aux(cfg, params, tokens, backend)     → last-position logits, aux
  init_cache(cfg, batch, max_seq, device=...)   → KV cache
  decode_step(cfg, params, cache, tokens)       → logits [B, V], cache

``aux`` is the reference's: ``lb_loss``, ``z_loss`` and ``frac_dropped``
of ``moe.moe_apply`` summed over the MoE layers and divided by their
number (zeros for a dense model); ``loss_fn`` adds ``lb_coef · lb_loss +
z_coef · z_loss`` of a MoE model to the mean next-token NLL, as the
reference's does.  With ``remat`` (the default, as the reference's
``forward``) each layer runs under ``torch.utils.checkpoint``, the
reference's ``jax.checkpoint``: its activations are recomputed in the
backward, and no value changes.

Differences from the reference, none of which changes a result:

* Parameters are a dict with one dict per layer (``params["layers"]``, in
  layer order: a MoE layer holds ``moe`` and, with shared experts,
  ``shared``; any other ``ffn``), where the reference keeps unrolled
  ``head_layers`` and ``moe_period`` scan stacks ``[n_super, ...]``;
  ``interop.lm_params_from_numpy`` carries a reference tree across.
* ``hints.constrain`` (the reference's sharding hints) has no meaning on
  one card and is left out.  Remat checkpoints each layer, where the
  reference checkpoints each scan period (``moe_period`` layers).
* ``loss_fn`` reads each target's logit with a gather, where the reference
  sums a one-hot product (its vocab-parallel form): the same f32 value.
* ``prefill`` unembeds only the last position, where the reference computes
  ``[B, S, V]`` logits and keeps the last row; the rows are independent.
* ``decode_step`` writes the new K/V into the cache tensors in place (the
  returned cache holds the same tensors, and ``pos`` advanced).

The reference windows a leading dense layer by its own index ``i`` and a
scanned layer by its sub-layer index ``j`` inside one MoE period, not by
its layer index (ROADMAP C.6): with a period of 1 every scanned layer is
windowed when ``window_period > 1`` and none when it is 1, and llama4's
``moe_period = 2`` with ``window_period = 4`` windows every layer.  The
port reproduces both rules (``_layer_window``).

``backend`` selects attention: ``"auto"`` is the CUDA flash-attention kernel
on a CUDA tensor and the plain blockwise version on the CPU; ``"jnp"`` the
plain version on any device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..core.types import resolve_device
from .common import apply_rope, decode_attention, dense_init, flash_attention
from .common import rms_norm, swiglu
from .moe import moe_apply, moe_init

AUX_KEYS = ("lb_loss", "z_loss", "frac_dropped")


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str = "lm"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 2
    d_ff: int = 512                  # dense FFN width / per-expert width
    vocab: int = 1024
    head_dim: Optional[int] = None   # default d_model // n_heads
    rope_theta: float = 10000.0
    # MoE
    n_experts: int = 0               # 0 → dense model
    top_k: int = 1
    n_shared_experts: int = 0        # shared experts, width n · d_ff
    moe_period: int = 1              # every p-th scanned layer is MoE
    first_dense: int = 0             # leading dense layers
    capacity_factor: float = 1.25
    dispatch_groups: int = 1         # MoE dispatch groups
    # attention pattern
    window: Optional[int] = None     # sliding-window size
    window_period: int = 0           # see the module docstring (C.6)
    dtype: torch.dtype = torch.bfloat16
    # loss weights (loss_fn's MoE aux terms)
    lb_coef: float = 0.01
    z_coef: float = 1e-3

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def n_scan_layers(self) -> int:
        return self.n_layers - self.first_dense

    def n_moe_layers(self) -> int:
        return sum(_is_moe_layer(self, i) for i in range(self.n_layers))

    def param_count(self) -> int:
        d, hd, H, KV = self.d_model, self.hd, self.n_heads, self.n_kv_heads
        attn = d * (H + 2 * KV) * hd + H * hd * d + 2 * d
        dense_ffn = 3 * d * self.d_ff
        moe_ffn = (self.n_experts * 3 * d * self.d_ff
                   + self.n_shared_experts * 3 * d * self.d_ff
                   + d * self.n_experts)
        n_moe = self.n_moe_layers()
        return (self.n_layers * attn + (self.n_layers - n_moe) * dense_ffn
                + n_moe * moe_ffn + 2 * self.vocab * d + d)

    def active_param_count(self) -> int:
        """The reference's count: ``param_count`` less, in each MoE layer,
        ``n_experts − (top_k + n_shared_experts)`` experts' weights."""
        idle = ((self.n_experts - self.top_k - self.n_shared_experts)
                * 3 * self.d_model * self.d_ff)
        return self.param_count() - self.n_moe_layers() * idle


def _is_moe_layer(cfg: LMConfig, i: int) -> bool:
    if not cfg.is_moe or i < cfg.first_dense:
        return False
    return (i - cfg.first_dense) % cfg.moe_period == cfg.moe_period - 1


def _layer_window(cfg: LMConfig, i: int) -> Optional[int]:
    """Layer i's window under the reference's two rules (C.6): a leading
    dense layer by its index i, a scanned layer by its sub-layer index j
    inside one MoE period."""
    if cfg.window is None or cfg.window_period == 0:
        return None
    if i >= cfg.first_dense:
        i = (i - cfg.first_dense) % (cfg.moe_period if cfg.is_moe else 1)
    if i % cfg.window_period == cfg.window_period - 1:
        return None        # periodic global layer
    return cfg.window


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _layer_init(cfg: LMConfig, gen: torch.Generator, device,
                moe_layer: bool) -> dict:
    d, hd, H, KV = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads

    def w(d_in, d_out):
        return dense_init(gen, d_in, d_out, cfg.dtype, device=device)

    p = {
        "ln1": torch.ones(d, device=device),
        "wq": w(d, H * hd), "wk": w(d, KV * hd), "wv": w(d, KV * hd),
        "wo": w(H * hd, d),
        "ln2": torch.ones(d, device=device),
    }
    if moe_layer:
        p["moe"] = moe_init(gen, d, cfg.d_ff, cfg.n_experts, cfg.dtype,
                            device=device)
        if cfg.n_shared_experts:
            ff = cfg.n_shared_experts * cfg.d_ff
            p["shared"] = {"w_gate": w(d, ff), "w_up": w(d, ff),
                           "w_down": w(ff, d)}
    else:
        p["ffn"] = {"w_gate": w(d, cfg.d_ff), "w_up": w(d, cfg.d_ff),
                    "w_down": w(cfg.d_ff, d)}
    return p


def init(cfg: LMConfig, gen: Optional[torch.Generator] = None,
         device="cuda") -> dict:
    """Parameters on ``device``, drawn from ``gen`` (a generator on that
    device; seed 0 if None).  Norm gains and routers are f32, weights
    ``cfg.dtype``.  A MoE config's scanned layers must fill whole periods,
    as the reference asserts."""
    if cfg.is_moe and cfg.n_scan_layers % cfg.moe_period:
        raise ValueError(f"{cfg.name}: scan layers {cfg.n_scan_layers} not "
                         f"divisible by moe_period {cfg.moe_period}")
    dev = resolve_device(device)
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(0)
    return {
        "embed": dense_init(gen, cfg.vocab, cfg.d_model, cfg.dtype,
                            scale=0.02, device=dev),
        "unembed": dense_init(gen, cfg.d_model, cfg.vocab, cfg.dtype,
                              device=dev),
        "ln_f": torch.ones(cfg.d_model, device=dev),
        "layers": [_layer_init(cfg, gen, dev, _is_moe_layer(cfg, i))
                   for i in range(cfg.n_layers)],
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


def _ffn(cfg: LMConfig, p: dict, x: torch.Tensor,
         aux: Optional[dict]) -> torch.Tensor:
    """x + the layer's FFN on rms_norm(x): the dense SwiGLU, or the routed
    experts plus the shared experts' SwiGLU (adding the routed experts'
    aux into ``aux`` unless it is None)."""
    h = rms_norm(x, p["ln2"])
    if "moe" not in p:
        f = p["ffn"]
        return x + swiglu(h, f["w_gate"], f["w_up"], f["w_down"])
    out, a = moe_apply(p["moe"], h.reshape(-1, cfg.d_model), cfg.top_k,
                       cfg.capacity_factor, n_groups=cfg.dispatch_groups)
    if aux is not None:
        for key in AUX_KEYS:
            aux[key] = aux[key] + a[key]
    out = out.reshape(h.shape)
    if "shared" in p:
        sh = p["shared"]
        out = out + swiglu(h, sh["w_gate"], sh["w_up"], sh["w_down"])
    return x + out


def _layer(cfg: LMConfig, p: dict, x: torch.Tensor, positions: torch.Tensor,
           window: Optional[int], backend: str):
    """One layer → (x, its MoE aux, or None for a dense layer)."""
    x = _attn(cfg, p, x, positions, window, backend)
    aux = ({key: torch.zeros((), device=x.device) for key in AUX_KEYS}
           if "moe" in p else None)
    return _ffn(cfg, p, x, aux), aux


def _hidden(cfg: LMConfig, params: dict, tokens: torch.Tensor,
            backend: str, remat: bool = False) -> tuple[torch.Tensor, dict]:
    """tokens int[B, S] → (the final-normed hidden states [B, S, d], aux);
    with ``remat`` each layer is checkpointed."""
    B, S = tokens.shape
    x = params["embed"][tokens.long()]
    positions = torch.arange(S, device=x.device).expand(B, S)
    aux = {key: torch.zeros((), device=x.device) for key in AUX_KEYS}
    for i, p in enumerate(params["layers"]):
        args = (cfg, p, x, positions, _layer_window(cfg, i), backend)
        x, a = (checkpoint(_layer, *args, use_reentrant=False) if remat
                else _layer(*args))
        if a is not None:
            for key in AUX_KEYS:
                aux[key] = aux[key] + a[key]
    n_moe = max(cfg.n_moe_layers(), 1)
    return (rms_norm(x, params["ln_f"]),
            {key: v / n_moe for key, v in aux.items()})


def forward_aux(cfg: LMConfig, params: dict, tokens: torch.Tensor,
                backend: str = "auto") -> tuple[torch.Tensor, dict]:
    """The reference's ``forward``: tokens int[B, S] → (logits f32[B, S, V]
    (a ``cfg.dtype`` product cast to f32), aux).  A training loss adds
    ``lb_coef · lb_loss + z_coef · z_loss`` of a MoE model from here."""
    x, aux = _hidden(cfg, params, tokens, backend)
    return (x @ params["unembed"]).float(), aux


def forward(cfg: LMConfig, params: dict, tokens: torch.Tensor,
            backend: str = "auto") -> torch.Tensor:
    """tokens int[B, S] → logits f32[B, S, V]."""
    return forward_aux(cfg, params, tokens, backend)[0]


def loss_fn(cfg: LMConfig, params: dict, tokens: torch.Tensor,
            targets: torch.Tensor, remat: bool = True,
            backend: str = "auto") -> tuple[torch.Tensor, dict]:
    """The reference's training loss: the mean over [B, S] of each
    position's logsumexp of the f32 logits less its target's logit, plus
    ``lb_coef · lb_loss + z_coef · z_loss`` for a MoE model → (loss,
    {"nll", "lb_loss", "z_loss", "frac_dropped"})."""
    x, aux = _hidden(cfg, params, tokens, backend, remat)
    logits = (x @ params["unembed"]).float()
    nll = (torch.logsumexp(logits, dim=-1)
           - logits.gather(-1, targets.long()[..., None])[..., 0]).mean()
    loss = nll
    if cfg.is_moe:
        loss = loss + cfg.lb_coef * aux["lb_loss"] + cfg.z_coef * aux["z_loss"]
    return loss, {"nll": nll, **aux}


def prefill_aux(cfg: LMConfig, params: dict, tokens: torch.Tensor,
                backend: str = "auto") -> tuple[torch.Tensor, dict]:
    """The full forward over the prompt → (last-position logits f32[B, V],
    aux)."""
    x, aux = _hidden(cfg, params, tokens, backend)
    return (x[:, -1, :] @ params["unembed"]).float(), aux


def prefill(cfg: LMConfig, params: dict, tokens: torch.Tensor,
            backend: str = "auto") -> torch.Tensor:
    """The full forward over the prompt; returns last-position logits
    f32[B, V]."""
    return prefill_aux(cfg, params, tokens, backend)[0]


# ---------------------------------------------------------------------------
# serving: KV cache + decode step
# ---------------------------------------------------------------------------

def init_cache(cfg: LMConfig, batch: int, max_seq: int,
               device="cuda") -> dict:
    """KV cache: ``k``/``v`` [L, B, max_seq, KV, hd] in ``cfg.dtype`` over
    every layer and ``pos`` int32[B]."""
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
    in place).  A MoE layer dispatches the step's B tokens as one batch
    (T = B)."""
    pos = cache["pos"]
    x = params["embed"][tokens.long()][:, None, :]
    for i, p in enumerate(params["layers"]):
        x = _attn_decode(cfg, p, x, cache["k"][i], cache["v"][i], pos,
                         _layer_window(cfg, i))
        x = _ffn(cfg, p, x, None)
    x = rms_norm(x[:, 0, :], params["ln_f"])
    logits = (x @ params["unembed"]).float()
    return logits, {"k": cache["k"], "v": cache["v"], "pos": pos + 1}
