"""Llama-family decoder as plain functions over a parameter dict.

Port of ``picotron_tpu/models/llama.py`` (tp = 1, no pipeline): Embedding
-> N x DecoderLayer (RMSNorm -> attention with RoPE and GQA -> residual ->
RMSNorm -> SwiGLU MLP -> residual) -> final RMSNorm -> untied LM head.

The parameter layout is the JAX package's, so weights carry across as
arrays (``convert.params_from_jax``): linear weights ``(in, out)`` applied
as ``x @ w``, decoder layers stacked on a leading ``[L, ...]`` axis. Init
laws are the same: linear weights U(-sqrt(1/fan_in), sqrt(1/fan_in)),
embedding N(0, 1), norm weights ones (drawn from a ``torch.Generator``, so
the values differ from ``jax.random``'s).

RMSNorm and attention dispatch on the tensor's device: CUDA tensors go
through the hand-written kernels (``ops/kernels``), CPU tensors through
their plain versions. The projections and the LM head are ``torch.matmul``,
as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from picotron_tpu_torch.config import Config, ModelConfig
from picotron_tpu_torch.ops.attention import sdpa
from picotron_tpu_torch.ops.kernels.flash_attention import flash_attention
from picotron_tpu_torch.ops.kernels.rmsnorm import rms_norm
from picotron_tpu_torch.ops.rope import apply_rope, precompute_rope
from picotron_tpu_torch.utils import torch_dtype

Params = dict[str, Any]

def init_params(m: ModelConfig, seed: int = 0, device=None) -> Params:
    """Random parameters with the JAX package's init laws, drawn on
    ``device`` from a generator seeded with ``seed``."""
    H, I, V, L = (m.hidden_size, m.intermediate_size, m.vocab_size,
                  m.num_hidden_layers)
    D = m.head_dim
    Hq, Hkv = m.num_attention_heads * D, m.num_key_value_heads * D
    dt = torch_dtype(m.dtype)
    device = torch.device(device if device is not None else "cpu")
    gen = torch.Generator(device=device).manual_seed(seed)

    def uniform(shape, fan_in):
        bound = math.sqrt(1.0 / fan_in)
        w = torch.empty(shape, dtype=torch.float32, device=device)
        return w.uniform_(-bound, bound, generator=gen).to(dt)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    layers = {
        "attn_norm": ones(L, H),
        "wq": uniform((L, H, Hq), H),
        "wk": uniform((L, H, Hkv), H),
        "wv": uniform((L, H, Hkv), H),
        "wo": uniform((L, Hq, H), Hq),
        "mlp_norm": ones(L, H),
        "w_gate": uniform((L, H, I), H),
        "w_up": uniform((L, H, I), H),
        "w_down": uniform((L, I, H), I),
    }
    embed = torch.empty((V, H), dtype=torch.float32, device=device)
    return {
        "embed": embed.normal_(generator=gen).to(dt),
        "layers": layers,
        "final_norm": ones(H),
        "lm_head": uniform((H, V), H),
    }


def embed_lookup(w: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding rows for ``tokens`` (tp = 1: the whole vocab is local)."""
    return w[tokens.long()]


def _attention(q, k, v, cfg: Config, cache=None, pos=None):
    """Full-sequence causal attention (prefill), or -- with ``cache`` --
    S fresh queries attending over this layer's updated cache block, with
    ``pos`` [B] the first row just written per sequence (valid key count
    ``pos + S``; ``inference.attend_impl`` picks the kernel)."""
    scale = 1.0 / math.sqrt(cfg.model.head_dim)
    if cache is not None:
        from picotron_tpu_torch.inference.kv_cache import attend

        return attend(q, cache, pos + q.shape[1], scale,
                      impl=cfg.inference.attend_impl)
    impl = cfg.model.attention_impl
    if impl == "auto":
        impl = "flash" if q.is_cuda else "sdpa"
    if impl == "flash":
        return flash_attention(q, k, v, scale)  # compact GQA K/V
    g = q.shape[2] // k.shape[2]
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    return sdpa(q, k, v, scale, causal=True)


def _norm(x, w, cfg: Config):
    return rms_norm(x, w, cfg.model.rms_norm_eps)


def decoder_layer(lp: Params, h: torch.Tensor, cos, sin, cfg: Config,
                  cache: Optional[dict] = None, pos=None,
                  return_kv: bool = False):
    """One decoder block. Inference hooks as in the JAX package:

    - ``return_kv=True`` (prefill): also return the rotated compact K/V
      block [B, S, n_kv, head_dim] -> ``(h, (k, v))``;
    - ``cache={"k", "v"}`` (this layer's [B, T, n_kv, head_dim] blocks) and
      ``pos`` [B]: write the new tokens' K/V at each sequence's ``pos``
      (in place) and attend over the cache; ``cos``/``sin`` are then the
      per-sequence [B, S, head_dim] tables -> ``(h, cache)``.
    """
    m = cfg.model
    nh, nkv, D = m.num_attention_heads, m.num_key_value_heads, m.head_dim
    x = _norm(h, lp["attn_norm"], cfg)
    B, S, _ = x.shape
    q = (x @ lp["wq"]).reshape(B, S, nh, D)
    k = (x @ lp["wk"]).reshape(B, S, nkv, D)
    v = (x @ lp["wv"]).reshape(B, S, nkv, D)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if cache is not None:
        from picotron_tpu_torch.inference.kv_cache import cache_write

        cache_write(cache, k, v, pos)
        o = _attention(q, None, None, cfg, cache=cache, pos=pos)
    else:
        o = _attention(q, k, v, cfg)
    h = h + o.reshape(B, S, nh * D) @ lp["wo"]
    x = _norm(h, lp["mlp_norm"], cfg)
    out = h + (F.silu(x @ lp["w_gate"]) * (x @ lp["w_up"])) @ lp["w_down"]
    if cache is not None:
        return out, cache
    return (out, (k, v)) if return_kv else out


def layer_params(params: Params, i: int) -> Params:
    """Layer ``i``'s slice of the stacked layer leaves."""
    return {name: w[i] for name, w in params["layers"].items()}


def head_logits(params: Params, h: torch.Tensor, cfg: Config) -> torch.Tensor:
    """Final norm + untied LM head."""
    return _norm(h, params["final_norm"], cfg) @ params["lm_head"]


def forward_logits(params: Params, tokens: torch.Tensor,
                   cfg: Config) -> torch.Tensor:
    """Whole-model forward to logits: tokens [B, S] -> [B, S, V]."""
    m = cfg.model
    dt = torch_dtype(m.dtype)
    S = tokens.shape[-1]
    cos, sin = precompute_rope(S, m.head_dim, m.rope_theta, dt,
                               device=tokens.device)
    h = embed_lookup(params["embed"], tokens).to(dt)
    for i in range(m.num_hidden_layers):
        h = decoder_layer(layer_params(params, i), h, cos, sin, cfg)
    return head_logits(params, h, cfg)
