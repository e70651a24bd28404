"""Llama-family decoder as plain functions over a parameter dict.

Port of ``picotron_tpu/models/llama.py`` (tp = 1, no pipeline): Embedding
-> N x DecoderLayer (RMSNorm -> attention with RoPE and GQA -> residual ->
RMSNorm -> SwiGLU MLP -> residual) -> final RMSNorm -> untied LM head.
The training path is ``stage_apply`` (pp = 1): ``layers_forward`` with
optional per-layer recompute, then ``loss_from_hidden``.

The parameter layout is the JAX package's, so weights carry across as
arrays (``convert.params_from_jax``): linear weights ``(in, out)`` applied
as ``x @ w``, decoder layers stacked on a leading ``[L, ...]`` axis. Init
laws are the same: linear weights U(-sqrt(1/fan_in), sqrt(1/fan_in)),
embedding N(0, 1), norm weights ones (drawn from a ``torch.Generator``, so
the values differ from ``jax.random``'s).

RMSNorm and attention dispatch on the tensor's device: CUDA tensors go
through the hand-written kernels (``ops/kernels``), CPU tensors through
their plain versions; under autograd the kernels' ``autograd.Function``s
run the backward kernels (D for RMSNorm, E and F for attention). The
projections and the LM head go through ``matmul``, which dispatches on
the weight leaf's form: a plain tensor is ``torch.matmul`` (as the JAX
package leaves it to XLA), a quantized ``{"q", "s"}`` pair
(``quantize_params``, serving with ``inference.weight_dtype: "int8"``)
kernel G.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from picotron_tpu_torch.config import Config, ModelConfig
from picotron_tpu_torch.ops import quant_matmul as qmm
from picotron_tpu_torch.ops.attention import sdpa
from picotron_tpu_torch.ops.cross_entropy import (
    cross_entropy_fused,
    cross_entropy_gathered,
)
from picotron_tpu_torch.ops.kernels.flash_attention import flash_attention
from picotron_tpu_torch.ops.kernels.rmsnorm import rms_norm, rms_norm_plain
from picotron_tpu_torch.ops.rope import apply_rope, precompute_rope
from picotron_tpu_torch.utils import torch_dtype

Params = dict[str, Any]

# The matmul weights that inference.weight_dtype "int8" quantizes per
# output channel: the seven decoder-layer projections, plus "lm_head" at
# the top of the tree. The embedding (a gather) and the norms stay full
# precision.
QUANT_WEIGHT_LEAVES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


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
    """``model.use_pallas_rmsnorm`` picks the RMSNorm: None = the kernels
    for CUDA tensors, True = the kernels' wrapper always, False = the
    plain version (differentiated by torch autograd)."""
    use_kernel = cfg.model.use_pallas_rmsnorm
    if use_kernel is None:
        use_kernel = x.is_cuda
    norm = rms_norm if use_kernel else rms_norm_plain
    return norm(x, w, cfg.model.rms_norm_eps)


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
    q = matmul(x, lp["wq"]).reshape(B, S, nh, D)
    k = matmul(x, lp["wk"]).reshape(B, S, nkv, D)
    v = matmul(x, lp["wv"]).reshape(B, S, nkv, D)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if cache is not None:
        from picotron_tpu_torch.inference.kv_cache import cache_write

        cache_write(cache, k, v, pos)
        o = _attention(q, None, None, cfg, cache=cache, pos=pos)
    else:
        o = _attention(q, k, v, cfg)
    h = h + matmul(o.reshape(B, S, nh * D), lp["wo"])
    x = _norm(h, lp["mlp_norm"], cfg)
    out = h + matmul(F.silu(matmul(x, lp["w_gate"])) * matmul(x, lp["w_up"]),
                     lp["w_down"])
    if cache is not None:
        return out, cache
    return (out, (k, v)) if return_kv else out


def layer_params(params: Params, i: int) -> Params:
    """Layer ``i``'s slice of the stacked layer leaves (a quantized pair
    slices both of its tensors)."""
    return {name: ({"q": w["q"][i], "s": w["s"][i]}
                   if qmm.is_quant_weight(w) else w[i])
            for name, w in params["layers"].items()}


def matmul(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w``, dispatching on the weight leaf's form: a tensor runs
    the dense matmul; a quantized ``{"q": int8, "s": fp32}`` pair runs
    ``quant_matmul`` (kernel G on the card), whose output follows
    ``x.dtype``. (The JAX package's adapter-wrapped LoRA leaf is not
    ported yet.)"""
    if qmm.is_quant_weight(w):
        return qmm.quant_matmul(x, w["q"], w["s"])
    return x @ w


def quantize_params(params: Params) -> Params:
    """Every ``QUANT_WEIGHT_LEAVES`` weight and ``lm_head`` as a
    per-output-channel int8 pair; the embedding and the norms pass
    through. Eager and one layer at a time (the JAX package's
    leaf-by-leaf rule keeps the scales bit-identical across paths; a
    layer at a time bounds the fp32 transient to one layer's matrix), on
    each leaf's own device. The caller drops the dense tree."""
    def stack(w):
        parts = [qmm.quantize_weight(w[i]) for i in range(w.shape[0])]
        return {"q": torch.stack([p["q"] for p in parts]),
                "s": torch.stack([p["s"] for p in parts])}

    layers = {k: (stack(v) if k in QUANT_WEIGHT_LEAVES else v)
              for k, v in params["layers"].items()}
    return {**params, "layers": layers,
            "lm_head": qmm.quantize_weight(params["lm_head"])}


def dequantize_params(params: Params, dtype: torch.dtype) -> Params:
    """The fake-quant reference tree: every quantized leaf dequantized to
    ``dtype``. TESTS AND PARITY CHECKS ONLY: a dense engine fed this tree
    carries the same quantization error as the int8 engine, so the two
    differ only in the int8 plumbing."""
    def deq(leaf):
        if qmm.is_quant_weight(leaf):
            return qmm.dequantize_weight(leaf["q"], leaf["s"], dtype)
        return leaf

    layers = {k: deq(v) for k, v in params["layers"].items()}
    return {**params, "layers": layers, "lm_head": deq(params["lm_head"])}


def param_bytes(params: Params) -> int:
    """Bytes the parameter tree occupies (int8 values and fp32 scales
    included): the ``weight_bytes`` that int8 weights roughly halve."""
    def walk(node):
        if isinstance(node, dict):
            return sum(walk(v) for v in node.values())
        return node.numel() * node.element_size()

    return walk(params)


def layers_forward(stacked: Params, h: torch.Tensor, cos, sin,
                   cfg: Config) -> torch.Tensor:
    """Every decoder layer over ``h`` (the JAX ``lax.scan`` over the
    stack, as a loop). ``training.remat == "full"`` wraps each layer in
    ``torch.utils.checkpoint`` (non-reentrant): the backward reruns the
    layer's forward and keeps only the layer-boundary activations. The
    stacked leaves are unbound once, so autograd returns each leaf's
    gradient as one stack of the per-layer gradients."""
    per_layer = {name: w.unbind(0) for name, w in stacked.items()}
    remat = cfg.training.remat == "full" and torch.is_grad_enabled()
    for i in range(cfg.model.num_hidden_layers):
        lp = {name: ws[i] for name, ws in per_layer.items()}
        if remat:
            h = checkpoint(decoder_layer, lp, h, cos, sin, cfg,
                           use_reentrant=False)
        else:
            h = decoder_layer(lp, h, cos, sin, cfg)
    return h


def loss_from_hidden(params: Params, h: torch.Tensor, targets: torch.Tensor,
                     cfg: Config) -> torch.Tensor:
    """Final norm -> LM head -> mean CE, by ``model.loss_impl``: "auto" and
    "fused" take the row-chunked fused linear + CE (fp32 logits never
    materialised whole); "gathered" and "vocab_parallel" (the same at
    tp = 1) take materialised logits and the plain CE."""
    x = _norm(h, params["final_norm"], cfg)
    if cfg.model.loss_impl in ("auto", "fused"):
        return cross_entropy_fused(x, params["lm_head"], targets)
    return cross_entropy_gathered(x @ params["lm_head"], targets)


def rope_tables(cfg: Config) -> tuple:
    """Full-sequence (cos, sin) tables for the training sequence length,
    in the compute dtype, on the CPU (``stage_apply`` moves them)."""
    m = cfg.model
    return precompute_rope(cfg.training.seq_length, m.head_dim,
                           m.rope_theta, torch_dtype(m.dtype))


def stage_apply(params: Params, tokens: torch.Tensor, targets: torch.Tensor,
                cos, sin, cfg: Config) -> tuple:
    """The pp = 1 training program (the JAX ``stage_apply`` through
    ``_stage_input`` and ``_stage_loss`` on a single stage): embed ->
    layers -> loss. tokens/targets [B, S] -> (h [B, S, H], loss)."""
    h = embed_lookup(params["embed"], tokens).to(torch_dtype(cfg.model.dtype))
    h = layers_forward(params["layers"], h, cos, sin, cfg)
    return h, loss_from_hidden(params, h, targets, cfg)


def num_params(m: ModelConfig) -> int:
    """Global parameter count, from the shapes."""
    H, I, V, L, D = (m.hidden_size, m.intermediate_size, m.vocab_size,
                     m.num_hidden_layers, m.head_dim)
    per_layer = (H * m.num_attention_heads * D
                 + 2 * H * m.num_key_value_heads * D
                 + m.num_attention_heads * D * H + 3 * H * I + 2 * H)
    return V * H + L * per_layer + H + H * V


def head_logits(params: Params, h: torch.Tensor, cfg: Config) -> torch.Tensor:
    """Final norm + untied LM head (int8 pair or tensor, via ``matmul``)."""
    return matmul(_norm(h, params["final_norm"], cfg), params["lm_head"])


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
