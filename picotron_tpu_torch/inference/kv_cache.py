"""Preallocated slot-based KV cache and the cache-attention dispatch.

Port of ``picotron_tpu/inference/kv_cache.py`` for the contiguous layout:

- ``k``/``v``: ``[num_layers, slots, max_seq_len, n_kv_heads, head_dim]``
  with compact GQA heads (never repeated);
- ``lengths``: ``[slots]`` int32, each slot's count of parked tokens. Slot
  ``b`` sees keys ``t < lengths[b]``; a freed slot has length 0, so its
  stale rows are unreachable;
- int8 mode (``inference.kv_cache_dtype: "int8"``): ``k``/``v`` hold
  absmax-quantized int8 rows and the cache gains fp32 ``k_scale``/
  ``v_scale`` ``[num_layers, slots, max_seq_len, n_kv_heads]``, one scale
  per written row per kv head. Rows quantize on write; the flash attend
  sends the int8 bytes and scales to kernel C's int8 variant, which
  dequantizes in registers; the dense attend dequantizes the block to
  fp32 first, as the JAX package does.

A paged layer cache (its dict carries ``block_tables``: the paged
layout, ``inference/paged_kv.py``) takes the paged write and attend of
that module.

Unlike the JAX package, whose arrays are immutable, the port updates the
cache IN PLACE (``cache_write``, ``insert_prefill``, ``release``): the
cache is the largest tensor a server holds, and a copy per token would
double it. The functions still return the cache for call-site symmetry.
"""

from __future__ import annotations

import torch

from picotron_tpu_torch.config import ModelConfig
from picotron_tpu_torch.ops.attention import NEG_INF
from picotron_tpu_torch.ops.kernels.decode_attention import flash_decode_attention
from picotron_tpu_torch.utils import torch_dtype

# int8 symmetric range; scales are fp32, so dequantization is one multiply
# with no second rounding
INT8_MAX = 127.0
SCALE_DTYPE = torch.float32


def init_cache(m: ModelConfig, slots: int, max_seq_len: int, dtype=None,
               device=None, quantized: bool = False) -> dict:
    """Zeroed cache for ``slots`` concurrent sequences (int8 values plus
    fp32 scales with ``quantized``)."""
    shape = (m.num_hidden_layers, slots, max_seq_len, m.num_key_value_heads,
             m.head_dim)
    if quantized:
        cache = {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                 "v": torch.zeros(shape, dtype=torch.int8, device=device),
                 "k_scale": torch.zeros(shape[:-1], dtype=SCALE_DTYPE,
                                        device=device),
                 "v_scale": torch.zeros(shape[:-1], dtype=SCALE_DTYPE,
                                        device=device)}
    else:
        dt = dtype if dtype is not None else torch_dtype(m.dtype)
        cache = {"k": torch.zeros(shape, dtype=dt, device=device),
                 "v": torch.zeros(shape, dtype=dt, device=device)}
    cache["lengths"] = torch.zeros((slots,), dtype=torch.int32,
                                   device=device)
    return cache


def cache_bytes(cache: dict) -> int:
    """Bytes the cache occupies (K/V, scales and lengths)."""
    return sum(t.numel() * t.element_size() for t in cache.values())


def quantize_kv(x: torch.Tensor) -> tuple:
    """Absmax-quantize rows of ``x`` [..., head_dim] to int8 with one fp32
    scale per leading index (per written row per kv head). A zero row
    quantizes to zeros with scale 0."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = amax / INT8_MAX
    q = torch.round(xf / torch.clamp(scale, min=1e-12)[..., None])
    return q.clamp_(-INT8_MAX, INT8_MAX).to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype) -> torch.Tensor:
    """Inverse of ``quantize_kv``: [..., D] int8 x [...] scale -> dtype."""
    return (q.float() * scale[..., None]).to(dtype)


def quantized(cache: dict) -> bool:
    """Whether a cache (whole or one layer's) stores int8 K/V."""
    return "k_scale" in cache


def cache_write(layer_cache: dict, k_new: torch.Tensor, v_new: torch.Tensor,
                pos: torch.Tensor) -> dict:
    """Write fresh K/V rows [B, S, H, D] into one layer's [B, T, H, D]
    blocks, slot ``b`` from row ``pos[b]`` on (in place). Three shapes:

    - decode (S == 1): every slot writes one row (free slots their
      invisible row 0);
    - a prefill chunk (S > 1, B == 1): one slot writes S rows, which the
      engine keeps inside the window (the chunk window slides back from
      the end);
    - the speculative verify (S > 1, B > 1, or any write that carries a
      ``draft_valid`` entry): every slot writes S rows from its own
      position. Rows past the window drop (they never land on an earlier
      row), and so do the rows at or past a slot's ``draft_valid`` [B]
      count of real fed tokens, the ragged verify's mask that the engine
      splices into each layer's dict for the dispatch. Rows past the
      post-acceptance length stay stale and unreachable: the length
      pointer is the rewind.

    An int8 cache quantizes on write, its scale rows landing at the same
    positions. In the first two shapes a row index that would leave the
    window is clamped, which only keeps a broken caller from faulting the
    device. A paged layer cache takes ``paged_kv.cache_write``."""
    if "block_tables" in layer_cache:
        from picotron_tpu_torch.inference import paged_kv

        return paged_kv.cache_write(layer_cache, k_new, v_new, pos)
    valid = layer_cache.get("draft_valid")
    B, S = k_new.shape[:2]
    if S > 1 and (B > 1 or valid is not None):
        return _masked_write(layer_cache, k_new, v_new, pos, valid)
    T = layer_cache["k"].shape[1]
    rows = (pos.long()[:, None]
            + torch.arange(S, device=pos.device)[None, :]).clamp_(max=T - 1)
    bidx = torch.arange(B, device=pos.device)[:, None]
    for name, new in (("k", k_new), ("v", v_new)):
        if quantized(layer_cache):
            vals, scales = quantize_kv(new)
            layer_cache[name + "_scale"][bidx, rows] = scales
        else:
            vals = new.to(layer_cache[name].dtype)
        layer_cache[name][bidx, rows] = vals
    return layer_cache


def _masked_write(layer_cache: dict, k_new: torch.Tensor,
                  v_new: torch.Tensor, pos: torch.Tensor,
                  valid: torch.Tensor | None) -> dict:
    """The verify write: slot ``b``'s fresh row ``s`` lands at row
    ``pos[b] + s`` when that row is inside the window and ``s <
    valid[b]``, and nowhere otherwise. Each slot rewrites the S rows of a
    window that starts at ``min(pos[b], T - S)`` (distinct rows, inside
    the cache), each with its fresh row where one lands and its old bytes
    elsewhere: no index repeats, so the result does not depend on the
    order of the writes, and nothing waits on the host."""
    B, S = k_new.shape[:2]
    T = layer_cache["k"].shape[1]
    if S > T:
        raise ValueError(f"a write of {S} rows a slot exceeds the cache "
                         f"window of {T}")
    dev = pos.device
    p = pos.long()[:, None]
    rows = p.clamp(max=T - S) + torch.arange(S, device=dev)[None, :]
    src = rows - p  # the fresh row each window row would take
    keep = (src >= 0) & (src < S)
    if valid is not None:
        keep &= src < valid.long()[:, None]
    src = src.clamp(0, S - 1)
    bidx = torch.arange(B, device=dev)[:, None]
    for name, new in (("k", k_new), ("v", v_new)):
        if quantized(layer_cache):
            vals, scales = quantize_kv(new)
            sname = name + "_scale"
            layer_cache[sname][bidx, rows] = torch.where(
                keep[..., None], scales[bidx, src],
                layer_cache[sname][bidx, rows])
        else:
            vals = new.to(layer_cache[name].dtype)
        layer_cache[name][bidx, rows] = torch.where(
            keep[..., None, None], vals[bidx, src],
            layer_cache[name][bidx, rows])
    return layer_cache


def attend(q: torch.Tensor, layer_cache: dict, lengths: torch.Tensor,
           scale: float, impl: str = "dense") -> torch.Tensor:
    """Masked attention of S fresh queries against one layer's cache block;
    ``impl`` is ``inference.attend_impl``: "flash" the length-aware
    flash-decode kernel (an int8 cache's bytes and scales go to its int8
    variant as stored; CPU tensors take the plain versions), "dense"
    ``decode_attention`` over the whole window (an int8 cache dequantized
    to fp32 first). A paged layer cache takes ``paged_kv.attend``."""
    if "block_tables" in layer_cache:
        from picotron_tpu_torch.inference import paged_kv

        return paged_kv.attend(q, layer_cache, lengths, scale, impl=impl)
    if impl == "flash":
        return flash_decode_attention(q, layer_cache["k"], layer_cache["v"],
                                      lengths.to(torch.int32), scale,
                                      k_scale=layer_cache.get("k_scale"),
                                      v_scale=layer_cache.get("v_scale"))
    if impl != "dense":
        raise ValueError(f"unknown attend impl {impl!r} (dense|flash)")
    if quantized(layer_cache):
        k = dequantize_kv(layer_cache["k"], layer_cache["k_scale"],
                          torch.float32)
        v = dequantize_kv(layer_cache["v"], layer_cache["v_scale"],
                          torch.float32)
    else:
        k, v = layer_cache["k"], layer_cache["v"]
    return decode_attention(q, k, v, lengths, scale)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, scale: float) -> torch.Tensor:
    """The dense reference: q [B, S, n_heads, D] (the last query at
    position ``lengths[b] - 1``) against the whole [B, T, n_kv, D] block,
    GQA by a grouped einsum, fp32 softmax with the large-negative mask
    fill, output in q.dtype. A row with no visible key comes out as the
    uniform average (it is never consumed)."""
    B, S, nh, D = q.shape
    T, nkv = k.shape[1], k.shape[2]
    g = nh // nkv
    qg = q.reshape(B, S, nkv, g, D).float()
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * scale
    pos_q = (lengths.long()[:, None] - S
             + torch.arange(S, device=q.device)[None, :])  # [B, S]
    mask = torch.arange(T, device=q.device)[None, None, :] <= pos_q[:, :, None]
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return out.reshape(B, S, nh, D).to(q.dtype)


def insert_prefill(cache: dict, kv: dict, slot: int, length: int) -> dict:
    """Park a prefill's ``{"k", "v"[, "k_scale", "v_scale"]}:
    [L, 1, S_bucket, H(, D)]`` blocks in ``slot`` and set its length (in
    place; an int8 cache's blocks come quantized from the engine). Rows
    past ``length`` (the bucket pad) are written but unreachable under the
    length mask."""
    s = kv["k"].shape[2]
    for name in cache:
        if name != "lengths":
            cache[name][:, slot, :s] = kv[name][:, 0].to(cache[name].dtype)
    cache["lengths"][slot: slot + 1].fill_(length)
    return cache


def release(cache: dict, slot: int) -> dict:
    """Free a slot: zero its length so no stale key is visible again."""
    cache["lengths"][slot: slot + 1].fill_(0)
    return cache


def live_tokens(cache: dict) -> torch.Tensor:
    """Tokens parked across all slots: the sum of the lengths (an
    occupancy figure for the batcher and benchmarks)."""
    return cache["lengths"].sum()
