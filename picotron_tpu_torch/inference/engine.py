"""The batched generation engine: prefill and decode on one device.

Port of the serving subset of ``picotron_tpu/inference/engine.py``:

- ``prefill(params, prompt)``: the full-sequence model over a right-padded
  power-of-two prompt bucket, returning the per-layer compact K/V blocks
  and the last real token's logits. Pad rows are inert (causal mask ahead,
  length mask behind).
- ``prefill_chunked(params, cache, prompt, slot)``: prompts longer than
  ``prefill_chunk`` run as fixed-width chunks that attend over the cache
  prefix plus the chunk and write K/V straight into the slot.
- ``decode_block(...)``: ``decode_block_len`` autoregressive steps for
  every slot. Per-slot stop state (EOS id, remaining budget, the active
  mask derived from the cache lengths) stays on the device, so the host
  reads results once per block.

Weights and cache come in two storage forms each: ``weight_dtype``
"bf16" (the dense tree) or "int8" (the tree from
``llama.quantize_params``: every matmul site dispatches on its leaf, so
the engine only records the choice), and ``cache_dtype`` full precision
or int8 (``kv_cache.py``: quantized on write, one-shot prefill blocks
quantized by ``_pack_kv`` before ``insert``).

The JAX package compiles each of these as one jitted program with
``lax.scan`` over layers and steps; here they are Python loops that
launch kernels eagerly. There is no flash-to-dense fallback: a kernel
failure raises.
"""

from __future__ import annotations

import numpy as np
import torch

from picotron_tpu_torch.config import Config
from picotron_tpu_torch.inference import kv_cache, sampling
from picotron_tpu_torch.models import llama
from picotron_tpu_torch.ops.rope import precompute_rope, rope_at_positions
from picotron_tpu_torch.utils import resolve_device, torch_dtype

MIN_PREFILL_BUCKET = 16  # the smallest power-of-two prompt bucket


class InferenceEngine:
    """Fixed-slot generation engine on one device.

    ``slots`` is the decode batch width; ``max_seq_len`` bounds prompt +
    generated tokens per slot (default: ``max_position_embeddings``).
    ``decode_block_len`` / ``prefill_chunk`` / ``attend_impl`` /
    ``weight_dtype`` default from ``cfg.inference``; keyword overrides win.
    ``cache_dtype`` ("int8", ``torch.int8``, or a full-precision torch
    dtype) wins over ``inference.kv_cache_dtype`` when given, so a caller
    can turn cache quantization off as well as on. ``device=None`` is the
    CUDA card (and raises without one); pass ``device="cpu"`` for the
    plain PyTorch path on the CPU.
    """

    def __init__(self, cfg: Config, device=None, *, slots: int = 8,
                 max_seq_len: int | None = None,
                 decode_block_len: int | None = None,
                 prefill_chunk: int | None = None,
                 attend_impl: str | None = None,
                 weight_dtype: str | None = None,
                 cache_dtype=None):
        self.cfg = Config.from_dict(cfg.to_dict())  # own copy: overrides land here
        self.device = resolve_device(device)
        m, inf = self.cfg.model, self.cfg.inference
        self.slots = int(slots)
        if self.slots < 1:
            raise ValueError("slots must be >= 1")
        self.max_seq_len = int(max_seq_len or m.max_position_embeddings)
        self.decode_block_len = int(decode_block_len
                                    if decode_block_len is not None
                                    else inf.decode_block_len)
        if self.decode_block_len < 1:
            raise ValueError("decode_block_len must be >= 1")
        self.prefill_chunk = int(prefill_chunk if prefill_chunk is not None
                                 else inf.prefill_chunk)
        if self.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        # a chunk wider than the cache window could never be written
        self.prefill_chunk = min(self.prefill_chunk, self.max_seq_len)
        if attend_impl is not None:
            if attend_impl not in ("dense", "flash"):
                raise ValueError(
                    f"unknown attend_impl {attend_impl!r} (dense|flash)")
            inf.attend_impl = attend_impl
        self.attend_impl = inf.attend_impl
        if weight_dtype is not None:
            if weight_dtype not in ("bf16", "int8"):
                raise ValueError(
                    f"unknown weight_dtype {weight_dtype!r} (bf16|int8)")
            inf.weight_dtype = weight_dtype
        self.weight_dtype = inf.weight_dtype
        self._dt = torch_dtype(m.dtype)
        if cache_dtype is None:
            cache_dtype = inf.kv_cache_dtype
        self.quantized = cache_dtype in ("int8", torch.int8)
        if self.quantized:
            self.cache_dtype = torch.int8
        elif cache_dtype == "auto":
            self.cache_dtype = self._dt
        elif isinstance(cache_dtype, torch.dtype):
            self.cache_dtype = cache_dtype
        else:
            raise ValueError(f"unknown cache_dtype {cache_dtype!r} (int8, "
                             f"'auto' or a torch dtype)")
        # angle tables cover the whole cache window; decode gathers rows at
        # each slot's own offset
        self._cos, self._sin = precompute_rope(
            self.max_seq_len, m.head_dim, m.rope_theta, self._dt,
            device=self.device)

    # ---- cache ------------------------------------------------------------

    def init_cache(self) -> dict:
        """A fresh zeroed cache on the engine's device."""
        return kv_cache.init_cache(
            self.cfg.model, self.slots, self.max_seq_len,
            dtype=None if self.quantized else self.cache_dtype,
            device=self.device, quantized=self.quantized)

    def insert(self, cache: dict, kv: dict, slot: int, length: int) -> dict:
        """Park a prefill's blocks in ``slot`` (in place)."""
        return kv_cache.insert_prefill(cache, kv, slot, length)

    def release(self, cache: dict, slot: int) -> dict:
        """Free a slot for the next request (in place)."""
        return kv_cache.release(cache, slot)

    def prefill_bucket(self, prompt_len: int) -> int:
        """Power-of-two padding bucket for a prompt."""
        if prompt_len > self.max_seq_len:
            raise ValueError(
                f"prompt of {prompt_len} tokens exceeds max_seq_len "
                f"{self.max_seq_len}")
        b = MIN_PREFILL_BUCKET
        while b < prompt_len:
            b *= 2
        return min(b, self.max_seq_len)

    # ---- model programs ---------------------------------------------------

    def _tokens(self, ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids, np.int32)).to(self.device)

    def _pack_kv(self, K: torch.Tensor, V: torch.Tensor) -> dict:
        """Prefill K/V blocks in the cache's storage form: quantized
        (int8 values and scales) or cast to the cache dtype."""
        if self.quantized:
            qk, ks = kv_cache.quantize_kv(K)
            qv, vs = kv_cache.quantize_kv(V)
            return {"k": qk, "v": qv, "k_scale": ks, "v_scale": vs}
        return {"k": K.to(self.cache_dtype), "v": V.to(self.cache_dtype)}

    @torch.no_grad()
    def prefill(self, params, prompt_ids) -> tuple:
        """One prompt through the full-sequence model. Returns (kv blocks
        in cache storage form, ``{"k", "v"[, "k_scale", "v_scale"]}:
        [L, 1, S_bucket, Hkv(, D)]``, last-token logits [1, V] fp32)."""
        ids = np.asarray(prompt_ids, np.int32).reshape(-1)
        if ids.size == 0:
            raise ValueError("empty prompt")
        S = self.prefill_bucket(ids.size)
        padded = np.zeros((1, S), np.int32)
        padded[0, : ids.size] = ids
        cfg = self.cfg
        cos, sin = self._cos[:S], self._sin[:S]
        h = llama.embed_lookup(params["embed"], self._tokens(padded)).to(
            self._dt)
        ks, vs = [], []
        for i in range(cfg.model.num_hidden_layers):
            h, (k, v) = llama.decoder_layer(llama.layer_params(params, i), h,
                                            cos, sin, cfg, return_kv=True)
            ks.append(k)
            vs.append(v)
        # only the last real token's logits are consumed: slice its hidden
        # row before the LM-head matmul
        h_last = h[:, ids.size - 1: ids.size]
        last = llama.head_logits(params, h_last, cfg)[:, 0].float()
        return self._pack_kv(torch.stack(ks), torch.stack(vs)), last

    def _layers_over_cache(self, params, cache, h, cos, sin, pos,
                           slots=slice(None)):
        """Run the layer stack on ``h`` against the cache rows of ``slots``,
        writing each layer's new K/V from ``pos`` on (an int8 cache's
        chunk is written first, then attended in its dequantized form, as
        in the JAX package)."""
        for i in range(self.cfg.model.num_hidden_layers):
            lc = {name: t[i, slots] for name, t in cache.items()
                  if name != "lengths"}
            h, _ = llama.decoder_layer(llama.layer_params(params, i), h, cos,
                                       sin, self.cfg, cache=lc, pos=pos)
        return h

    def _prefill_chunk(self, params, cache, tokens, slot: int, start: int,
                       valid: int) -> torch.Tensor:
        """One fixed-width chunk [1, C] (pad past ``valid``) written into
        rows [start, start + C) of ``slot``; its queries attend over the
        parked prefix plus the chunk. Sets ``lengths[slot] = start + valid``
        and returns the last valid token's logits [1, V] fp32."""
        C = tokens.shape[1]
        rows = (start + torch.arange(C, device=self.device))[None, :]
        cos, sin = rope_at_positions(self._cos, self._sin, rows)
        h = llama.embed_lookup(params["embed"], tokens).to(self._dt)
        pos = torch.full((1,), start, dtype=torch.int32, device=self.device)
        h = self._layers_over_cache(params, cache, h, cos, sin, pos,
                                    slots=slice(slot, slot + 1))
        idx = min(max(valid - 1, 0), C - 1)
        last = llama.head_logits(params, h[:, idx: idx + 1], self.cfg)
        cache["lengths"][slot] = start + valid
        return last[:, 0].float()

    @torch.no_grad()
    def prefill_chunked(self, params, cache, prompt_ids, slot: int,
                        start: int = 0) -> tuple:
        """Prefill one prompt as fixed-width chunks written straight into
        ``slot`` (in place). Returns (cache, last-token logits [1, V])."""
        ids = np.asarray(prompt_ids, np.int32).reshape(-1)
        if ids.size == 0:
            raise ValueError("empty prompt")
        if ids.size > self.max_seq_len:
            raise ValueError(
                f"prompt of {ids.size} tokens exceeds max_seq_len "
                f"{self.max_seq_len}")
        if not 0 <= start < ids.size:
            raise ValueError(
                f"chunked-prefill start {start} outside prompt of "
                f"{ids.size} tokens")
        C = self.prefill_chunk
        logits = None
        for s0 in range(start, ids.size, C):
            end = min(s0 + C, ids.size)
            # the write window is the chunk's full [w0, w0 + C) rows; near
            # the end of the window it slides back and re-feeds overlap
            # tokens, whose rows recompute to the values already parked
            w0 = min(s0, self.max_seq_len - C)
            chunk = ids[w0:end]
            padded = np.zeros((1, C), np.int32)
            padded[0, : chunk.size] = chunk
            logits = self._prefill_chunk(params, cache, self._tokens(padded),
                                         slot, w0, chunk.size)
        return cache, logits

    def _decode_core(self, params, cache, tokens) -> torch.Tensor:
        """One model step for all slots: ``tokens`` [B] at each slot's own
        ``cache['lengths']`` position -> logits [B, V] fp32. Writes the
        step's K/V but does not advance the lengths."""
        pos = cache["lengths"]
        cos, sin = rope_at_positions(self._cos, self._sin, pos[:, None])
        h = llama.embed_lookup(params["embed"], tokens[:, None]).to(self._dt)
        h = self._layers_over_cache(params, cache, h, cos, sin, pos)
        return llama.head_logits(params, h, self.cfg)[:, 0].float()

    @torch.no_grad()
    def decode_block(self, params, cache, tokens, generator, eos_id, budget,
                     temperature, top_k, top_p) -> tuple:
        """``decode_block_len`` tokens for every slot. ``tokens`` [slots]
        (each slot's current last token), ``eos_id`` [slots] (-1 = none),
        ``budget`` [slots] remaining tokens (0 for free slots) and the
        sampling parameters are host arrays; ``generator`` draws the
        sampled rows. A slot is active while it has a parked sequence and
        budget; hitting EOS zeroes its budget. Inactive slots emit 0 and
        stop advancing (their recomputed row writes land past the length
        mask). Returns (cache, tokens [slots, block], produced counts
        [slots]) as device tensors: ``counts[b]`` leading entries of row b
        are what slot b produced."""
        dev = self.device
        tok = self._tokens(tokens)
        eos = self._tokens(eos_id)
        budget = self._tokens(budget)
        stochastic = bool((np.asarray(temperature) > 0).any())
        temp = torch.as_tensor(np.asarray(temperature, np.float32)).to(dev)
        tk = self._tokens(top_k)
        tp = torch.as_tensor(np.asarray(top_p, np.float32)).to(dev)
        emitted, actives = [], []
        for _ in range(self.decode_block_len):
            pos = cache["lengths"]
            active = (pos > 0) & (budget > 0)
            logits = self._decode_core(params, cache, tok)
            if stochastic:
                sampled = sampling.sample(logits, generator, temp, tk, tp)
            else:  # every row greedy: the same tokens without the sort
                sampled = sampling.greedy(sampling.sanitize_logits(logits))
            emitted.append(torch.where(active, sampled, 0))
            actives.append(active)
            budget = torch.where(active, budget - 1, budget)
            hit_eos = active & (eos >= 0) & (sampled == eos)
            budget = torch.where(hit_eos, 0, budget)
            cache["lengths"] = torch.where(active, pos + 1, pos)
            tok = torch.where(active, sampled, tok)
        counts = torch.stack(actives, dim=1).sum(dim=1, dtype=torch.int32)
        return cache, torch.stack(emitted, dim=1), counts
