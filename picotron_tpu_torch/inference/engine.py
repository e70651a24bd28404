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

- ``prefill_paged(params, cache, prompt, slot)``: the paged layout's
  admission: share the longest radix-cached prefix of the prompt and
  prefill only the rest.
- ``decode_step(...)``: one round-keyed step for every slot, returning
  the step's logits (none on a ``sample_on_device`` engine).
- ``export_prefix`` / ``import_prefix`` / ``migrate_slot``: the paged
  layout's page transport (``page_transport.py``): a radix-cached prefix
  out as a payload of page bytes and into another engine's pool, and a
  parked slot's pages moved to another slot (``seat_slot`` parks an
  imported prompt as a slot's length with no dispatch).
- ``verify(...)``: the speculative draft-verify pass (``spec_len > 0``):
  each slot's last token and its ``spec_len`` drafts in one model pass
  over [slots, spec_len + 1] rows, the acceptance rule, EOS and budget,
  and the rewind of the lengths to what was emitted.
  ``make_draft_program`` is the learned drafter's pass over the target's
  last hidden state; with ``return_hidden`` every dispatch also returns
  that state, each slot's row before the final norm.

The cache has two layouts: ``kv_layout`` "contiguous" (a strip per slot,
``kv_cache.py``) or "paged" (a page pool behind block tables, with radix
prefix sharing and copy-on-write: ``paged_kv.py``, whose host allocator
``self.paged`` the engine consults before every write). Weights and cache
come in two storage forms each: ``weight_dtype``
"bf16" (the dense tree) or "int8" (the tree from
``llama.quantize_params``: every matmul site dispatches on its leaf, so
the engine only records the choice), and ``cache_dtype`` full precision
or int8 (``kv_cache.py``: quantized on write, one-shot prefill blocks
quantized by ``_pack_kv`` before ``insert``). The paged layout's
``kv_page_policy`` "hot_bf16" keeps both forms of every page and reads
each page as one or the other by its holder count.

With an adapter pack (``adapters=``, ``inference/tenancy.py``) every
dispatch binds its rows' adapter slots into the parameter tree
(``llama.bind_adapters``): the prefills take one id (``adapter_id``),
``decode_block`` one per slot (``adapter_ids``), and every projection
adds its rows' LoRA residuals through kernel H. An engine without a pack
binds nothing.

Sampled tokens are keyed by ``key_schedule``: "round" draws from the
caller's ``torch.Generator`` in round order; "slot" takes per-slot base
keys ``[slots, 2]`` and draws the token after row ``p`` of a slot with
``prng.fold_in(base, p)`` (``sampling.sample_rowkeys``; the verify's
acceptance is ``sampling.speculative_match``), so a stream is the same
whatever rounds made it, and the JAX package's token for token. With
``sample_on_device`` the prefill family takes ``sample=(key,
temperature, top_k, top_p)`` and returns the sampled token id in place of
the logits.

The overlap pipeline and the mixed prefill lane (``overlap``,
``mixed_dispatch``; both need the slot schedule, to which "auto" then
resolves): ``decode_block`` and ``verify`` take ``tokens`` as a tensor on
the device (the previous round's ``next_tok`` row, read without a host
sync) and ``lead`` (the rows the round in flight may still add to each
slot, which the paged ensure covers); with ``defer_advance`` set they
leave the paged host lengths to the caller's ``apply_advance`` once the
counts are read. A mixed engine's ``decode_block`` and ``verify`` take
``lanes`` (one prefill chunk for one slot, run after the decode steps or
the verify pass on the cache they just updated, inside the same call:
``_prefill_chunk``, the serial chunk's own computation) and append the
lane's outputs. On the card every host operand goes up through a fresh
pinned buffer by a non-blocking copy, so issuing a dispatch never waits
for the rounds in flight.

Dispatches are atomic for a retry: ``decode_step``, ``decode_block`` and
``verify`` restore what they advance (the cache lengths, the paged host
lengths, the generator's state) when they raise, so a second attempt
starts from what the first one saw; K/V rows a failed attempt wrote lie
past the restored lengths, masked. A restore that itself fails raises
``CacheLost``. ``hooks`` (``resilience.chaos.ServingChaos``, or any
object with ``before_dispatch(kind, active_slots)`` and
``poison_logits(kind)``) sees every dispatch first and may raise, sleep
or turn the dispatch's logits to NaN. ``obs`` is the engine's metrics
registry (``Obs.from_config(cfg.obs)``), which counts every dispatch by
kind and which the batcher and the serve front end share.

The JAX package compiles each of these as one jitted program with
``lax.scan`` over layers and steps; here they are Python loops that
launch kernels eagerly. There is no flash-to-dense fallback: a kernel
failure raises.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from picotron_tpu_torch.config import Config
from picotron_tpu_torch.inference import (
    kv_cache,
    page_transport,
    paged_kv,
    prng,
    sampling,
    tenancy,
)
from picotron_tpu_torch.models import llama
from picotron_tpu_torch.obs import Obs
from picotron_tpu_torch.ops.rope import precompute_rope, rope_at_positions
from picotron_tpu_torch.utils import resolve_device, torch_dtype

MIN_PREFILL_BUCKET = 16  # the smallest power-of-two prompt bucket


class CacheLost(RuntimeError):
    """A dispatch failed and the state it advances could not be restored:
    the cache's lengths no longer say which rows hold what, so every
    parked sequence is lost (the batcher empties the cache and serves on)."""


class InferenceEngine:
    """Fixed-slot generation engine on one device.

    ``slots`` is the decode batch width; ``max_seq_len`` bounds prompt +
    generated tokens per slot (default: ``max_position_embeddings``).
    ``decode_block_len`` / ``prefill_chunk`` / ``attend_impl`` /
    ``weight_dtype`` / ``spec_len`` / ``spec_ngram`` / ``drafter`` default
    from ``cfg.inference``; keyword overrides win. ``return_hidden``
    defaults to on for a speculative engine with the learned drafter.
    ``cache_dtype`` ("int8", ``torch.int8``, or a full-precision torch
    dtype) wins over ``inference.kv_cache_dtype`` when given, so a caller
    can turn cache quantization off as well as on. The KV layout and its
    pages (``kv_layout``, ``kv_page_len``, ``kv_num_pages``,
    ``prefix_cache``, ``kv_page_policy``) come from ``cfg.inference``
    alone, ``sample_on_device`` and ``key_schedule`` from it unless given.
    ``overlap`` and ``mixed_dispatch`` (``inference.overlap``,
    ``inference.mixed_dispatch`` unless given) set ``self.overlap`` and
    ``self.mixed``: the batcher's pipeline switch, and whether
    ``decode_block`` and ``verify`` carry the prefill lane.
    ``device=None`` is the CUDA card (and raises without one); pass
    ``device="cpu"`` for the plain PyTorch path on the CPU. ``adapters``
    (a ``tenancy.AdapterPack`` built for this model) makes it a
    multi-tenant engine; ``hooks`` see every dispatch (module docstring).
    """

    def __init__(self, cfg: Config, device=None, *, slots: int = 8,
                 max_seq_len: int | None = None,
                 decode_block_len: int | None = None,
                 prefill_chunk: int | None = None,
                 attend_impl: str | None = None,
                 weight_dtype: str | None = None,
                 cache_dtype=None, adapters=None,
                 spec_len: int | None = None,
                 spec_ngram: int | None = None,
                 drafter: str | None = None,
                 return_hidden: bool | None = None,
                 sample_on_device: bool | None = None,
                 key_schedule: str | None = None,
                 overlap: bool | None = None,
                 mixed_dispatch: bool | None = None, hooks=None):
        self.cfg = Config.from_dict(cfg.to_dict())  # own copy: overrides land here
        self.cfg.check_servable()
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
        self.spec_len = int(spec_len if spec_len is not None
                            else inf.spec_len)
        if self.spec_len < 0:
            raise ValueError("spec_len must be >= 0 (0 = off)")
        if self.spec_len >= self.max_seq_len:
            raise ValueError(
                f"spec_len {self.spec_len} leaves no room in a window of "
                f"{self.max_seq_len} rows (a verify writes spec_len + 1)")
        self.spec_ngram = int(spec_ngram if spec_ngram is not None
                              else inf.spec_ngram)
        if self.spec_ngram < 1:
            raise ValueError("spec_ngram must be >= 1")
        if drafter is not None:
            if drafter not in ("ngram", "learned"):
                raise ValueError(
                    f"unknown drafter {drafter!r} (ngram|learned)")
            inf.drafter = drafter
        self.drafter_kind = inf.drafter
        if return_hidden is None:
            return_hidden = (self.spec_len > 0
                             and self.drafter_kind == "learned")
        self.return_hidden = bool(return_hidden)
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
        if sample_on_device is not None:
            inf.sample_on_device = bool(sample_on_device)
        self.sample_on_device = inf.sample_on_device
        if overlap is not None:
            inf.overlap = bool(overlap)
        if mixed_dispatch is not None:
            inf.mixed_dispatch = bool(mixed_dispatch)
        if key_schedule is not None:
            inf.key_schedule = key_schedule
        self.overlap = bool(inf.overlap)
        self.mixed = bool(inf.mixed_dispatch)
        ks = inf.key_schedule
        if ks not in ("auto", "round", "slot"):
            raise ValueError(
                f"unknown key_schedule {ks!r} (auto|round|slot)")
        if ks == "auto":
            ks = "slot" if (self.overlap or self.mixed) else "round"
        elif ks == "round" and self.overlap:
            raise ValueError(
                "overlap requires the per-slot key schedule — round-keyed "
                "sampling ties streams to round boundaries; use "
                "key_schedule='slot' (or 'auto')")
        elif ks == "round" and self.mixed:
            raise ValueError(
                "mixed_dispatch requires the per-slot key schedule — "
                "round-keyed sampling ties streams to round boundaries, "
                "which fusing the prefill lane changes; use "
                "key_schedule='slot' (or 'auto')")
        self.key_schedule = ks
        # the overlap pipeline's sync stage advances the paged host
        # lengths (apply_advance) once it has read a round's counts; the
        # batcher sets this when it runs the pipeline
        self.defer_advance = False
        self.hooks = hooks
        # a fresh metrics registry per engine: the batcher and the serve
        # front end record into it, so one /metrics page covers the stack
        self.obs = Obs.from_config(self.cfg.obs)
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
        self._init_paged()
        self.adapters = adapters
        if adapters is not None:
            if adapters.dims != tenancy.adapter_dims(m):
                raise ValueError(
                    f"adapter pack built for dims {adapters.dims} but this "
                    f"model has {tenancy.adapter_dims(m)} — packs are "
                    f"model-shape specific")
            if adapters.rows != m.num_hidden_layers:
                raise ValueError(
                    f"adapter pack has {adapters.rows} layer rows; the "
                    f"serving stack holds {m.num_hidden_layers}")
        # angle tables cover the whole cache window; decode gathers rows at
        # each slot's own offset
        self._cos, self._sin = precompute_rope(
            self.max_seq_len, m.head_dim, m.rope_theta, self._dt,
            device=self.device)

    def _init_paged(self) -> None:
        """The KV layout, the page policy and, for "paged", the host
        allocator. ``Config.validate`` has checked the layout, the page
        length and the policy; only the ``cache_dtype`` override can still
        meet ``hot_bf16`` with an int8 cache."""
        inf = self.cfg.inference
        self.kv_layout = inf.kv_layout
        self.kv_page_policy = inf.kv_page_policy
        if self.kv_page_policy == "hot_bf16" and self.quantized:
            raise ValueError(
                "kv_page_policy 'hot_bf16' is mutually exclusive with "
                "an int8 cache (it manages its own quantized "
                "representation); drop cache_dtype/kv_cache_dtype "
                "'int8' or keep kv_page_policy='uniform'")
        self.page_policy = self.kv_page_policy == "hot_bf16"
        self.paged = None
        if self.kv_layout != "paged":
            return
        self.page_len = inf.kv_page_len
        # each slot's logical window, in pages (>= max_seq_len rows)
        self.max_pages = -(-self.max_seq_len // self.page_len)
        self.num_pages = (inf.kv_num_pages
                          or 1 + self.slots * self.max_pages)
        if self.num_pages < 2:
            raise ValueError("kv_num_pages must be >= 2 "
                             "(page 0 is the reserved NULL page)")
        self.paged = paged_kv.PagedKV(self.slots, self.page_len,
                                      self.max_pages, self.num_pages,
                                      prefix_cache=inf.prefix_cache)
        # the page transport's device ops (page_transport.py, migrate_slot)
        self._gather_pages = paged_kv.gather_pages
        self._write_pages = paged_kv.write_pages

    # ---- cache ------------------------------------------------------------

    def init_cache(self) -> dict:
        """A fresh zeroed cache on the engine's device. On the paged layout
        this also resets the host allocator (pool, radix cache, tables)."""
        dtype = None if self.quantized else self.cache_dtype
        if self.paged is not None:
            self.paged.reset()
            return paged_kv.init_cache(
                self.cfg.model, self.slots, self.num_pages, self.page_len,
                self.max_pages, dtype=dtype, device=self.device,
                quantized=self.quantized, policy=self.page_policy)
        return kv_cache.init_cache(
            self.cfg.model, self.slots, self.max_seq_len, dtype=dtype,
            device=self.device, quantized=self.quantized)

    def insert(self, cache: dict, kv: dict, slot: int, length: int) -> dict:
        """Park a prefill's blocks in ``slot`` (in place). Paged: allocate
        the slot's pages on the host first, then scatter through its
        table row."""
        if self.paged is not None:
            cache = self._ensure(cache, slot, 0, length)
            cache = self._sync_tables(cache)
            self.paged.set_len(slot, length)
            return paged_kv.insert_prefill(cache, kv, slot, length)
        return kv_cache.insert_prefill(cache, kv, slot, length)

    def release(self, cache: dict, slot: int) -> dict:
        """Free a slot for the next request (in place). Paged: drop its page
        references; pages the radix cache or other slots hold live on."""
        if self.paged is not None:
            self.paged.free_slot(slot)
            cache = self._sync_tables(cache)
        return kv_cache.release(cache, slot)

    def reset_cache(self, cache: dict) -> dict:
        """Empty every slot of ``cache`` in place: lengths to 0 and, on the
        paged layout, every page back to the pool (the radix cache
        cleared, the tables NULL). The batcher's path after a lost cache:
        the buffers stay allocated, and no row is reachable until it is
        written again."""
        if self.paged is not None:
            self.paged.radix.clear()
            for s in range(self.slots):
                self.paged.free_slot(s)
            cache = self._sync_tables(cache)
        cache["lengths"].zero_()
        return cache

    # ---- dispatch hooks, sampling in the dispatch, atomic dispatches -------

    def _hook(self, kind: str, budget=None) -> None:
        """Count the dispatch (``picotron_dispatch_total{kind}``) and fire
        the before-dispatch hook with the active slots (``budget > 0``
        rows; a dispatch without a budget reports none)."""
        self.obs.registry.counter(
            "picotron_dispatch_total",
            "engine dispatches by kind", kind=kind).inc()
        if self.hooks is None:
            return
        slots = ([] if budget is None
                 else np.flatnonzero(np.asarray(budget) > 0).tolist())
        self.hooks.before_dispatch(kind, slots)

    def _poison(self, kind: str) -> bool:
        """Whether this dispatch's logits come back NaN (chaos only)."""
        return self.hooks is not None and self.hooks.poison_logits(kind)

    @contextlib.contextmanager
    def _restoring(self, cache: dict, generator=None):
        """Undo what a dispatch advances if it raises: ``cache['lengths']``
        (the dispatches replace the tensor and never write into it, so the
        old one is the snapshot), the paged host lengths and
        ``generator``'s state. Pages the dispatch allocated or copied stay
        the slot's own, so a second attempt plans no copy twice."""
        lengths = cache["lengths"]
        host_len = (self.paged.host_len.copy() if self.paged is not None
                    else None)
        state = generator.get_state() if generator is not None else None
        try:
            yield
        except BaseException as e:
            try:
                cache["lengths"] = lengths
                if host_len is not None:
                    self.paged.host_len[:] = host_len
                if state is not None:
                    generator.set_state(state)
            except Exception as lost:
                raise CacheLost(
                    f"a {type(e).__name__} left the cache unrestorable "
                    f"({type(lost).__name__}: {lost})") from e
            raise

    def _sample_args(self, sample) -> tuple | None:
        """A prefill caller's ``sample=(key, temperature, top_k, top_p)``,
        checked against where this engine samples."""
        if not self.sample_on_device:
            if sample is not None:
                raise ValueError(
                    "this engine samples host-side (inference."
                    "sample_on_device: false); drop the sample argument "
                    "or build the engine with sample_on_device=True")
            return None
        if sample is None:
            raise ValueError(
                "this engine runs the on-device sampling epilogue "
                "(inference.sample_on_device: true); pass sample=(key, "
                "temperature, top_k, top_p) so the dispatch can draw the "
                "next token without shipping logits to the host")
        return sample

    def _epilogue(self, logits: torch.Tensor, sample) -> torch.Tensor:
        """Sampling in the dispatch: one row's token [1] int32 from its
        logits [1, V], with ``sample``'s key (a ``torch.Generator`` on the
        round schedule, a folded threefry key [2] on the slot schedule),
        as the batcher draws it from returned logits."""
        key, temperature, top_k, top_p = sample
        t = self._upload([temperature], np.float32)
        k = self._upload([top_k], np.int32)
        p = self._upload([top_p], np.float32)
        if isinstance(key, torch.Generator):
            return sampling.sample(logits, key, t, k, p)
        return sampling.sample_rowkeys(
            logits, self._key_rows(key)[None], t, k, p,
            greedy_only=float(temperature) <= 0)

    # ---- host to device, without waiting for the card ---------------------

    def _host_copy(self, dst: torch.Tensor, arr) -> torch.Tensor:
        """Copy host array ``arr`` into ``dst`` on the engine's device. On
        the card the bytes go through a fresh pinned buffer by a
        non-blocking copy, ordered on the stream behind every round
        already issued, so the host never waits for one; PyTorch's pinned
        allocator hands that buffer out again only once the copy that
        reads it has run, so the host may change ``arr`` at once."""
        src = torch.from_numpy(np.ascontiguousarray(arr))
        if dst.device.type == "cuda":
            src = src.pin_memory()
        return dst.copy_(src, non_blocking=True)

    def _upload(self, arr, dtype) -> torch.Tensor:
        """A host array as a new tensor on the engine's device (a copy,
        never a view of the host memory), without a sync."""
        arr = np.asarray(arr, dtype)
        out = torch.empty(arr.shape, device=self.device,
                          dtype=torch.from_numpy(np.empty(0, dtype)).dtype)
        return self._host_copy(out, arr)

    def _key_rows(self, keys) -> torch.Tensor:
        """Keys (uint32 words ``[..., 2]``: numpy, a list or a tensor) as
        the int64 tensor ``prng`` computes on, on the engine's device."""
        if isinstance(keys, torch.Tensor):
            if keys.device.type != "cpu" or self.device.type == "cpu":
                return keys.to(self.device, torch.int64)
            keys = keys.numpy()
        return self._upload(np.asarray(keys, np.uint32).astype(np.int64),
                            np.int64)

    # ---- paged-layout host plumbing ---------------------------------------

    def _sync_tables(self, cache: dict) -> dict:
        """Copy the host allocator's block tables to the device (and, under
        ``hot_bf16``, the per-page read flags from the live refcounts)."""
        self._host_copy(cache["block_tables"], self.paged.tables)
        if self.page_policy:
            self._host_copy(cache["page_quant"], self.paged.quant_flags())
        return cache

    def _ensure(self, cache: dict, slot: int, from_pos: int,
                to_pos: int) -> dict:
        """Make rows [from_pos, to_pos) of ``slot`` writable: allocate its
        growth pages and run the planned copy-on-writes as device page
        copies, so no write of the next dispatch lands in a page another
        holder has."""
        for src, dst in self.paged.ensure_writable(slot, from_pos, to_pos):
            cache = paged_kv.copy_page(cache, src, dst)
        return cache

    def _pre_write(self, cache: dict, nwrite: int, budget=None,
                   lead=None) -> dict:
        """Before a decode block: every parked slot (length > 0) writes up
        to ``nwrite`` rows from its length, inactive slots' hidden rows
        included, and none may land in a shared page. ``budget`` caps a
        slot's reach at ``budget[s] + 1`` rows (what it can emit, and the
        one row a stopped slot keeps rewriting), which is what admission
        priced. ``lead`` [slots] (the overlap pipeline) stretches each
        slot's reach by the rows the round in flight may still add: the
        host lengths are a round stale at issue, so the device's lie in
        ``[host_len, host_len + lead]``; rows already the slot's own stay
        so, and cost nothing. Ensures them all, then syncs the tables."""
        p = self.paged
        window = p.max_pages * p.page_len
        if budget is not None:
            budget = np.asarray(budget)
        if lead is not None:
            lead = np.asarray(lead)
        for s in np.flatnonzero(p.host_len > 0):
            n = nwrite if budget is None else min(nwrite, int(budget[s]) + 1)
            if lead is not None:
                n += int(lead[s])
            cache = self._ensure(cache, int(s), int(p.host_len[s]),
                                 min(int(p.host_len[s]) + n, window))
        return self._sync_tables(cache)

    def apply_advance(self, counts) -> None:
        """The paged host lengths' advance by a round's read-back (and
        late-finish-masked) counts, where ``defer_advance`` left it to the
        caller. Nothing on the contiguous layout, whose only lengths are
        the device's."""
        if self.paged is not None:
            self.paged.advance(np.asarray(counts, np.int64))

    def seat_slot(self, cache: dict, slot: int, length: int) -> dict:
        """Park a prefix the slot already holds by reference (a radix hit
        taken by ``paged.match_prefix``) as its length, with no dispatch:
        the host and device lengths and the synced tables."""
        if self.paged is None:
            raise ValueError("seat_slot needs kv_layout='paged'")
        self.paged.set_len(slot, length)
        return paged_kv.set_length(self._sync_tables(cache), slot, length)

    # ---- page transport (prefill/decode disaggregation) -------------------

    def transport_spec(self) -> dict:
        """The page-layout fingerprint a peer must match to exchange page
        bytes with this engine (``page_transport.transport_spec``)."""
        return page_transport.transport_spec(self)

    def export_prefix(self, cache: dict, ids, first_token=None,
                      cache_salt: str = "") -> dict:
        """The longest radix-cached prefix of ``ids`` as a transport
        payload (paged engines only); ``first_token`` rides along when the
        match covers the whole prompt. ``cache_salt`` (the tenant) keys
        the lookup and rides in the payload."""
        return page_transport.export_prefix(self, cache, ids,
                                            first_token=first_token,
                                            tenant=cache_salt)

    def import_prefix(self, cache: dict, payload) -> tuple:
        """Land a transport payload's pages in the pool and the radix cache
        (in place); returns (cache, info). Only locally missing chunks
        allocate, and a failure releases every page it allocated."""
        return page_transport.import_prefix(self, cache, payload)

    def _page_bytes(self) -> int:
        """Raw bytes one pool page holds across its storage leaves (the
        transport's ``bytes_total`` a page, and migrate_slot's unit)."""
        return sum(page_transport.leaf_bytes(leaf) for leaf in
                   self.transport_spec()["leaves"].values())

    def migrate_slot(self, cache: dict, src: int, dst: int, prompt_ids=None,
                     cache_salt: str = "") -> tuple:
        """Move a parked slot's pages from slot ``src`` into empty slot
        ``dst`` (in place) through the transport's gather and write, with
        the same bytes, then seat ``dst`` with ``src``'s length and
        pricing and release ``src``. The dp rebalance's primitive; at
        dp_size 1 a move within one pool. All or nothing: exhaustion (from
        the all-or-nothing allocation) or a fault before the write ends
        releases the fresh pages and leaves ``src`` as it was. Draft rows a
        verify wrote past the length are not moved (``host_len`` holds
        accepted tokens only). ``prompt_ids`` (with ``cache_salt``)
        re-registers the prompt under ``dst``. Returns (cache, bytes
        moved)."""
        if self.paged is None:
            raise ValueError("migrate_slot needs kv_layout='paged'")
        p = self.paged
        if not (0 <= src < self.slots and 0 <= dst < self.slots):
            raise ValueError(
                f"migrate_slot: slots out of range: {src} -> {dst} "
                f"(engine has {self.slots})")
        if src == dst:
            return cache, 0
        n_tok = int(p.host_len[src])
        if n_tok <= 0:
            raise ValueError(f"migrate_slot: source slot {src} is empty")
        if int(p.host_len[dst]) > 0:
            raise ValueError(
                f"migrate_slot: destination slot {dst} is occupied")
        npages = p.pages_for(n_tok)
        src_pids = [int(q) for q in p.tables[src, :npages]]
        new_pids = p.alloc_import(npages)
        try:
            pages = self._gather_pages(cache, self._upload(src_pids,
                                                           np.int64))
            cache = self._write_pages(cache, pages,
                                      self._upload(new_pids, np.int64))
        except BaseException:
            # the fresh pages' only holder is this move
            p.release_pages(new_pids)
            raise
        # the destination's row takes the fresh pages (already held for
        # it), then the source's references drop; shared source pages live
        # on under their other holders
        p.tables[dst, :npages] = new_pids
        p.priced[dst] = p.priced[src]
        p.set_len(dst, n_tok)
        p.free_slot(src)
        if prompt_ids is not None:
            p.register_prompt(dst, [int(t) for t in prompt_ids],
                              salt=cache_salt)
        cache = paged_kv.set_length(self._sync_tables(cache), dst, n_tok)
        cache = kv_cache.release(cache, src)
        return cache, npages * self._page_bytes()

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

    # ---- multi-tenant adapters (inference/tenancy.py) ----------------------

    def bind_adapter_ids(self, params, adapter_ids, n: int):
        """Wrap ``params`` with the adapter pack and this dispatch's
        per-row adapter slots (``adapter_ids``: [n] host ints, or None for
        all null). The ids are checked on the host and uploaded once; the
        kernel reads them on the device. On an engine without a pack this
        is the identity, and passing ids is an error (the caller thinks
        tenants exist)."""
        if self.adapters is None:
            if adapter_ids is not None:
                raise ValueError(
                    "engine has no adapter pack (construct with "
                    "adapters=tenancy.AdapterPack) but adapter ids were "
                    "passed")
            return params
        if adapter_ids is None:
            ids = np.zeros(n, np.int32)
        else:
            ids = np.asarray(adapter_ids, np.int32).reshape(-1)
            if ids.shape[0] != n:
                raise ValueError(
                    f"adapter_ids has {ids.shape[0]} rows; this dispatch "
                    f"carries {n}")
            if (ids < 0).any() or (ids >= self.adapters.slots).any():
                raise ValueError(
                    f"adapter slot ids must be in [0, "
                    f"{self.adapters.slots}); got {ids.tolist()}")
        return llama.bind_adapters(
            params, self.adapters.device_leaves(self.device),
            self._upload(ids, np.int32))

    def _bind_one(self, params, adapter_id):
        """A one-row dispatch's binding (the prefills)."""
        if self.adapters is None and adapter_id is None:
            return params
        return self.bind_adapter_ids(
            params, None if adapter_id is None else [adapter_id], 1)

    # ---- model programs ---------------------------------------------------

    def _tokens(self, ids) -> torch.Tensor:
        """Token ids as int32 on the device: a host array goes up without
        a sync, a tensor already there stays there."""
        if isinstance(ids, torch.Tensor):
            return ids.to(self.device, torch.int32)
        return self._upload(ids, np.int32)

    def _pack_kv(self, K: torch.Tensor, V: torch.Tensor) -> dict:
        """Prefill K/V blocks in the cache's storage form: quantized
        (int8 values and scales) or cast to the cache dtype; a ``hot_bf16``
        engine packs both forms, which the paged insert parks side by
        side."""
        if self.quantized:
            qk, ks = kv_cache.quantize_kv(K)
            qv, vs = kv_cache.quantize_kv(V)
            return {"k": qk, "v": qv, "k_scale": ks, "v_scale": vs}
        out = {"k": K.to(self.cache_dtype), "v": V.to(self.cache_dtype)}
        if self.page_policy:
            qk, ks = kv_cache.quantize_kv(K)
            qv, vs = kv_cache.quantize_kv(V)
            out.update({"k_q": qk, "v_q": qv, "k_scale": ks, "v_scale": vs})
        return out

    @torch.no_grad()
    def prefill(self, params, prompt_ids, adapter_id=None,
                sample=None) -> tuple:
        """One prompt through the full-sequence model, under adapter slot
        ``adapter_id`` on an engine with a pack. Returns (kv blocks in
        cache storage form, ``{"k", "v"[, "k_scale", "v_scale"]}: [L, 1,
        S_bucket, Hkv(, D)]``, last-token logits [1, V] fp32); a
        ``sample_on_device`` engine takes ``sample=(key, temperature,
        top_k, top_p)`` and returns the sampled token [1] int32 in the
        logits' place. A ``return_hidden`` engine appends the last token's
        hidden state before the final norm [1, H]."""
        sample = self._sample_args(sample)
        self._hook("prefill")
        params = self._bind_one(params, adapter_id)
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
        if sample is not None:
            last = self._epilogue(last, sample)
        out = (self._pack_kv(torch.stack(ks), torch.stack(vs)), last)
        return out + (h_last[:, 0],) if self.return_hidden else out

    def _layers_over_cache(self, params, cache, h, cos, sin, pos,
                           slots=slice(None), draft_valid=None):
        """Run the layer stack on ``h`` against the cache rows of ``slots``,
        writing each layer's new K/V from ``pos`` on (an int8 cache's
        chunk is written first, then attended in its dequantized form, as
        in the JAX package). A pool has no slot axis: a paged layer cache
        is each layer's whole pool with the block-table rows of ``slots``
        (and the ``hot_bf16`` flags, which have no layer axis).
        ``draft_valid`` [B] (the ragged verify's write mask) rides into
        every layer's dict."""
        paged = self.paged is not None
        for i in range(self.cfg.model.num_hidden_layers):
            if paged:
                lc = {name: t[i] for name, t in cache.items()
                      if name not in paged_kv.META_LEAVES}
                lc["block_tables"] = cache["block_tables"][slots]
                if self.page_policy:
                    lc["page_quant"] = cache["page_quant"]
            else:
                lc = {name: t[i, slots] for name, t in cache.items()
                      if name != "lengths"}
            if draft_valid is not None:
                lc["draft_valid"] = draft_valid
            h, _ = llama.decoder_layer(llama.layer_params(params, i), h, cos,
                                       sin, self.cfg, cache=lc, pos=pos)
        return h

    def _prefill_chunk(self, params, cache, tokens, slot: int, start: int,
                       valid: int) -> torch.Tensor:
        """One fixed-width chunk [1, C] (pad past ``valid``) written into
        rows [start, start + C) of ``slot``; its queries attend over the
        parked prefix plus the chunk. Sets ``lengths[slot] = start + valid``
        and returns (the last valid token's logits [1, V] fp32, its hidden
        state before the final norm [1, H])."""
        C = tokens.shape[1]
        rows = (start + torch.arange(C, device=self.device))[None, :]
        cos, sin = rope_at_positions(self._cos, self._sin, rows)
        h = llama.embed_lookup(params["embed"], tokens).to(self._dt)
        pos = torch.full((1,), start, dtype=torch.int32, device=self.device)
        h = self._layers_over_cache(params, cache, h, cos, sin, pos,
                                    slots=slice(slot, slot + 1))
        idx = min(max(valid - 1, 0), C - 1)
        last = llama.head_logits(params, h[:, idx: idx + 1], self.cfg)
        # a new lengths tensor, never a write into the old one: the
        # dispatches' restore (_restoring) keeps the old one as its
        # snapshot. fill_, not an index assignment: a Python value
        # assigned into a CUDA tensor goes up by a copy that waits for the
        # card
        lengths = cache["lengths"].clone()
        lengths[slot: slot + 1].fill_(start + valid)
        cache["lengths"] = lengths
        return last[:, 0].float(), h[:, idx]

    @torch.no_grad()
    def prefill_chunked(self, params, cache, prompt_ids, slot: int,
                        start: int = 0, adapter_id=None,
                        sample=None) -> tuple:
        """Prefill one prompt as fixed-width chunks written straight into
        ``slot`` (in place), under adapter slot ``adapter_id``. Returns
        (cache, last-token logits [1, V]), or on a ``sample_on_device``
        engine (cache, the token drawn from them with ``sample`` [1]); a
        ``return_hidden`` engine appends the last chunk's last-token
        hidden state [1, H]."""
        sample = self._sample_args(sample)
        params = self._bind_one(params, adapter_id)
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
        logits = hidden = None
        for s0 in range(start, ids.size, C):
            end = min(s0 + C, ids.size)
            if self.paged is None:
                # the write window is the chunk's full [w0, w0 + C) rows;
                # near the end of the window it slides back and re-feeds
                # overlap tokens, whose rows recompute to the values
                # already parked
                w0 = min(s0, self.max_seq_len - C)
            else:
                # pages have no end to slide from (rows past the window go
                # to the NULL page), and a slid chunk would re-feed, and
                # copy for nothing, a shared prefix it exists to skip
                w0 = s0
                # allocate or copy every page holding a real chunk row;
                # pad rows reach unallocated entries and the NULL page
                cache = self._ensure(cache, slot, w0, end)
                cache = self._sync_tables(cache)
            chunk = ids[w0:end]
            padded = np.zeros((1, C), np.int32)
            padded[0, : chunk.size] = chunk
            self._hook("prefill_chunk")
            logits, hidden = self._prefill_chunk(
                params, cache, self._tokens(padded), slot, w0, chunk.size)
            if self.paged is not None:
                self.paged.set_len(slot, end)
        if sample is not None:  # only the last chunk's draw is consumed
            logits = self._epilogue(logits, sample)
        return (cache, logits, hidden) if self.return_hidden \
            else (cache, logits)

    @torch.no_grad()
    def prefill_paged(self, params, cache, prompt_ids, slot: int,
                      adapter_id=None, cache_salt: str = "",
                      sample=None) -> tuple:
        """Paged admission of one prompt into ``slot`` (in place): share the
        longest radix-cached prefix (references only, no prefill for those
        tokens) and prefill the rest as chunks that attend over the shared
        pages. A miss takes the contiguous path's dispatches (the one-shot
        prefill at or under ``prefill_chunk``, chunks above it). Then the
        prompt's pages are registered for the next request. The prefix
        cache is searched and filled in ``cache_salt``'s domain (the
        tenant: an adapter changes every row a page holds), and the
        prefill runs under ``adapter_id``. Returns (cache, last-token
        logits [1, V], dispatches, cached tokens), the sampled token [1]
        in the logits' place on a ``sample_on_device`` engine (which takes
        ``sample``); a ``return_hidden`` engine appends the prompt's last
        hidden state [1, H]."""
        if self.paged is None:
            raise ValueError("prefill_paged needs kv_layout='paged'")
        self._sample_args(sample)
        ids = [int(t) for t in np.asarray(prompt_ids, np.int32).reshape(-1)]
        if not ids:
            raise ValueError("empty prompt")
        cached = self.paged.match_prefix(slot, ids, salt=cache_salt)
        if cached > 0:
            cache = self.seat_slot(cache, slot, cached)
            out = self.prefill_chunked(params, cache, ids, slot,
                                       start=cached, adapter_id=adapter_id,
                                       sample=sample)
            cache = out[0]
            n = -(-(len(ids) - cached) // self.prefill_chunk)
        elif len(ids) <= self.prefill_chunk:
            out = self.prefill(params, ids, adapter_id=adapter_id,
                               sample=sample)
            cache = self.insert(cache, out[0], slot, len(ids))
            n = 1
        else:
            out = self.prefill_chunked(params, cache, ids, slot,
                                       adapter_id=adapter_id, sample=sample)
            cache = out[0]
            n = -(-len(ids) // self.prefill_chunk)
        self.paged.register_prompt(slot, ids, salt=cache_salt)
        return (cache, out[1], n, cached) + tuple(out[2:])

    def _model_block(self, params, cache, tokens, draft_valid=None
                     ) -> tuple:
        """The incremental model body: ``tokens`` [B, S] at rows
        ``cache['lengths'] + 0..S-1`` of each slot, their K/V written
        there, attending causally over the cache prefix and the block ->
        (logits [B, S, V] fp32, hidden states before the final norm
        [B, S, H]). S == 1 is a decode step, S > 1 the verify block.
        Does not advance the lengths."""
        pos = cache["lengths"]
        rows = pos[:, None] + torch.arange(tokens.shape[1],
                                           device=pos.device)[None, :]
        cos, sin = rope_at_positions(self._cos, self._sin, rows)
        h = llama.embed_lookup(params["embed"], tokens).to(self._dt)
        h = self._layers_over_cache(params, cache, h, cos, sin, pos,
                                    draft_valid=draft_valid)
        return llama.head_logits(params, h, self.cfg).float(), h

    def _decode_core(self, params, cache, tokens) -> tuple:
        """One model step for all slots: ``tokens`` [B] at each slot's own
        ``cache['lengths']`` position -> (logits [B, V] fp32, hidden
        [B, H]). Writes the step's K/V but does not advance the
        lengths."""
        logits, h = self._model_block(params, cache, tokens[:, None])
        return logits[:, 0], h[:, 0]

    def _sampling_args(self, temperature, top_k, top_p) -> tuple:
        """The per-slot sampling parameters on the device, and whether any
        row samples (read from the host arrays: no device sync)."""
        stochastic = bool((np.asarray(temperature) > 0).any())
        return (stochastic, self._upload(temperature, np.float32),
                self._upload(top_k, np.int32),
                self._upload(top_p, np.float32))

    def _keys(self, keys, kind: str):
        """A dispatch's key operand: the round schedule's
        ``torch.Generator``, or the slot schedule's per-slot base keys
        [slots, 2] on the device."""
        if self.key_schedule == "slot":
            base = self._key_rows(keys)
            if tuple(base.shape) != (self.slots, 2):
                raise ValueError(
                    f"key_schedule='slot' takes per-slot base keys "
                    f"[slots, 2] = [{self.slots}, 2]; got "
                    f"{tuple(base.shape)}")
            return base
        if not isinstance(keys, torch.Generator):
            raise ValueError(
                f"a key_schedule='round' engine's {kind} draws from a "
                f"torch.Generator; got {type(keys).__name__}")
        return keys

    @torch.no_grad()
    def decode_step(self, params, cache, tokens, generator, temperature,
                    top_k, top_p, adapter_ids=None) -> tuple:
        """One token for every slot, round-keyed. ``tokens`` and the
        sampling parameters are [slots] host arrays; ``generator`` draws
        the sampled rows. Every parked slot (length > 0) advances one row;
        free slots stay at length 0. Returns (cache, next_tokens [slots]
        int32, logits [slots, V] fp32) as device tensors; on a
        ``sample_on_device`` engine the logits' place holds None (only the
        token ids are the caller's to read). A ``return_hidden`` engine
        appends hidden [slots, H]."""
        if self.key_schedule == "slot":
            raise ValueError(
                "decode_step is round-keyed (one shared key per step) and "
                "a key_schedule='slot' engine samples with per-slot "
                "position-folded keys — use decode_block, whose slot "
                "variant owns the schedule")
        self._hook("decode")
        if self.adapters is not None or adapter_ids is not None:
            params = self.bind_adapter_ids(params, adapter_ids, self.slots)
        if self.paged is not None:
            cache = self._pre_write(cache, 1)
        tok = self._tokens(tokens)
        stochastic, temp, tk, tp = self._sampling_args(temperature, top_k,
                                                       top_p)
        with self._restoring(cache, generator):
            pos = cache["lengths"]
            logits, h = self._decode_core(params, cache, tok)
            if stochastic:
                nxt = sampling.sample(logits, generator, temp, tk, tp)
            else:
                nxt = sampling.greedy(sampling.sanitize_logits(logits))
            cache["lengths"] = torch.where(pos > 0, pos + 1, pos)
            if self.paged is not None:
                self.paged.advance((self.paged.host_len > 0).astype(np.int64))
        out = (cache, nxt, None if self.sample_on_device else logits)
        return out + (h,) if self.return_hidden else out

    # ---- the mixed prefill lane -------------------------------------------

    def _lane_args(self, lanes):
        """The one active lane of ``lanes`` (None: every lane idle), checked:
        a list of one entry per dp shard (the port serves one), each None
        or a dict with ``slot``, ``tokens`` (the chunk's 1 to
        ``prefill_chunk`` real token ids) and ``start`` (its first write
        row, by ``prefill_chunked``'s convention: slid back near the
        window's end on the contiguous layout, absolute on the paged one);
        on a ``sample_on_device`` engine ``key`` (the fold at the prompt's
        last row), ``temperature``, ``top_k`` and ``top_p``, and
        ``adapter`` on an engine with a pack."""
        if lanes is None:
            return None
        if not self.mixed:
            raise ValueError(
                "lanes requires a mixed_dispatch engine (construct with "
                "mixed_dispatch=True or set inference.mixed_dispatch)")
        if len(lanes) != 1:
            raise ValueError(
                f"lanes carries {len(lanes)} entries; this engine "
                f"serves one lane per dp shard (1)")
        ln = lanes[0]
        if ln is None:
            return None
        g = int(ln["slot"])
        if not 0 <= g < self.slots:
            raise ValueError(
                f"lane slot {g} does not live on dp shard 0 (slots [0, "
                f"{self.slots}))")
        chunk = np.asarray(ln["tokens"], np.int32).reshape(-1)
        C = self.prefill_chunk
        if not 0 < chunk.size <= C:
            raise ValueError(
                f"lane chunk must carry 1..prefill_chunk ({C}) real "
                f"tokens; got {chunk.size}")
        padded = np.zeros((1, C), np.int32)
        padded[0, : chunk.size] = chunk
        sample = None
        if self.sample_on_device:
            sample = (ln["key"], float(ln.get("temperature", 1.0)),
                      int(ln.get("top_k", 0)), float(ln.get("top_p", 1.0)))
        adapter = (int(ln.get("adapter") or 0) if self.adapters is not None
                   else None)
        return dict(slot=g, tokens=padded, valid=int(chunk.size),
                    start=int(ln["start"]), sample=sample, adapter=adapter)

    def _lane_ensure(self, cache: dict, lane) -> dict:
        """Paged: make the lane chunk's real rows its slot's own before the
        dispatch (the caller's ``_pre_write`` then syncs the tables); its
        pad rows reach unallocated entries and the NULL page, as a serial
        chunk's do."""
        if self.paged is None or lane is None:
            return cache
        s0 = lane["start"]
        return self._ensure(cache, lane["slot"], s0, s0 + lane["valid"])

    def _lane_run(self, params, cache: dict, lane) -> tuple:
        """The lane's chunk on the cache the same call's decode steps or
        verify pass just updated: ``_prefill_chunk`` for its slot, under
        its own adapter row, then the sampled token on a
        ``sample_on_device`` engine. Returns the lane outputs: (the last
        valid token's logits [1, V] fp32, or its sampled token [1] int32
        [, its hidden state before the final norm [1, H]]). An idle lane
        launches nothing, and each of its outputs is None."""
        n = 2 if self.return_hidden else 1
        if lane is None:
            return (None,) * n
        params = self._bind_one(params, lane["adapter"])
        logits, hidden = self._prefill_chunk(
            params, cache, self._tokens(lane["tokens"]), lane["slot"],
            lane["start"], lane["valid"])
        out = (logits if lane["sample"] is None
               else self._epilogue(logits, lane["sample"]))
        return (out, hidden)[:n]

    @torch.no_grad()
    def decode_block(self, params, cache, tokens, keys, eos_id, budget,
                     temperature, top_k, top_p, adapter_ids=None,
                     lead=None, lanes=None) -> tuple:
        """``decode_block_len`` tokens for every slot. ``tokens`` [slots]
        (each slot's current last token: a host array, or a tensor on the
        device, which is used where it lies), ``eos_id`` [slots] (-1 =
        none), ``budget`` [slots] remaining tokens (0 for free slots) and
        the sampling parameters are host arrays. ``keys`` draws the sampled
        rows: the round schedule's ``torch.Generator``, or on a
        ``key_schedule='slot'`` engine the per-slot base keys [slots, 2],
        the row after position ``p`` of slot ``b`` drawn with
        ``fold_in(keys[b], p)``. A slot is active while it has a parked
        sequence and budget; hitting EOS zeroes its budget. Inactive slots
        emit 0 and stop advancing (their recomputed row writes land past
        the length mask). Returns (cache, tokens [slots, block], produced
        counts [slots]) as device tensors: ``counts[b]`` leading entries of
        row b are what slot b produced; a slot-keyed engine appends
        next_tok [slots] (each slot's last token after the block, its
        input token where it made no step). Paged: every page the block
        can write is made the writer's own first (``lead``: see
        ``_pre_write``), and the host lengths follow the counts after,
        unless ``defer_advance`` leaves that to ``apply_advance``.
        ``adapter_ids`` [slots] are the slots' adapter slots on an engine
        with a pack (None: all null). A ``return_hidden`` engine appends
        hidden [slots, H]: each slot's state before the final norm at its
        last active step (zeros for a slot that made no step), what
        produced its last emitted token. A ``mixed_dispatch`` engine runs
        ``lanes``' chunk after the steps (``_lane_args``) and appends the
        lane outputs (``_lane_run``: None where the lane is idle)."""
        lane = self._lane_args(lanes)
        keys = self._keys(keys, "decode_block")
        slot_keys = self.key_schedule == "slot"
        self._hook("decode", budget)
        dev = self.device
        base = params
        if self.adapters is not None or adapter_ids is not None:
            params = self.bind_adapter_ids(params, adapter_ids, self.slots)
        poison = self._poison("decode")
        if self.paged is not None:
            cache = self._lane_ensure(cache, lane)
            cache = self._pre_write(cache, self.decode_block_len,
                                    budget=budget, lead=lead)
        tok = self._tokens(tokens)
        eos = self._tokens(eos_id)
        budget = self._tokens(budget)
        stochastic, temp, tk, tp = self._sampling_args(temperature, top_k,
                                                       top_p)
        emitted, actives = [], []
        hid = (torch.zeros((self.slots, self.cfg.model.hidden_size),
                           dtype=self._dt, device=dev)
               if self.return_hidden else None)
        with self._restoring(cache, None if slot_keys else keys):
            for _ in range(self.decode_block_len):
                pos = cache["lengths"]
                active = (pos > 0) & (budget > 0)
                logits, h = self._decode_core(params, cache, tok)
                if poison:
                    logits = torch.full_like(logits, float("nan"))
                if hid is not None:
                    hid = torch.where(active[:, None], h, hid)
                if not stochastic:  # every row greedy: no sort, no draw
                    sampled = sampling.greedy(
                        sampling.sanitize_logits(logits))
                elif slot_keys:
                    sampled = sampling.sample_rowkeys(
                        logits, prng.fold_in(keys, pos), temp, tk, tp,
                        greedy_only=False)
                else:
                    sampled = sampling.sample(logits, keys, temp, tk, tp)
                emitted.append(torch.where(active, sampled, 0))
                actives.append(active)
                budget = torch.where(active, budget - 1, budget)
                hit_eos = active & (eos >= 0) & (sampled == eos)
                budget = torch.where(hit_eos, 0, budget)
                cache["lengths"] = torch.where(active, pos + 1, pos)
                tok = torch.where(active, sampled, tok)
            counts = torch.stack(actives, dim=1).sum(dim=1,
                                                     dtype=torch.int32)
            lane_out = (self._lane_run(base, cache, lane) if self.mixed
                        else ())
            if self.paged is not None and not self.defer_advance:
                self.paged.advance(counts.cpu().numpy())
        out = (cache, torch.stack(emitted, dim=1), counts)
        if slot_keys:
            out += (tok,)
        if hid is not None:
            out += (hid,)
        return out + lane_out

    @torch.no_grad()
    def verify(self, params, cache, tokens, keys, eos_id, budget,
               temperature, top_k, top_p, draft_len=None,
               adapter_ids=None, lead=None, lanes=None) -> tuple:
        """One draft-verify dispatch for every slot (``spec_len > 0``
        engines). ``tokens`` [slots, spec_len + 1]: column 0 each slot's
        current last token, then its drafts (a host array, or on a
        slot-keyed engine a tensor on the device). ``draft_len`` [slots]
        (None: ``spec_len`` everywhere) makes the verify ragged: slot
        ``b`` drafted ``draft_len[b]`` real tokens, and its pad columns are
        neither accepted nor written. The other arguments, ``lead``,
        ``lanes`` and ``defer_advance`` are ``decode_block``'s.

        One model pass runs the S = spec_len + 1 tokens at rows
        ``lengths + 0..S-1`` of each slot, writing their K/V (the real
        ones, inside the window) and attending causally over the cache
        prefix and the block. The round schedule's
        ``sampling.speculative_accept`` keeps the accepted drafts and
        draws one fresh token; the slot schedule's
        ``sampling.speculative_match`` draws the chain's own token at
        every row with that row's folded key and keeps the drafts that
        match it. The budget and the first emitted EOS cut the run. The
        lengths advance by the emitted counts only: rejected rows sit past
        them, unreachable, and the next dispatch overwrites them. Free
        slots (length 0) and slots without budget emit nothing. Paged:
        every parked slot's S rows are made its own pages first, and the
        host lengths follow the counts after.

        Returns (cache, emitted [slots, S], counts [slots], accepted
        [slots]) as device tensors: the leading ``counts[b]`` entries of
        row b are what slot b emitted, ``accepted[b]`` of them drafts. A
        slot-keyed engine appends next_tok [slots] (the last emitted
        token, the fed last token where a row emitted none); a
        ``return_hidden`` engine appends hidden [slots, H], each slot's
        state before the final norm at row ``counts - 1``; a
        ``mixed_dispatch`` engine appends the lane outputs."""
        if self.spec_len < 1:
            raise ValueError(
                "speculative decoding is off for this engine (spec_len == "
                "0); construct it with spec_len > 0 or set "
                "inference.spec_len")
        lane = self._lane_args(lanes)
        if not isinstance(tokens, torch.Tensor):
            tokens = np.asarray(tokens, np.int32)
        S = self.spec_len + 1
        if tuple(tokens.shape) != (self.slots, S):
            raise ValueError(
                f"verify tokens must be [slots, spec_len + 1] = "
                f"[{self.slots}, {S}]; got {tuple(tokens.shape)}")
        if draft_len is None:
            valid = np.full(self.slots, S, np.int32)
        else:
            draft_len = np.asarray(draft_len, np.int32)
            if draft_len.shape != (self.slots,):
                raise ValueError(
                    f"draft_len must be [slots] = [{self.slots}]; got "
                    f"{draft_len.shape}")
            if np.any(draft_len < 0) or np.any(draft_len > self.spec_len):
                raise ValueError(
                    f"draft_len entries must be in [0, spec_len = "
                    f"{self.spec_len}]; got {draft_len.tolist()}")
            valid = draft_len + 1
        keys = self._keys(keys, "verify")
        slot_keys = self.key_schedule == "slot"
        self._hook("verify", budget)
        base = params
        if self.adapters is not None or adapter_ids is not None:
            params = self.bind_adapter_ids(params, adapter_ids, self.slots)
        poison = self._poison("verify")
        if self.paged is not None:
            cache = self._lane_ensure(cache, lane)
            cache = self._pre_write(cache, S, lead=lead)
        dev = self.device
        tok = self._tokens(tokens)
        valid_t = self._tokens(valid)
        eos = self._tokens(eos_id)
        budget = self._tokens(budget)
        stochastic, temp, tk, tp = self._sampling_args(temperature, top_k,
                                                       top_p)
        with self._restoring(cache, None if slot_keys else keys):
            pos0 = cache["lengths"]
            logits, h = self._model_block(params, cache, tok,
                                          draft_valid=valid_t)
            if poison:
                logits = torch.full_like(logits, float("nan"))
            if slot_keys:
                rows = pos0[:, None] + torch.arange(S, device=dev)[None, :]
                emitted, counts = sampling.speculative_match(
                    logits, tok[:, 1:], keys, rows, temp, tk, tp,
                    draft_len=valid_t - 1, greedy_only=not stochastic)
            else:
                emitted, counts = sampling.speculative_accept(
                    logits, tok[:, 1:], keys, temp, tk, tp,
                    draft_len=valid_t - 1, greedy_only=not stochastic)
            raw = counts  # accepted drafts + 1 fresh token, before any cut
            active = (pos0 > 0) & (budget > 0)
            counts = torch.where(active, torch.minimum(counts, budget), 0)
            cols = torch.arange(S, device=dev)[None, :]
            is_eos = ((eos >= 0)[:, None] & (emitted == eos[:, None])
                      & (cols < counts[:, None]))
            first_eos = torch.argmax(is_eos.to(torch.int32), dim=1) + 1
            counts = torch.where(is_eos.any(dim=1),
                                 first_eos.to(torch.int32), counts)
            emitted = torch.where(cols < counts[:, None], emitted, 0)
            # all but (possibly) the last emitted token are drafts: with no
            # cut, raw - 1 drafts and the fresh token; cut below that, all
            # drafts
            accepted = torch.minimum(raw - 1, counts)
            cache["lengths"] = torch.where(active, pos0 + counts, pos0)
            lane_out = (self._lane_run(base, cache, lane) if self.mixed
                        else ())
            if self.paged is not None and not self.defer_advance:
                self.paged.advance(counts.cpu().numpy())
        out = (cache, emitted, counts, accepted)
        idx = (counts.long() - 1).clamp(0, S - 1)
        if slot_keys:
            last = emitted.gather(1, idx[:, None])[:, 0]
            out += (torch.where(counts > 0, last, tok[:, 0]),)
        if self.return_hidden:
            out += (h[torch.arange(self.slots, device=dev), idx],)
        return out + lane_out

    def make_draft_program(self, with_head: bool = False):
        """The learned drafter's pass (EAGLE-style, Li et al. 2024): a
        function ``(params[, head], hidden [B, H], tokens [B]) -> drafts
        [B, spec_len]`` int32 that runs ``spec_len`` greedy steps. Each
        step folds the current token's embedding into the running state
        (``hidden + embed(tok)``, or ``tanh(cat(embed, hidden) @
        head["w"])`` with a head), takes the target's final norm and LM
        head over it and the argmax. No cache is read or written; the
        caller passes the base tree (an adapter shapes the verify's
        logits, never the draft's)."""
        if self.spec_len < 1:
            raise ValueError(
                "make_draft_program needs a speculative engine "
                "(spec_len > 0)")
        G, cfg = self.spec_len, self.cfg

        @torch.no_grad()
        def program(params, *args):
            head, hidden, tok = args if with_head else (None, *args)
            h, tok = hidden, tok.to(torch.int32)
            out = []
            for _ in range(G):
                e = llama.embed_lookup(params["embed"], tok).to(h.dtype)
                if head is not None:
                    h = torch.tanh(torch.cat([e, h], dim=-1)
                                   @ head["w"].to(h.dtype))
                else:
                    h = h + e
                logits = llama.head_logits(params, h[:, None, :], cfg)[:, 0]
                tok = logits.argmax(dim=-1).to(torch.int32)
                out.append(tok)
            return torch.stack(out, dim=1)

        return program
