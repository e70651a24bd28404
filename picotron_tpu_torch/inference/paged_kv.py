"""Paged KV cache: a global page pool with refcounted prefix sharing and
copy-on-write.

Port of ``picotron_tpu/inference/paged_kv.py`` for one device (the
dp-sharded pool is not ported yet). The contiguous cache
(``kv_cache.py``) gives every slot its own ``max_seq_len`` strip; this
layout maps each slot's logical pages to pages of one pool through a
block table, and shares prompt prefixes between requests through a radix
trie:

- **Device layout** (``init_cache``): ``k``/``v`` are the pool
  ``[num_layers, num_pages, page_len, n_kv_heads, head_dim]`` (int8 mode
  adds fp32 ``k_scale``/``v_scale`` ``[L, P, page_len, Hkv]``; the
  ``hot_bf16`` policy adds the int8 side pool ``k_q``/``v_q`` with those
  scales and the per-page read flags ``page_quant [P]``), plus
  ``block_tables [slots, max_pages]`` int32 and ``lengths [slots]``.
  Page 0 is the NULL page: unallocated table entries point at it and
  every out-of-window or pad write lands in it, so a stray index touches
  only bytes nothing reads unmasked.
- **Host allocator** (``PagePool``, ``RadixCache``, ``PagedKV``): a free
  list and a refcount per page, slots that allocate as they grow, and a
  write into a page held by more than one holder copies it first
  (``ensure_writable`` plans the copy, ``copy_page`` makes it). The
  decisions, and their order, are the JAX package's, so the two give the
  same tables, refcounts and counters on the same traffic.
- **Page transport** (prefill/decode disaggregation,
  ``page_transport.py``): ``gather_pages`` reads a batch of pool pages
  out page-major, ``write_pages`` writes imported ones in; the radix
  cache plans and grafts imported chunks (``plan_adopt``, ``adopt``) and
  names its hottest prefixes (``cached_prefixes``); ``PagedKV`` pins an
  exported prefix (``acquire_prefix``, ``release_pages``) and allocates
  an import all or nothing (``alloc_import``, ``finish_import``).

As in ``kv_cache.py``, the device ops update the cache IN PLACE (the pool
is the largest tensor a server holds) and return it for call-site
symmetry. The pool is allocated with ``torch.zeros``: a key the mask
hides gets probability exactly 0, but 0 x NaN is NaN, so every byte a
table can point at (page 0, a fresh page's unwritten tail) must be
finite.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from picotron_tpu_torch.config import ModelConfig
from picotron_tpu_torch.inference import kv_cache
from picotron_tpu_torch.ops.kernels.decode_attention import (
    flash_decode_attention,
    gather_mixed,
    gather_window,
)
from picotron_tpu_torch.utils import torch_dtype

# table entries start here; page 0 is the reserved NULL page (never
# allocated, the target of masked and out-of-window writes)
NULL_PAGE = 0

# cache leaves with no layer axis: page metadata the host owns; every
# per-page device op skips them
META_LEAVES = ("lengths", "block_tables", "page_quant")


class PagePoolExhausted(RuntimeError):
    """No free page and nothing evictable: the caller sheds, it never
    corrupts a live slot."""


# --------------------------------------------------------------------------- #
# device ops (in place)
# --------------------------------------------------------------------------- #


def is_policy(cache: dict) -> bool:
    """Whether a cache (whole or one layer's) carries the ``hot_bf16``
    dual-representation pool."""
    return "k_q" in cache


def init_cache(m: ModelConfig, slots: int, num_pages: int, page_len: int,
               max_pages: int, dtype=None, device=None,
               quantized: bool = False, policy: bool = False) -> dict:
    """Zeroed page pool, NULL block tables and zero lengths. ``quantized``
    stores int8 rows with fp32 scales; ``policy`` (``hot_bf16``) adds the
    int8 side pool and ``page_quant`` beside the full-precision pool."""
    shape = (m.num_hidden_layers, num_pages, page_len,
             m.num_key_value_heads, m.head_dim)

    def zeros(shp, dt):
        return torch.zeros(shp, dtype=dt, device=device)

    if quantized:
        if policy:
            raise ValueError(
                "hot_bf16 page policy is mutually exclusive with a "
                "uniformly int8 cache (config.validate names the fix)")
        cache = {"k": zeros(shape, torch.int8), "v": zeros(shape, torch.int8),
                 "k_scale": zeros(shape[:-1], kv_cache.SCALE_DTYPE),
                 "v_scale": zeros(shape[:-1], kv_cache.SCALE_DTYPE)}
    else:
        dt = dtype if dtype is not None else torch_dtype(m.dtype)
        cache = {"k": zeros(shape, dt), "v": zeros(shape, dt)}
        if policy:
            cache.update({
                "k_q": zeros(shape, torch.int8),
                "v_q": zeros(shape, torch.int8),
                "k_scale": zeros(shape[:-1], kv_cache.SCALE_DTYPE),
                "v_scale": zeros(shape[:-1], kv_cache.SCALE_DTYPE),
                "page_quant": zeros((num_pages,), torch.int32)})
    cache["block_tables"] = zeros((slots, max_pages), torch.int32)
    cache["lengths"] = zeros((slots,), torch.int32)
    return cache


def _targets(bt: torch.Tensor, rows: torch.Tensor, page_len: int) -> tuple:
    """Logical row positions ``rows`` [B, S] -> (pool page, in-page offset)
    through the block-table rows ``bt`` [B, max_pages]. Rows outside the
    paged window go to the NULL page at offset 0."""
    maxp = bt.shape[-1]
    rows = rows.long()
    valid = (rows >= 0) & (rows < maxp * page_len)
    page_idx = torch.clamp(torch.div(rows, page_len, rounding_mode="floor"),
                           0, maxp - 1)
    pid = torch.gather(bt.long(), -1, page_idx)
    pid = torch.where(valid, pid, NULL_PAGE)
    off = torch.where(valid, rows % page_len, 0)
    return pid, off


def cache_write(layer_cache: dict, k_new: torch.Tensor, v_new: torch.Tensor,
                pos: torch.Tensor) -> dict:
    """Write each slot's S fresh rows [B, S, Hkv, D] through its block-table
    row (in place): row ``pos[b] + s`` lands in pool page
    ``bt[b, (pos[b] + s) // page_len]`` at offset ``(pos[b] + s) %
    page_len``. One scatter serves decode (S = 1) and the chunked prefill
    (B = 1). Out-of-window rows and free slots' NULL entries write the
    NULL page. An int8 cache quantizes on write; a ``hot_bf16`` cache
    writes both representations. The host allocator made every page this
    can touch exclusively the writer's before the dispatch, so the
    verify's rejected rows strand only in the writer's own pages. A
    ``draft_valid`` [B] entry (the ragged verify's mask, spliced in per
    dispatch) sends the rows at or past a slot's count of real fed tokens
    to the NULL page too."""
    S = k_new.shape[1]
    bt = layer_cache["block_tables"]
    page_len = layer_cache["k"].shape[1]
    rows = pos.long()[:, None] + torch.arange(S, device=pos.device)[None, :]
    valid = layer_cache.get("draft_valid")
    if valid is not None and S > 1:
        cols = torch.arange(S, device=pos.device)[None, :]
        rows = torch.where(cols < valid.long()[:, None], rows, -1)
    pid, off = _targets(bt, rows, page_len)
    policy = is_policy(layer_cache)
    # int8 rows with scales: a uniformly int8 cache, or hot_bf16's side pool
    int8 = kv_cache.quantized(layer_cache)
    for name, new in (("k", k_new), ("v", v_new)):
        if int8:
            qvals, scales = kv_cache.quantize_kv(new)
            layer_cache[name + "_scale"][pid, off] = scales
            layer_cache[name + "_q" if policy else name][pid, off] = qvals
        if policy or not int8:
            layer_cache[name][pid, off] = new.to(layer_cache[name].dtype)
    return layer_cache


def attend(q: torch.Tensor, layer_cache: dict, lengths: torch.Tensor,
           scale: float, impl: str = "dense") -> torch.Tensor:
    """Masked attention of S fresh queries against one layer's paged cache.
    "flash" hands the pool and the block-table rows to C's paged variants
    (bf16, int8, or the ``hot_bf16`` mixed read with the per-page flags);
    "dense" gathers the windows and runs ``kv_cache.decode_attention``
    (an int8 window dequantized to fp32 first; under ``hot_bf16`` each
    page's rows taken from the representation its flag selects)."""
    bt = layer_cache["block_tables"]
    lc = layer_cache
    if impl == "flash":
        lengths = lengths.to(torch.int32)
        if is_policy(lc):
            return flash_decode_attention(
                q, lc["k"], lc["v"], lengths, scale, k_scale=lc["k_scale"],
                v_scale=lc["v_scale"], block_tables=bt, k_quant=lc["k_q"],
                v_quant=lc["v_q"], page_quant=lc["page_quant"])
        return flash_decode_attention(
            q, lc["k"], lc["v"], lengths, scale, k_scale=lc.get("k_scale"),
            v_scale=lc.get("v_scale"), block_tables=bt)
    if impl != "dense":
        raise ValueError(f"unknown attend impl {impl!r} (dense|flash)")
    if is_policy(lc):
        k, v = gather_mixed(lc["k"], lc["v"], lc["k_q"], lc["v_q"],
                            lc["k_scale"], lc["v_scale"], bt,
                            lc["page_quant"])
    elif kv_cache.quantized(lc):
        k = kv_cache.dequantize_kv(gather_window(lc["k"], bt),
                                   gather_window(lc["k_scale"], bt),
                                   torch.float32)
        v = kv_cache.dequantize_kv(gather_window(lc["v"], bt),
                                   gather_window(lc["v_scale"], bt),
                                   torch.float32)
    else:
        k, v = gather_window(lc["k"], bt), gather_window(lc["v"], bt)
    return kv_cache.decode_attention(q, k, v, lengths, scale)


def insert_prefill(cache: dict, kv: dict, slot: int, length: int) -> dict:
    """Park a one-shot prefill's ``[L, 1, S_bucket, Hkv(, D)]`` blocks in
    ``slot``'s pages and set its length (in place). Pad rows past
    ``length`` (and rows whose page was never allocated) write the NULL
    page."""
    S = kv["k"].shape[2]
    page_len = cache["k"].shape[2]
    dev = cache["k"].device
    rows = torch.arange(S, device=dev)[None, :]
    rows = torch.where(rows < length, rows, -1)  # pad rows -> NULL page
    pid, off = _targets(cache["block_tables"][slot: slot + 1], rows,
                        page_len)
    pid, off = pid[0], off[0]
    for name in cache:
        if name not in META_LEAVES:
            cache[name][:, pid, off] = kv[name][:, 0].to(cache[name].dtype)
    cache["lengths"][slot: slot + 1].fill_(length)
    return cache


def slice_page(cache: dict, pid: int) -> dict:
    """One pool page's storage leaves as ``[L, page_len, ...]`` views (the
    single-page read of tests and debugging)."""
    return {name: a[:, pid] for name, a in cache.items()
            if name not in META_LEAVES}


def gather_pages(cache: dict, pids: torch.Tensor) -> dict:
    """A batch of pool pages' storage leaves as contiguous ``[n, L,
    page_len, ...]`` tensors (page-major, ``write_pages``' input): the
    export half of the page transport, one ``index_select`` per leaf on
    the pool's page axis. ``pids`` [n] int64 on the pool's device."""
    return {name: a.index_select(1, pids).movedim(1, 0).contiguous()
            for name, a in cache.items() if name not in META_LEAVES}


def write_pages(cache: dict, pages: dict, pids: torch.Tensor) -> dict:
    """Write a batch of imported pages' storage leaves into pool pages
    ``pids`` (in place): the import half of the page transport.
    ``pages[name]`` is ``[n, L, page_len, ...]`` in the pool's dtype (the
    transport checked the dtypes, so the cast is an identity guard);
    ``pids`` [n] int64 on the pool's device."""
    for name, a in pages.items():
        dst = cache[name]
        dst.index_copy_(1, pids, a.movedim(0, 1).to(dst.dtype))
    return cache


def copy_page(cache: dict, src: int, dst: int) -> dict:
    """Byte-exact copy of pool page ``src`` onto ``dst`` across every layer
    and storage leaf (K, V, scales): the device half of copy-on-write."""
    for name, a in cache.items():
        if name not in META_LEAVES:
            a[:, dst] = a[:, src]
    return cache


def set_length(cache: dict, slot: int, length: int) -> dict:
    """Set one slot's length (a shared prefix admitted with no prefill)."""
    cache["lengths"][slot: slot + 1].fill_(length)
    return cache


def slot_rows(cache: dict, tables: np.ndarray, slot: int, n: int,
              name: str = "k") -> np.ndarray:
    """Test helper: slot ``slot``'s first ``n`` logical rows of storage leaf
    ``name`` as an [L, n, ...] host array, through the host table."""
    pool = cache[name].cpu().numpy()
    plen = pool.shape[2]
    rows = [pool[:, int(tables[slot, r // plen]), r % plen] for r in range(n)]
    return np.stack(rows, axis=1)


# --------------------------------------------------------------------------- #
# host-side allocator
# --------------------------------------------------------------------------- #


class PagePool:
    """Free list and refcounts over ``num_pages`` pool pages. Page 0 is
    reserved (NULL). A page's refcount counts its holders (slots whose
    tables point at it, and the radix cache); it returns to the free list
    when the count reaches 0. FIFO allocation order."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("num_pages must be >= 2 (page 0 is reserved)")
        self.num_pages = int(num_pages)
        self.refs = np.zeros(self.num_pages, np.int32)
        self.refs[NULL_PAGE] = 1  # permanently held, never freed
        self._free: deque = deque(range(1, self.num_pages))

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def usable_pages(self) -> int:
        """Pages that can ever hold data (everything but NULL)."""
        return self.num_pages - 1

    @property
    def live_count(self) -> int:
        return self.usable_pages - self.free_count

    @property
    def shared_count(self) -> int:
        """Pages with more than one holder."""
        return int(np.sum(self.refs[1:] > 1))

    def alloc(self):
        """A free page at refcount 1, or None when the pool is dry."""
        if not self._free:
            return None
        pid = self._free.popleft()
        assert self.refs[pid] == 0
        self.refs[pid] = 1
        return pid

    def ref(self, pid: int) -> None:
        """Add a holder; a freed page (refcount 0) is never resurrected."""
        if pid == NULL_PAGE:
            raise ValueError("cannot take a reference on the NULL page")
        if self.refs[pid] <= 0:
            raise ValueError(f"page {pid} is free; ref would resurrect it")
        self.refs[pid] += 1

    def unref(self, pid: int) -> bool:
        """Drop a holder; True when this freed the page. A double free
        raises."""
        if pid == NULL_PAGE:
            raise ValueError("cannot drop a reference on the NULL page")
        if self.refs[pid] <= 0:
            raise ValueError(f"double free of page {pid}")
        self.refs[pid] -= 1
        if self.refs[pid] == 0:
            self._free.append(pid)
            return True
        return False


class _Node:
    """One radix node: a pool page holding the K/V rows of ``tokens`` (a
    full page of tokens inside the trie, fewer at a prompt's tail)."""

    __slots__ = ("tokens", "page_id", "parent", "children", "last_use")

    def __init__(self, tokens: tuple, page_id: int, parent):
        self.tokens = tokens
        self.page_id = page_id
        self.parent = parent
        self.children: dict = {}
        self.last_use = 0


class RadixCache:
    """Prefix trie over page-sized token chunks -> pool pages.

    ``match`` walks full-page chunks by exact lookup, then takes the best
    partial overlap among the children where they diverge (that page is
    shared too; the sharer's first write past the fork copies it).
    ``insert`` registers a prefilled prompt's pages (the cache becomes a
    holder). Eviction frees the least recently used leaf that only the
    cache holds. Each ``salt`` (an isolation domain: a tenant) has its
    own root; eviction spans all of them."""

    def __init__(self, page_len: int, pool: PagePool):
        self.page_len = int(page_len)
        self.pool = pool
        self.root = _Node((), -1, None)  # the default ("") salt's root
        self._roots = {"": self.root}
        self._clock = 0
        self.evictions = 0

    def _root_for(self, salt: str) -> _Node:
        root = self._roots.get(salt)
        if root is None:
            root = _Node((), -1, None)
            self._roots[salt] = root
        return root

    def _touch(self, node: _Node) -> None:
        self._clock += 1
        node.last_use = self._clock

    @staticmethod
    def _overlap(a, b) -> int:
        n = 0
        for x, y in zip(a, b):
            if x != y:
                break
            n += 1
        return n

    def match(self, ids, salt: str = "") -> tuple:
        """Longest cached prefix of ``ids`` in ``salt``'s domain: (pages,
        matched), ``pages`` backing positions [0, matched) in order (the
        last may be partial)."""
        node, pages, matched = self._root_for(salt), [], 0
        rest = list(ids)
        while True:
            chunk = tuple(rest[: self.page_len])
            child = (node.children.get(chunk)
                     if len(chunk) == self.page_len else None)
            if child is not None and len(child.tokens) == self.page_len:
                pages.append(child.page_id)
                matched += self.page_len
                rest = rest[self.page_len:]
                self._touch(child)
                node = child
                continue
            best, bj = None, 0
            for c in node.children.values():
                j = self._overlap(c.tokens, rest)
                if j > bj:
                    best, bj = c, j
            if best is not None:
                pages.append(best.page_id)
                matched += bj
                self._touch(best)
            return pages, matched

    def insert(self, ids, page_at, salt: str = "") -> int:
        """Register a prefilled prompt's pages in ``salt``'s domain:
        ``page_at(i)`` is the prompt's logical page ``i``. Existing nodes
        are touched; new ones take a cache reference. A partial tail
        becomes a partial leaf unless a child already covers it. Returns
        the number of nodes created."""
        node, created = self._root_for(salt), 0
        n = len(ids)
        full = n // self.page_len
        for i in range(full):
            chunk = tuple(ids[i * self.page_len:(i + 1) * self.page_len])
            child = node.children.get(chunk)
            if child is None:
                pid = page_at(i)
                if pid == NULL_PAGE or self.pool.refs[pid] != 1:
                    # not exclusively the slot's: stop rather than freeze
                    # a page that may still move
                    return created
                child = _Node(chunk, pid, node)
                node.children[chunk] = child
                self.pool.ref(pid)
                created += 1
            self._touch(child)
            node = child
        tail = tuple(ids[full * self.page_len:])
        if tail:
            for c in node.children.values():
                if self._overlap(c.tokens, tail) == len(tail):
                    return created  # an existing child already covers it
            pid = page_at(full)
            if pid != NULL_PAGE and self.pool.refs[pid] == 1:
                leaf = _Node(tail, pid, node)
                node.children[tail] = leaf
                self.pool.ref(pid)
                self._touch(leaf)
                created += 1
        return created

    def plan_adopt(self, ids, salt: str = "") -> list:
        """Chunk indices of ``ids`` with no trie node in ``salt``'s domain:
        the pages an import must supply (a dry run of ``adopt``). Once one
        chunk is missing every deeper one is too, so the plan is a suffix
        of the chunk list."""
        node = self._root_for(salt)
        n = len(ids)
        full = n // self.page_len
        tail = n % self.page_len
        total = full + (1 if tail else 0)
        for i in range(full):
            chunk = tuple(ids[i * self.page_len:(i + 1) * self.page_len])
            child = node.children.get(chunk)
            if child is None:
                return list(range(i, total))
            node = child
        if tail:
            t = tuple(ids[full * self.page_len:])
            if not any(self._overlap(c.tokens, t) == len(t)
                       for c in node.children.values()):
                return [full]
        return []

    def adopt(self, ids, page_for: dict, salt: str = "") -> tuple:
        """Graft imported pages into ``salt``'s trie: ``page_for[i]`` backs
        chunk ``i`` of ``ids`` (the last may be partial). New nodes take a
        cache reference (the caller then drops its own, leaving the cache
        the only holder, as after ``register_prompt``). A chunk that has a
        node already is touched, and its supplied page goes back in
        ``dups`` for the caller to free. Returns (created, dups)."""
        node, created, dups = self._root_for(salt), 0, []
        n = len(ids)
        full = n // self.page_len
        for i in range(full):
            chunk = tuple(ids[i * self.page_len:(i + 1) * self.page_len])
            child = node.children.get(chunk)
            if child is not None:
                if i in page_for:
                    dups.append(page_for[i])
                self._touch(child)
                node = child
                continue
            if i not in page_for:
                # a gap the import cannot fill (the plan predates an
                # eviction): stop grafting
                return created, dups
            child = _Node(chunk, page_for[i], node)
            node.children[chunk] = child
            self.pool.ref(page_for[i])
            self._touch(child)
            node = child
            created += 1
        tail = tuple(ids[full * self.page_len:])
        if tail and full in page_for:
            if any(self._overlap(c.tokens, tail) == len(tail)
                   for c in node.children.values()):
                dups.append(page_for[full])
            else:
                leaf = _Node(tail, page_for[full], node)
                node.children[tail] = leaf
                self.pool.ref(page_for[full])
                self._touch(leaf)
                created += 1
        return created, dups

    def _leaves(self):
        for root in self._roots.values():
            stack = list(root.children.values())
            while stack:
                n = stack.pop()
                if not n.children:
                    yield n
                stack.extend(n.children.values())

    def cached_prefixes(self, limit: int = 4) -> list:
        """The hottest cached prefixes across every domain: ``[(salt,
        ids)]`` for the ``limit`` most recently used leaves, hottest first
        (a leaf's path from its root is a maximal cached prefix)."""
        scored = []
        for salt, root in self._roots.items():
            stack = list(root.children.values())
            while stack:
                n = stack.pop()
                if n.children:
                    stack.extend(n.children.values())
                    continue
                ids: list = []
                node = n
                while node is not None and node.parent is not None:
                    ids[:0] = node.tokens
                    node = node.parent
                scored.append((n.last_use, salt, ids))
        scored.sort(key=lambda t: t[0], reverse=True)
        return [(salt, ids) for _, salt, ids in scored[:max(0, limit)]]

    def evictable_count(self) -> int:
        """Pages eviction could free, cascading: nodes whose whole subtree
        only the cache holds (freeing a leaf exposes its parent)."""

        def count(n: _Node) -> tuple:
            total, free = 0, True
            for c in n.children.values():
                ct, cf = count(c)
                total += ct
                free = free and cf
            if not free or self.pool.refs[n.page_id] != 1:
                return total, False
            return total + 1, True

        return sum(count(c)[0] for root in self._roots.values()
                   for c in root.children.values())

    def evict_one(self) -> bool:
        """Free the least recently used leaf only the cache holds; False
        when nothing is evictable."""
        best = None
        for n in self._leaves():
            if self.pool.refs[n.page_id] == 1 and (
                    best is None or n.last_use < best.last_use):
                best = n
        if best is None:
            return False
        self.pool.unref(best.page_id)
        del best.parent.children[best.tokens]
        self.evictions += 1
        return True

    def clear(self) -> None:
        """Drop every reference the cache holds, in every salt's domain
        (the pool reset after a lost cache)."""
        stack = [n for root in self._roots.values()
                 for n in root.children.values()]
        while stack:
            n = stack.pop()
            self.pool.unref(n.page_id)
            stack.extend(n.children.values())
        for root in self._roots.values():
            root.children = {}


class PagedKV:
    """Host-side page manager for one engine: per-slot block tables and
    lengths, the pool, the radix cache, and admission pricing.

    The engine calls ``ensure_writable`` before every dispatch (allocate
    growth pages, copy shared ones), mirrors the device lengths after
    (``advance``/``set_len``) and frees on release. The batcher prices
    admission in pages against ``can_admit``. ``tables`` is the numpy
    master the engine copies to the device before each dispatch."""

    def __init__(self, slots: int, page_len: int, max_pages: int,
                 num_pages: int, prefix_cache: bool = True):
        self.slots = int(slots)
        self.page_len = int(page_len)
        self.max_pages = int(max_pages)
        self.num_pages = int(num_pages)
        self.prefix_cache = bool(prefix_cache)
        self.reset()

    def reset(self) -> None:
        """Fresh pool, trie and tables (pairs with a fresh zeroed device
        cache)."""
        self.pool = PagePool(self.num_pages)
        self.radix = RadixCache(self.page_len, self.pool)
        self.tables = np.full((self.slots, self.max_pages), NULL_PAGE,
                              np.int32)
        self.host_len = np.zeros(self.slots, np.int64)
        self.priced = np.zeros(self.slots, np.int64)
        self.prefix_queries = 0
        self.prefix_hits = 0
        self.prompt_tokens = 0
        self.cached_tokens = 0
        self.cow_copies = 0

    # ---- pricing / admission ---------------------------------------------

    def pages_for(self, tokens: int) -> int:
        """Worst-case pages ``tokens`` rows can occupy."""
        return -(-max(int(tokens), 0) // self.page_len)

    @property
    def usable_pages(self) -> int:
        return self.pool.usable_pages

    def future_need(self) -> int:
        """Pages the live slots may still demand: each priced slot can grow
        (and copy) until every page of its commitment is its own, so only
        exclusively held pages pay the debt down."""
        need = 0
        for s in range(self.slots):
            if self.priced[s] <= 0:
                continue
            exclusive = sum(1 for pid in self.tables[s]
                            if pid != NULL_PAGE and self.pool.refs[pid] == 1)
            need += max(0, int(self.priced[s]) - exclusive)
        return need

    def available_pages(self) -> int:
        """Pages a new request could claim now: free plus evictable, less
        what live slots are still owed."""
        return (self.pool.free_count + self.radix.evictable_count()
                - self.future_need())

    def can_admit(self, need: int) -> bool:
        """Whether ``need`` pages are claimable now."""
        return need <= self.available_pages()

    # ---- slot lifecycle ---------------------------------------------------

    def _alloc(self) -> int:
        pid = self.pool.alloc()
        while pid is None:
            if not self.radix.evict_one():
                raise PagePoolExhausted(
                    f"page pool exhausted ({self.pool.usable_pages} pages, "
                    f"none free or evictable)")
            pid = self.pool.alloc()
        return pid

    def match_prefix(self, slot: int, ids, cap_last: bool = True,
                     salt: str = "") -> int:
        """Find the longest cached prefix of ``ids``, take references on its
        pages into ``slot``'s table, and return the cached length (capped
        at ``len(ids) - 1`` so the last prompt token runs through the
        model: its logits give the first token). What an earlier failed
        admission left in the slot is released first."""
        for pi in range(self.max_pages):
            pid = int(self.tables[slot, pi])
            if pid != NULL_PAGE:
                self.pool.unref(pid)
        self.tables[slot] = NULL_PAGE
        self.host_len[slot] = 0
        self.prefix_queries += 1
        self.prompt_tokens += len(ids)
        if not self.prefix_cache:
            return 0
        pages, matched = self.radix.match(ids, salt=salt)
        cached = min(matched, len(ids) - (1 if cap_last else 0))
        npages = self.pages_for(cached)
        for i in range(npages):
            self.pool.ref(pages[i])
            self.tables[slot, i] = pages[i]
        self.host_len[slot] = cached
        if cached > 0:
            self.prefix_hits += 1
            self.cached_tokens += cached
        return cached

    def peek_prefix(self, ids, cap_last: bool = True,
                    salt: str = "") -> int:
        """The cached length ``match_prefix`` would give ``ids``, taking no
        reference and counting no query."""
        if not self.prefix_cache:
            return 0
        _, matched = self.radix.match(ids, salt=salt)
        return min(matched, len(ids) - (1 if cap_last else 0))

    def ensure_writable(self, slot: int, from_pos: int, to_pos: int) -> list:
        """Make rows [from_pos, to_pos) of ``slot`` writable: allocate
        missing pages; for a page with more than one holder allocate a
        fresh one, record the (src, dst) copy for the engine to make, and
        move the slot's reference. Idempotent; clamped to the paged
        window; raises PagePoolExhausted when the pool is dry."""
        to_pos = min(int(to_pos), self.max_pages * self.page_len)
        from_pos = max(int(from_pos), 0)
        cows = []
        if to_pos <= from_pos:
            return cows
        first = from_pos // self.page_len
        last = -(-to_pos // self.page_len)  # exclusive
        for pi in range(first, last):
            pid = int(self.tables[slot, pi])
            if pid == NULL_PAGE:
                self.tables[slot, pi] = self._alloc()
            elif self.pool.refs[pid] > 1:
                fresh = self._alloc()
                cows.append((pid, fresh))
                self.tables[slot, pi] = fresh
                self.pool.unref(pid)
                self.cow_copies += 1
        return cows

    # ---- page transport (prefill/decode disaggregation) -------------------

    def acquire_prefix(self, ids, salt: str = "") -> tuple:
        """Export pin: the longest cached prefix of ``ids`` in ``salt``'s
        domain, with a transient reference on each of its pages so no
        eviction frees them while their bytes are read. Returns
        (page_ids, matched tokens); the caller ``release_pages`` them."""
        if not self.prefix_cache:
            return [], 0
        pages, matched = self.radix.match(ids, salt=salt)
        held = []
        for i in range(self.pages_for(matched)):
            self.pool.ref(pages[i])
            held.append(int(pages[i]))
        return held, matched

    def release_pages(self, pids) -> None:
        """Drop the references an export pin or a failed import holds."""
        for pid in pids:
            self.pool.unref(int(pid))

    def alloc_import(self, n: int) -> list:
        """``n`` pages for an import, each held by the importer. All or
        nothing: on exhaustion the batch's pages are released before the
        raise."""
        pids = []
        try:
            for _ in range(n):
                pids.append(self._alloc())
        except PagePoolExhausted:
            self.release_pages(pids)
            raise
        return pids

    def finish_import(self, ids, chunk_pids: dict, salt: str = "") -> int:
        """Graft written import pages into ``salt``'s domain and drop the
        importer's references: new nodes end held by the cache alone, a
        duplicate chunk's page frees at once. Returns nodes created."""
        created, _ = self.radix.adopt(ids, chunk_pids, salt=salt)
        self.release_pages(chunk_pids.values())
        return created

    def register_prompt(self, slot: int, ids, salt: str = "") -> None:
        """Insert a prefilled prompt's pages into the radix cache (the
        slot's later writes land past the prompt and copy first)."""
        if self.prefix_cache:
            self.radix.insert(ids, lambda i: int(self.tables[slot, i]),
                              salt=salt)

    def quant_flags(self) -> np.ndarray:
        """``hot_bf16`` read flags per page (``page_quant``): 1 = read as
        int8 (exactly one holder), 0 = read at full precision (shared, or
        free and unread). Recomputed from the refcounts before every
        dispatch; both representations are always written, so a flip
        moves no bytes."""
        return (self.pool.refs == 1).astype(np.int32)

    def advance(self, slot_counts) -> None:
        """Mirror the device lengths after a dispatch (tokens per slot)."""
        self.host_len += np.asarray(slot_counts, np.int64)

    def set_len(self, slot: int, n: int) -> None:
        self.host_len[slot] = int(n)

    def free_slot(self, slot: int) -> None:
        """Drop every reference the slot holds (shared pages live on) and
        clear its table row."""
        for pi in range(self.max_pages):
            pid = int(self.tables[slot, pi])
            if pid != NULL_PAGE:
                self.pool.unref(pid)
        self.tables[slot] = NULL_PAGE
        self.host_len[slot] = 0
        self.priced[slot] = 0

    # ---- observability ----------------------------------------------------

    def stats(self) -> dict:
        """Pool occupancy and prefix-cache effectiveness (merged into
        ``batcher.stats()``)."""
        total = self.pool.usable_pages
        live = self.pool.live_count
        return {
            "kv_layout": "paged",
            "kv_page_len": self.page_len,
            "kv_pages_total": total,
            "kv_pages_free": self.pool.free_count,
            "kv_pages_live": live,
            "kv_pool_utilization": round(live / max(total, 1), 4),
            "kv_pages_shared": self.pool.shared_count,
            "prefix_queries": self.prefix_queries,
            "prefix_hits": self.prefix_hits,
            "prefix_hit_rate": (
                round(self.cached_tokens / self.prompt_tokens, 4)
                if self.prompt_tokens else None),
            "prefix_cached_tokens": self.cached_tokens,
            "cow_copies": self.cow_copies,
            "radix_evictions": self.radix.evictions,
            # hot_bf16 mix over live pages (cold = read as int8)
            "kv_pages_quant": int(np.sum(self.pool.refs[1:] == 1)),
        }
