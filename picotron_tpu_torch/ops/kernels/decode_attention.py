"""Kernel C: flash decode, KV-cache attention (csrc/decode_attention.cu),
and its plain versions.

``flash_decode_attention`` is the wrapper ``inference/kv_cache.attend``
calls for ``attend_impl="flash"``: CPU tensors take the plain version; a
CUDA tensor launches the kernel or raises. The function is
``picotron_tpu/ops/pallas/decode_attention.py::flash_decode_attention``'s
contiguous form: S fresh queries per slot, query row ``s`` at position
``lengths[b] - S + s`` seeing key ``t`` iff ``t <=`` that position (and
``t < T``), fp32 softmax and P @ V, and rows with no visible key returning
zeros. Two variants, each its own kernel with its own launch count:

- full precision (``KERNEL``): bf16 K/V as stored;
- int8 (``KERNEL_INT8``, the Pallas kernel's ``quantized=True`` path):
  int8 K/V with fp32 per-row scales ``k_scale``/``v_scale`` [B, T, Hkv],
  each row dequantized in registers (int8 -> fp32 x scale) as the tile
  loads. Its plain version dequantizes the whole block to fp32 first and
  runs the full-precision arithmetic.

With ``block_tables`` [B, max_pages] int32 the cache is the paged layout
(``inference/paged_kv.py``): k/v (and scales) are a page pool
``[P, page_len, Hkv, D]`` and key ``t`` of slot ``b`` is row
``t % page_len`` of pool page ``block_tables[b, t // page_len]``, over
``max_pages * page_len`` keys (csrc/paged_decode.cu). Three more
variants, each its own kernel and count:

- paged (``KERNEL_PAGED``): a bf16 pool;
- paged int8 (``KERNEL_PAGED_INT8``): an int8 pool with fp32 scales;
- mixed (``KERNEL_MIXED``, the ``hot_bf16`` policy): the bf16 pool k/v
  beside the int8 pool ``k_quant``/``v_quant`` with its scales; page
  ``p`` is read from the int8 pool when ``page_quant[p]`` is nonzero. The
  kernel looks the flags up through the table; the Pallas wrapper takes
  them gathered, as ``block_quant = page_quant[block_tables]``.

Their plain versions gather each slot's window through its table row
(JAX's dense read, ``paged_kv.attend``) and run the contiguous plain
arithmetic on it.

Every variant splits its walk over the window across blocks
(csrc/attention_tile.cuh): ``split_plan`` cuts the window into ranges of
whole 128-key tiles from the shapes alone, each block of a range that
holds a visible key writes fp32 partials (m, l, the unnormalised
accumulator) for it to a workspace the wrapper allocates, and the last such
block of each row block to finish merges them in split order, counted on
an int32 counter that the wrapper keeps zeroed per device (``COUNTERS``).
One call of a wrapper is one launch and counts once. Decode rows (S x g
<= 16) run their products on the fp32 pipes; chunk rows on the bf16
tensor cores, p split into two bf16 halves.
``flash_decode_attention_split_plain`` models the split walk in plain
PyTorch for the tests, and ``flash_decode_attention_mma_plain`` the
tensor-core arithmetic of chunk rows.
"""

from __future__ import annotations

import torch

from picotron_tpu_torch.ops.kernels import build

KERNEL = build.Kernel(
    name="flash_decode", route="cuda",
    source="picotron_tpu_torch/ops/kernels/csrc/decode_attention.cu",
    replaces="picotron_tpu/ops/pallas/decode_attention.py:162")
KERNEL_INT8 = build.Kernel(
    name="flash_decode_int8", route="cuda",
    source="picotron_tpu_torch/ops/kernels/csrc/decode_attention.cu",
    replaces="picotron_tpu/ops/pallas/decode_attention.py:162")

KERNEL_PAGED = build.Kernel(
    name="flash_decode_paged", route="cuda",
    source="picotron_tpu_torch/ops/kernels/csrc/paged_decode.cu",
    replaces="picotron_tpu/ops/pallas/decode_attention.py:162")
KERNEL_PAGED_INT8 = build.Kernel(
    name="flash_decode_paged_int8", route="cuda",
    source="picotron_tpu_torch/ops/kernels/csrc/paged_decode.cu",
    replaces="picotron_tpu/ops/pallas/decode_attention.py:162")
KERNEL_MIXED = build.Kernel(
    name="flash_decode_mixed", route="cuda",
    source="picotron_tpu_torch/ops/kernels/csrc/paged_decode.cu",
    replaces="picotron_tpu/ops/pallas/decode_attention.py:162")

HEAD_DIMS = (64, 128)  # head_dim values the kernel is compiled for
TILE_KEYS = 128  # keys per tile of the walk (attention_tile.cuh kKeys)
SMALL_ROWS = 16  # S * g at or under it: decode's row tile (kSmallRows)
MMA_ROWS = 64  # chunks' row tile, the wgmma M (kMmaRows)
MMA_KEYS = 64  # keys per step of a chunk's walk, the wgmma N (kSubKeys)
MAX_SPLIT_TILES = 8  # tiles a split may hold (kMaxSplitTiles)


def split_plan(n_keys: int, rows: int) -> tuple:
    """C's split plan for a window of ``n_keys`` keys (T, or max_pages x
    page_len) and ``rows`` = S x g folded query rows per slot and kv head:
    ``(n_splits, tiles_per_split)``, the window cut into ``n_splits``
    ranges of ``tiles_per_split`` whole 128-key tiles (the last may hold
    fewer). A function of the shapes alone: it never reads the lengths,
    which would cost a host sync on the decode path, so a contiguous and a
    paged call over the same window get the same plan. The head dim does
    not enter it.

    Decode (rows <= 16): one tile a split up to 32 splits, so that a
    decode step fills the card (T = 2048: 16 splits, 8 slots x 32 kv
    heads = 4,096 blocks). Chunks: at least two tiles a split, at most 8
    splits: the row blocks already multiply the blocks, and a split's
    second tile is copied while its first is computed."""
    tiles = max(1, -(-n_keys // TILE_KEYS))
    if rows <= SMALL_ROWS:
        per = -(-tiles // 32)
    else:
        per = max(2, -(-tiles // 8))
    per = min(per, MAX_SPLIT_TILES, tiles)
    n_splits = -(-tiles // per)
    return n_splits, -(-tiles // n_splits)


def plan_for(q: torch.Tensor, k: torch.Tensor,
             block_tables: torch.Tensor | None = None) -> tuple:
    """``split_plan`` of a call: the window is ``k``'s T, or ``max_pages
    x page_len`` of a pool ``k`` read through ``block_tables``."""
    n_keys = (k.shape[1] if block_tables is None
              else block_tables.shape[1] * k.shape[1])
    return split_plan(n_keys, q.shape[1] * (q.shape[2] // k.shape[2]))


def _workspace(q: torch.Tensor, n_splits: int) -> torch.Tensor:
    """The split partials, fp32: acc [n_splits, B*S*H, D], then m and l
    [n_splits, B*S*H]."""
    B, S, H, D = q.shape
    return torch.empty(n_splits * B * S * H * (D + 2), dtype=torch.float32,
                       device=q.device)


# device -> the merge's int32 counters, one per (slot, kv head, row block);
# a kernel leaves every counter it used at zero, so the buffer is zeroed
# once, when it is made or grown, and never per call. Calls that share it
# run one at a time (one stream).
COUNTERS: dict = {}


def _counters(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    B, S, H, _ = q.shape
    rows = S * (H // k.shape[2])
    tile = SMALL_ROWS if rows <= SMALL_ROWS else MMA_ROWS
    need = B * k.shape[2] * -(-rows // tile)
    buf = COUNTERS.get(q.device)
    if buf is None or buf.numel() < need:
        buf = torch.zeros(max(need, 4096), dtype=torch.int32,
                          device=q.device)
        COUNTERS[q.device] = buf
    return buf


def flash_decode_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, lengths: torch.Tensor,
                                 scale: float) -> torch.Tensor:
    """q: [B, S, H, D]; k/v: [B, T, Hkv, D]; lengths: [B] ->
    [B, S, H, D] in q.dtype."""
    B, S, nh, D = q.shape
    T, nkv = k.shape[1], k.shape[2]
    g = nh // nkv
    qg = q.reshape(B, S, nkv, g, D).float()
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * scale
    pos_q = (lengths.long()[:, None] - S
             + torch.arange(S, device=q.device)[None, :])  # [B, S]
    mask = (torch.arange(T, device=q.device)[None, None, :]
            <= pos_q[:, :, None])[:, None, None]  # [B, 1, 1, S, T]
    scores = torch.where(mask, scores, float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.where(mask, torch.exp(scores - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    l = l.permute(0, 3, 1, 2, 4)  # [B, S, kv, g, 1], like out
    out = torch.where(l > 0, out / torch.where(l > 0, l, 1.0), 0.0)
    return out.reshape(B, S, nh, D).to(q.dtype)


def flash_decode_attention_split_plain(q, k, v, lengths,
                                       scale) -> torch.Tensor:
    """A plain model of the kernels' split walk (not a plain version the
    wrapper runs): the window cut as ``split_plan`` cuts it, each range's
    fp32 partials (running max m, sum l and the unnormalised P @ V) with
    the causal mask, merged in split order as the merge kernel does:
    rescaled by exp(m_i - m), o = acc / l, zeros where l == 0. Same
    arguments and result as ``flash_decode_attention_plain``."""
    B, S, nh, D = q.shape
    T, nkv = k.shape[1], k.shape[2]
    g = nh // nkv
    n_splits, per = split_plan(T, S * g)
    qg = q.reshape(B, S, nkv, g, D).float()
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * scale
    pos_q = (lengths.long()[:, None] - S
             + torch.arange(S, device=q.device)[None, :])  # [B, S]
    mask = (torch.arange(T, device=q.device)[None, None, :]
            <= pos_q[:, :, None])[:, None, None]  # [B, 1, 1, S, T]
    parts = []
    for i in range(n_splits):
        lo, hi = i * per * TILE_KEYS, min((i + 1) * per * TILE_KEYS, T)
        mk = mask[..., lo:hi]
        s = torch.where(mk, scores[..., lo:hi], float("-inf"))
        m = s.amax(dim=-1, keepdim=True)
        p = torch.where(mk, torch.exp(s - torch.where(torch.isfinite(m), m,
                                                      0.0)), 0.0)
        acc = torch.einsum("bkgst,btkd->bkgsd", p, v[:, lo:hi].float())
        parts.append((m, p.sum(dim=-1, keepdim=True), acc))
    m = torch.stack([mi for mi, _, _ in parts]).amax(dim=0)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(parts[0][2])
    for mi, li, ai in parts:  # in split order; empty partials add nothing
        live = torch.isfinite(mi)
        w = torch.where(live, torch.exp(mi - torch.where(live, m, 0.0)), 0.0)
        l = l + li * w
        acc = acc + ai * w
    out = torch.where(l > 0, acc / torch.where(l > 0, l, 1.0), 0.0)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, nh, D).to(q.dtype)


def flash_decode_attention_mma_plain(q, k, v, lengths, scale, k_scale=None,
                                     v_scale=None) -> torch.Tensor:
    """A plain model of the kernels' chunk rows on the tensor cores (not a
    plain version the wrapper runs): the window cut as ``split_plan``
    cuts it, each split walked in 64-key steps with an online softmax.
    Scores are products of q and K rounded to bf16 (int8 K values, exact
    in bf16), summed in fp32, times each key's K scale, times ``scale``;
    p stays fp32 and l sums it; p times each key's V scale is split into
    hi = bf16(p) and lo = bf16(p - hi), and hi @ V + lo @ V accumulates in
    fp32; the splits merge in split order, zeros where l == 0. k/v: bf16
    [B, T, Hkv, D], or int8 with ``k_scale``/``v_scale`` [B, T, Hkv].
    Returns [B, S, H, D] in q.dtype."""
    B, S, nh, D = q.shape
    T, nkv = k.shape[1], k.shape[2]
    g = nh // nkv
    n_splits, per = split_plan(T, S * g)
    bf = torch.bfloat16
    qg = q.to(bf).float().reshape(B, S, nkv, g, D)
    kf, vf = k.to(bf).float(), v.to(bf).float()
    ones = torch.ones(B, T, nkv, device=q.device)
    # [B, T, Hkv] -> [B, Hkv, 1, 1, T], beside the scores
    ks, vs = ((ones if sc is None else sc.float()).permute(0, 2, 1)
              [:, :, None, None] for sc in (k_scale, v_scale))
    scores = torch.einsum("bskgd,btkd->bkgst", qg, kf) * ks * scale
    pos_q = (lengths.long()[:, None] - S
             + torch.arange(S, device=q.device)[None, :])  # [B, S]
    mask = (torch.arange(T, device=q.device)[None, None, :]
            <= pos_q[:, :, None])[:, None, None]  # [B, 1, 1, S, T]
    neg_inf = float("-inf")
    scores = torch.where(mask, scores, neg_inf)
    parts = []
    for i in range(n_splits):
        m = torch.full(scores.shape[:-1] + (1,), neg_inf, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(B, nkv, g, S, D, device=q.device)
        lo_key = i * per * TILE_KEYS
        for t0 in range(lo_key, min(lo_key + per * TILE_KEYS, T), MMA_KEYS):
            t1 = min(t0 + MMA_KEYS, T)
            s = scores[..., t0:t1]
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            dead = m_new == neg_inf
            alpha = torch.where(dead, 1.0, torch.exp(m - m_new))
            p = torch.where(s == neg_inf, 0.0,
                            torch.exp(s - torch.where(dead, 0.0, m_new)))
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            pv = p * vs[..., t0:t1]
            hi = pv.to(bf).float()
            lo = (pv - hi).to(bf).float()
            acc = (acc * alpha
                   + torch.einsum("bkgst,btkd->bkgsd", hi, vf[:, t0:t1])
                   + torch.einsum("bkgst,btkd->bkgsd", lo, vf[:, t0:t1]))
            m = m_new
        parts.append((m, l, acc))
    m = torch.stack([mi for mi, _, _ in parts]).amax(dim=0)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(parts[0][2])
    for mi, li, ai in parts:  # in split order; empty partials add nothing
        live = torch.isfinite(mi)
        w = torch.where(live, torch.exp(mi - torch.where(live, m, 0.0)), 0.0)
        l = l + li * w
        acc = acc + ai * w
    out = torch.where(l > 0, acc / torch.where(l > 0, l, 1.0), 0.0)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, nh, D).to(q.dtype)


def flash_decode_attention_int8_plain(q, k, v, lengths, scale, k_scale,
                                      v_scale) -> torch.Tensor:
    """The int8 variant's plain version: K/V dequantized to fp32
    (int8 x per-row scale), then the full-precision arithmetic."""
    kf = k.float() * k_scale[..., None]
    vf = v.float() * v_scale[..., None]
    return flash_decode_attention_plain(q, kf, vf, lengths, scale)


def gather_window(pool: torch.Tensor, block_tables: torch.Tensor
                  ) -> torch.Tensor:
    """Pool [P, page_len, ...] through tables [B, max_pages] -> each slot's
    window [B, max_pages * page_len, ...]."""
    g = pool[block_tables.long()]
    return g.reshape((block_tables.shape[0], -1) + tuple(pool.shape[2:]))


def flash_decode_attention_paged_plain(q, k, v, lengths, scale,
                                       block_tables) -> torch.Tensor:
    """The paged variant's plain version: k/v pools gathered into windows,
    then the contiguous arithmetic."""
    return flash_decode_attention_plain(
        q, gather_window(k, block_tables), gather_window(v, block_tables),
        lengths, scale)


def flash_decode_attention_paged_int8_plain(q, k, v, lengths, scale,
                                            k_scale, v_scale, block_tables
                                            ) -> torch.Tensor:
    """The paged int8 variant's plain version: gathered, dequantized to
    fp32, then the contiguous arithmetic."""
    return flash_decode_attention_int8_plain(
        q, gather_window(k, block_tables), gather_window(v, block_tables),
        lengths, scale, gather_window(k_scale, block_tables),
        gather_window(v_scale, block_tables))


def gather_mixed(k, v, k_quant, v_quant, k_scale, v_scale, block_tables,
                 page_quant) -> tuple:
    """``hot_bf16`` pages read as stored: both representations gathered
    into windows, the int8 one dequantized, and each page's rows taken
    from the one its flag selects. Returns fp32 (k, v) windows."""
    page_len = k.shape[1]
    flags = page_quant[block_tables.long()].repeat_interleave(page_len, 1)
    quant = (flags != 0)[..., None, None]  # [B, T, 1, 1]
    out = []
    for full, q8, sc in ((k, k_quant, k_scale), (v, v_quant, v_scale)):
        deq = (gather_window(q8, block_tables).float()
               * gather_window(sc, block_tables)[..., None])
        out.append(torch.where(quant, deq,
                               gather_window(full, block_tables).float()))
    return tuple(out)


def flash_decode_attention_mixed_plain(q, k, v, lengths, scale, k_quant,
                                       v_quant, k_scale, v_scale,
                                       block_tables, page_quant
                                       ) -> torch.Tensor:
    """The mixed variant's plain version: the windows of ``gather_mixed``,
    then the contiguous arithmetic."""
    kf, vf = gather_mixed(k, v, k_quant, v_quant, k_scale, v_scale,
                          block_tables, page_quant)
    return flash_decode_attention_plain(q, kf, vf, lengths, scale)


def _check(kernel, q, k, v, lengths, kv_dtype, *scales) -> None:
    B, S, H, D = q.shape
    if k.shape != v.shape or k.dim() != 4 or k.shape[0] != B \
            or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"{kernel.name} shapes: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if any(tuple(t.shape) != tuple(k.shape[:3]) for t in scales):
        raise ValueError(f"{kernel.name}: scales must be "
                         f"{tuple(k.shape[:3])}; got "
                         f"{[tuple(t.shape) for t in scales]}")
    if tuple(lengths.shape) != (B,) or lengths.dtype != torch.int32:
        raise ValueError(f"lengths must be [{B}] int32; got "
                         f"{tuple(lengths.shape)} {lengths.dtype}")
    if not q.is_cuda or any(t.device != q.device
                            for t in (k, v, lengths, *scales)):
        raise ValueError(f"{kernel.name} kernel needs every operand on one "
                         f"CUDA device")
    if q.dtype != torch.bfloat16 or k.dtype != kv_dtype \
            or v.dtype != kv_dtype \
            or any(t.dtype != torch.float32 for t in scales):
        raise ValueError(f"{kernel.name} kernel takes bf16 q, {kv_dtype} "
                         f"k/v and fp32 scales; got {q.dtype}/{k.dtype}/"
                         f"{v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"{kernel.name} kernel takes head_dim in "
                         f"{HEAD_DIMS}; got {D}")
    if not all(t.is_contiguous() for t in (q, k, v, lengths, *scales)) \
            or any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{kernel.name} kernel needs contiguous operands, "
                         "q/k/v 16-byte aligned")


def _check_paged(kernel, q, k, v, lengths, block_tables, kv_dtype,
                 scales=(), quant=(), page_quant=None) -> None:
    """The paged variants' operands: pools [P, page_len, Hkv, D] (``quant``:
    the mixed variant's int8 pools, the same shape), scales
    [P, page_len, Hkv], tables [B, max_pages] and lengths [B] int32,
    ``page_quant`` [P] int32."""
    B, S, H, D = q.shape
    P, page_len = k.shape[0], k.shape[1]
    if k.dim() != 4 or any(t.shape != k.shape for t in (v, *quant)) \
            or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"{kernel.name} shapes: q {tuple(q.shape)}, pools "
                         f"{[tuple(t.shape) for t in (k, v, *quant)]}")
    if any(tuple(t.shape) != tuple(k.shape[:3]) for t in scales):
        raise ValueError(f"{kernel.name}: scales must be "
                         f"{tuple(k.shape[:3])}; got "
                         f"{[tuple(t.shape) for t in scales]}")
    if page_len < 8 or page_len & (page_len - 1):
        raise ValueError(f"{kernel.name}: page_len must be a power of two "
                         f">= 8; got {page_len}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or block_tables.dtype != torch.int32:
        raise ValueError(f"block_tables must be [{B}, max_pages] int32; got "
                         f"{tuple(block_tables.shape)} {block_tables.dtype}")
    if tuple(lengths.shape) != (B,) or lengths.dtype != torch.int32:
        raise ValueError(f"lengths must be [{B}] int32; got "
                         f"{tuple(lengths.shape)} {lengths.dtype}")
    if page_quant is not None and (tuple(page_quant.shape) != (P,)
                                   or page_quant.dtype != torch.int32):
        raise ValueError(f"page_quant must be [{P}] int32; got "
                         f"{tuple(page_quant.shape)} {page_quant.dtype}")
    extra = (*scales, *quant) + ((page_quant,) if page_quant is not None
                                 else ())
    ops = (q, k, v, block_tables, lengths, *extra)
    if not q.is_cuda or any(t.device != q.device for t in ops):
        raise ValueError(f"{kernel.name} kernel needs every operand on one "
                         f"CUDA device")
    if q.dtype != torch.bfloat16 or k.dtype != kv_dtype \
            or v.dtype != kv_dtype \
            or any(t.dtype != torch.int8 for t in quant) \
            or any(t.dtype != torch.float32 for t in scales):
        raise ValueError(f"{kernel.name} kernel takes bf16 q, {kv_dtype} "
                         f"pools, int8 side pools and fp32 scales; got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"{kernel.name} kernel takes head_dim in "
                         f"{HEAD_DIMS}; got {D}")
    if not all(t.is_contiguous() for t in ops) \
            or any(t.data_ptr() % 16 for t in (q, k, v, *quant)):
        raise ValueError(f"{kernel.name} kernel needs contiguous operands, "
                         "q and the pools 16-byte aligned")


def flash_decode_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, lengths: torch.Tensor,
                           scale: float, k_scale: torch.Tensor | None = None,
                           v_scale: torch.Tensor | None = None,
                           block_tables: torch.Tensor | None = None,
                           k_quant: torch.Tensor | None = None,
                           v_quant: torch.Tensor | None = None,
                           page_quant: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """See the module docstring. ``k_scale``/``v_scale`` select the int8
    variants (int8 ``k``/``v``); they come together or not at all.
    ``block_tables`` selects the paged layout; ``k_quant``/``v_quant`` and
    ``page_quant`` (with the scales of the int8 pool) the mixed pages."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be given together")
    paged = block_tables is not None
    mixed = k_quant is not None
    if mixed != (v_quant is not None):
        raise ValueError("k_quant and v_quant must be given together")
    if mixed and not paged:
        raise ValueError("mixed-precision pages (k_quant/v_quant) require "
                         "the paged layout (block_tables)")
    if mixed and (page_quant is None or k_scale is None):
        raise ValueError("mixed-precision pages need page_quant per-page "
                         "flags and k_scale/v_scale for the int8 pool")
    quantized = k_scale is not None and not mixed
    if (k.dtype == torch.int8) != quantized:
        raise ValueError(
            f"int8 cache blocks need per-row scales (and vice versa); got "
            f"k.dtype={k.dtype} with scales="
            f"{'set' if k_scale is not None else 'unset'}")
    if q.device.type == "cpu":
        if mixed:
            return flash_decode_attention_mixed_plain(
                q, k, v, lengths, scale, k_quant, v_quant, k_scale, v_scale,
                block_tables, page_quant)
        if paged and quantized:
            return flash_decode_attention_paged_int8_plain(
                q, k, v, lengths, scale, k_scale, v_scale, block_tables)
        if paged:
            return flash_decode_attention_paged_plain(q, k, v, lengths,
                                                      scale, block_tables)
        if quantized:
            return flash_decode_attention_int8_plain(q, k, v, lengths, scale,
                                                     k_scale, v_scale)
        return flash_decode_attention_plain(q, k, v, lengths, scale)
    if paged:
        return _launch_paged(q, k, v, lengths, scale, k_scale, v_scale,
                             block_tables, k_quant, v_quant, page_quant)
    B, S, H, D = q.shape
    if quantized:
        _check(KERNEL_INT8, q, k, v, lengths, torch.int8, k_scale, v_scale)
    else:
        _check(KERNEL, q, k, v, lengths, torch.bfloat16)
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    n_splits, _ = plan_for(q, k)
    ws = _workspace(q, n_splits)
    tail = (out.data_ptr(), ws.data_ptr(), _counters(q, k).data_ptr(),
            B, S, H, k.shape[2], k.shape[1], D, n_splits, float(scale),
            build.stream_of(q))
    if quantized:
        rc = build.library().picotron_flash_decode_int8(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr(), lengths.data_ptr(), *tail)
        build.check(rc, KERNEL_INT8)
        KERNEL_INT8.launches += 1
    else:
        rc = build.library().picotron_flash_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            *tail)
        build.check(rc, KERNEL)
        KERNEL.launches += 1
    return out


def _launch_paged(q, k, v, lengths, scale, k_scale, v_scale, block_tables,
                  k_quant, v_quant, page_quant) -> torch.Tensor:
    """One of the three paged kernels on CUDA tensors (checked first)."""
    B, S, H, D = q.shape
    mixed = k_quant is not None
    if mixed:
        kernel = KERNEL_MIXED
        _check_paged(kernel, q, k, v, lengths, block_tables, torch.bfloat16,
                     (k_scale, v_scale), (k_quant, v_quant), page_quant)
    elif k_scale is not None:
        kernel = KERNEL_PAGED_INT8
        _check_paged(kernel, q, k, v, lengths, block_tables, torch.int8,
                     (k_scale, v_scale))
    else:
        kernel = KERNEL_PAGED
        _check_paged(kernel, q, k, v, lengths, block_tables, torch.bfloat16)
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    n_splits, _ = plan_for(q, k, block_tables)
    ws = _workspace(q, n_splits)
    dims = (B, S, H, k.shape[2], k.shape[1], block_tables.shape[1], D,
            n_splits, float(scale), build.stream_of(q))
    tail = (block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            ws.data_ptr(), _counters(q, k).data_ptr())
    lib = build.library()
    if mixed:
        rc = lib.picotron_flash_decode_mixed(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), k_quant.data_ptr(),
            v_quant.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
            page_quant.data_ptr(), *tail, *dims)
    elif k_scale is not None:
        rc = lib.picotron_flash_decode_paged_int8(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr(), *tail, *dims)
    else:
        rc = lib.picotron_flash_decode_paged(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), *tail, *dims)
    build.check(rc, kernel)
    kernel.launches += 1
    return out
