"""Kernel C's paged variants (paged, paged int8, hot_bf16 mixed pages):
their plain versions against the Pallas kernel in interpret mode, on the
CPU, and the wrapper's refusal to fall back.

Each plain version is held against
``picotron_tpu.ops.pallas.decode_attention.flash_decode_attention`` with
``block_tables`` (and ``k_scale``/``v_scale``, or ``k_quant``/``v_quant``/
``block_quant``) at atol 1e-5 in fp32, at decode (S = 1) and chunk
(S = 16) shapes, page lengths 8 and 16, MHA and GQA, over a table whose
slots share pages and end in NULL entries, with lengths from 0 to the
window's edge. The CUDA kernels themselves run only on the card
(``chip_smoke.py``).

Every variant's kernel splits its walk over the window (``split_plan``)
and merges the splits' partials in split order; the plain model of that
arithmetic (``flash_decode_attention_split_plain``) is held here to the
plain version at lengths that leave whole splits empty, and the plan to
the shapes alone: the same for a contiguous and a paged window. Chunk rows
(S x g > 16) run on the card's tensor cores; the plain model of that
arithmetic (``flash_decode_attention_mma_plain``: bf16 products summed in
fp32, the K scale on the score, p x V scale split into bf16 hi and lo) is
held to the plain version, contiguous and int8, and to the Pallas kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picotron_tpu.inference import kv_cache as jax_kv
from picotron_tpu.ops.pallas.decode_attention import (
    flash_decode_attention as jax_flash_decode,
)
from picotron_tpu_torch.inference import kv_cache
from picotron_tpu_torch.ops.kernels import decode_attention as kc

MAX_PAGES = 4
NH, D = 8, 16


@pytest.fixture(autouse=True)
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _tables(rng, B, page_len, lengths):
    """Block tables over a shuffled pool: every slot's live pages, slot 1
    sharing slot 0's first page (a common prefix), NULL entries past each
    slot's pages. Returns (tables [B, MAX_PAGES] int32, pool page count)."""
    n = sum(-(-L // page_len) for L in lengths)
    ids = (rng.permutation(n) + 1).tolist()
    tables = np.zeros((B, MAX_PAGES), np.int32)
    for b, L in enumerate(lengths):
        for j in range(-(-L // page_len)):
            tables[b, j] = ids.pop()
    if B > 1 and lengths[0] and lengths[1]:
        tables[1, 0] = tables[0, 0]
    return tables, n + 1


@pytest.mark.parametrize("variant", ["paged", "paged_int8", "mixed"])
@pytest.mark.parametrize("nkv", [8, 2])
@pytest.mark.parametrize("page_len", [8, 16])
@pytest.mark.parametrize("S", [1, 16])
def test_paged_plain_matches_pallas(variant, nkv, page_len, S):
    rng = np.random.default_rng(40 + S + page_len + nkv)
    T = MAX_PAGES * page_len
    if S == 1:  # decode: an empty slot, the window's edge, partial pages
        lengths = [0, T, 5, page_len + 3]
    else:  # a chunk resuming over a shared prefix, and the full window
        lengths = [page_len + S - 3, T]
    B = len(lengths)
    tables, P = _tables(rng, B, page_len, lengths)
    q = _rand(rng, B, S, NH, D)
    k, v = _rand(rng, P, page_len, nkv, D), _rand(rng, P, page_len, nkv, D)
    kq, ks = jax_kv.quantize_kv(jnp.asarray(_rand(rng, P, page_len, nkv, D)))
    vq, vs = jax_kv.quantize_kv(jnp.asarray(_rand(rng, P, page_len, nkv, D)))
    page_quant = rng.integers(0, 2, P).astype(np.int32)
    lens = np.asarray(lengths, np.int32)
    scale = D ** -0.5
    t = {name: torch.from_numpy(np.array(a)) for name, a in dict(
        q=q, k=k, v=v, kq=kq, vq=vq, ks=ks, vs=vs, bt=tables, pq=page_quant,
        lengths=lens).items()}
    common = (jnp.asarray(q),)
    if variant == "paged":
        want = jax_flash_decode(*common, jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(lens), scale,
                                block_tables=jnp.asarray(tables),
                                interpret=True)
        got = kc.flash_decode_attention(t["q"], t["k"], t["v"],
                                        t["lengths"], scale,
                                        block_tables=t["bt"])
        plain = kc.flash_decode_attention_paged_plain(
            t["q"], t["k"], t["v"], t["lengths"], scale, t["bt"])
    elif variant == "paged_int8":
        want = jax_flash_decode(*common, kq, vq, jnp.asarray(lens), scale,
                                k_scale=ks, v_scale=vs,
                                block_tables=jnp.asarray(tables),
                                interpret=True)
        got = kc.flash_decode_attention(t["q"], t["kq"], t["vq"],
                                        t["lengths"], scale, t["ks"],
                                        t["vs"], block_tables=t["bt"])
        plain = kc.flash_decode_attention_paged_int8_plain(
            t["q"], t["kq"], t["vq"], t["lengths"], scale, t["ks"], t["vs"],
            t["bt"])
    else:
        want = jax_flash_decode(
            *common, jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
            scale, k_scale=ks, v_scale=vs, k_quant=kq, v_quant=vq,
            block_quant=jnp.asarray(page_quant[tables]),
            block_tables=jnp.asarray(tables), interpret=True)
        got = kc.flash_decode_attention(
            t["q"], t["k"], t["v"], t["lengths"], scale, t["ks"], t["vs"],
            block_tables=t["bt"], k_quant=t["kq"], v_quant=t["vq"],
            page_quant=t["pq"])
        plain = kc.flash_decode_attention_mixed_plain(
            t["q"], t["k"], t["v"], t["lengths"], scale, t["kq"], t["vq"],
            t["ks"], t["vs"], t["bt"], t["pq"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
    visible = (lens[:, None] - S + np.arange(S)[None, :]) >= 0
    assert not got.numpy()[~visible].any()  # rows that see no key: zeros


def test_paged_plain_is_the_contiguous_plain_over_gathered_rows():
    """On a shuffled table the paged variants compute exactly what the
    contiguous variants compute over the gathered window; mixed pages with
    every flag 0 are the paged variant, with every flag 1 the paged int8
    one (the identities the card checks bit for bit)."""
    rng = np.random.default_rng(9)
    B, S, page_len, nkv = 3, 1, 8, 2
    lengths = [7, 32, 17]
    tables, P = _tables(rng, B, page_len, lengths)
    q = torch.from_numpy(_rand(rng, B, S, NH, D))
    k = torch.from_numpy(_rand(rng, P, page_len, nkv, D))
    v = torch.from_numpy(_rand(rng, P, page_len, nkv, D))
    kq, ks = kv_cache.quantize_kv(torch.from_numpy(_rand(rng, P, page_len,
                                                         nkv, D)))
    vq, vs = kv_cache.quantize_kv(torch.from_numpy(_rand(rng, P, page_len,
                                                         nkv, D)))
    bt = torch.from_numpy(tables)
    lens = torch.tensor(lengths, dtype=torch.int32)
    scale = D ** -0.5
    paged = kc.flash_decode_attention(q, k, v, lens, scale, block_tables=bt)
    contiguous = kc.flash_decode_attention(
        q, kc.gather_window(k, bt), kc.gather_window(v, bt), lens, scale)
    assert torch.equal(paged, contiguous)
    paged8 = kc.flash_decode_attention(q, kq, vq, lens, scale, ks, vs,
                                       block_tables=bt)
    contiguous8 = kc.flash_decode_attention(
        q, kc.gather_window(kq, bt), kc.gather_window(vq, bt), lens, scale,
        kc.gather_window(ks, bt), kc.gather_window(vs, bt))
    assert torch.equal(paged8, contiguous8)
    for flag, want in ((0, paged), (1, paged8)):
        pq = torch.full((P,), flag, dtype=torch.int32)
        mixed = kc.flash_decode_attention(q, k, v, lens, scale, ks, vs,
                                          block_tables=bt, k_quant=kq,
                                          v_quant=vq, page_quant=pq)
        assert torch.equal(mixed, want), flag


def test_paged_wrapper_validates_and_never_falls_back(monkeypatch):
    """Bad argument sets are refused; a tensor that is not on the CPU
    launches a paged kernel or raises, never a plain version."""
    q = torch.zeros(1, 1, 4, 64)
    pool = torch.zeros(3, 8, 2, 64)
    lens = torch.zeros(1, dtype=torch.int32)
    bt = torch.zeros(1, 2, dtype=torch.int32)
    sc = torch.zeros(3, 8, 2)
    with pytest.raises(ValueError, match="require the paged layout"):
        kc.flash_decode_attention(q, pool, pool, lens, 0.1, sc, sc,
                                  k_quant=pool, v_quant=pool)
    with pytest.raises(ValueError, match="given together"):
        kc.flash_decode_attention(q, pool, pool, lens, 0.1, block_tables=bt,
                                  k_quant=pool)
    with pytest.raises(ValueError, match="need page_quant"):
        kc.flash_decode_attention(q, pool, pool, lens, 0.1, sc, sc,
                                  block_tables=bt, k_quant=pool,
                                  v_quant=pool)

    def boom(*a, **k):
        raise AssertionError("plain version called for a non-CPU tensor")

    for name in ("flash_decode_attention_paged_plain",
                 "flash_decode_attention_paged_int8_plain",
                 "flash_decode_attention_mixed_plain"):
        monkeypatch.setattr(kc, name, boom)

    def meta(shape, dtype=torch.bfloat16):
        return torch.empty(shape, device="meta", dtype=dtype)

    mq, mlen = meta((1, 1, 4, 64)), meta((1,), torch.int32)
    mbt = meta((1, 2), torch.int32)
    pool16, pool8 = meta((3, 8, 2, 64)), meta((3, 8, 2, 64), torch.int8)
    msc, mpq = meta((3, 8, 2), torch.float32), meta((3,), torch.int32)
    for args, kw in (((pool16, pool16), {}),
                     ((pool8, pool8, mlen, 0.1, msc, msc), {}),
                     ((pool16, pool16, mlen, 0.1, msc, msc),
                      {"k_quant": pool8, "v_quant": pool8,
                       "page_quant": mpq})):
        if len(args) == 2:
            args = args + (mlen, 0.1)
        with pytest.raises(ValueError, match="CUDA"):
            kc.flash_decode_attention(mq, *args, block_tables=mbt, **kw)
    # a page length the kernels do not take is refused before the device
    # check
    with pytest.raises(ValueError, match="power of two >= 8"):
        kc.flash_decode_attention(mq, meta((3, 12, 2, 64)),
                                  meta((3, 12, 2, 64)), mlen, 0.1,
                                  block_tables=mbt)


# lengths that leave whole 128-key splits empty (0, 1), end at a tile's
# edge (127, 128, 129) and fill the window
SPLIT_T = 640


@pytest.mark.parametrize("S, nh, nkv", [(1, 4, 4), (1, 8, 2), (512, 4, 4)])
def test_split_model_matches_plain(S, nh, nkv):
    """The split walk's arithmetic (ranges of whole tiles, per-split fp32
    partials, the merge in split order) equals the plain version at decode
    (S = 1, MHA and GQA) and at a 512-row chunk, at 1e-5 in fp32 (the two
    sum in different orders), with rows that see no key exactly zero."""
    rng = np.random.default_rng(S + nh + nkv)
    lengths = [0, 1, 127, 128, 129, SPLIT_T]
    B = len(lengths)
    q = torch.from_numpy(_rand(rng, B, S, nh, D))
    k = torch.from_numpy(_rand(rng, B, SPLIT_T, nkv, D))
    v = torch.from_numpy(_rand(rng, B, SPLIT_T, nkv, D))
    lens = torch.tensor(lengths, dtype=torch.int32)
    n_splits, per = kc.plan_for(q, k)
    assert n_splits > 1 and (n_splits - 1) * per * 128 < SPLIT_T
    got = kc.flash_decode_attention_split_plain(q, k, v, lens, D ** -0.5)
    want = kc.flash_decode_attention_plain(q, k, v, lens, D ** -0.5)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    visible = (np.asarray(lengths)[:, None] - S + np.arange(S)[None]) >= 0
    assert not got.numpy()[~visible].any()


@pytest.mark.parametrize("page_len", [8, 16, 128])
@pytest.mark.parametrize("max_pages", [1, 16, 64, 256])
@pytest.mark.parametrize("S", [1, 16, 512])
def test_split_plan_is_the_same_contiguous_and_paged(page_len, max_pages,
                                                     S):
    """A contiguous window of T keys and a paged window of max_pages x
    page_len = T keys get one plan (what keeps each paged variant bit for
    bit its contiguous twin), a function of shapes alone that covers the
    window with at most 8 tiles a split: one tile a split at decode up to
    32 splits, at least two for a chunk, at most 8 splits."""
    T = max_pages * page_len
    q = torch.empty(2, S, 8, 64, device="meta")
    contiguous = kc.plan_for(q, torch.empty(2, T, 2, 64, device="meta"))
    paged = kc.plan_for(q, torch.empty(5, page_len, 2, 64, device="meta"),
                        torch.empty(2, max_pages, device="meta",
                                    dtype=torch.int32))
    assert contiguous == paged == kc.split_plan(T, S * 4)
    n_splits, per = contiguous
    tiles = -(-T // 128)
    assert (n_splits - 1) * per < tiles <= n_splits * per
    assert 1 <= per <= kc.MAX_SPLIT_TILES
    if S * 4 <= kc.SMALL_ROWS:  # decode: one tile a split up to 32
        assert (per == 1) == (tiles <= 32)
    else:  # chunks: two tiles a split or more, at most 8 splits
        assert per >= min(2, tiles)
        assert n_splits <= 8 or tiles > 8 * kc.MAX_SPLIT_TILES


def _bf16_values(rng, *shape):
    """fp32 tensors holding bf16 values: what the card's kernels take,
    in the precision the CPU checks compare in."""
    return torch.from_numpy(_rand(rng, *shape)).to(torch.bfloat16).float()


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("S, nh, nkv", [(512, 4, 4), (512, 8, 2),
                                        (100, 4, 4), (40, 8, 2)])
def test_mma_model_matches_plain(S, nh, nkv, int8):
    """The tensor-core model of chunk rows (bf16 q . K summed in fp32, the K
    scale on the score, p x V scale as bf16 hi + lo, 64-key steps, the
    merge in split order) against the plain version on the same bf16
    inputs, at 2e-5 in fp32: the plain version sums in another order
    (1e-5, as above) and hi + lo holds p x v_scale to about 2^-17 of its
    size. S x g of 512 and 2048 rows (MHA, GQA) and ragged 100 and 160
    (no multiple of 64), over lengths that leave whole splits empty; rows
    that see no key are exactly 0."""
    rng = np.random.default_rng(S + nh + nkv + int8)
    lengths = [0, 1, 129, SPLIT_T]
    B = len(lengths)
    q = _bf16_values(rng, B, S, nh, D)
    lens = torch.tensor(lengths, dtype=torch.int32)
    n_splits, _ = kc.plan_for(q, torch.empty(B, SPLIT_T, nkv, D))
    assert n_splits > 1 and S * (nh // nkv) > kc.SMALL_ROWS
    if int8:
        k, ks = kv_cache.quantize_kv(_bf16_values(rng, B, SPLIT_T, nkv, D))
        v, vs = kv_cache.quantize_kv(_bf16_values(rng, B, SPLIT_T, nkv, D))
        got = kc.flash_decode_attention_mma_plain(q, k, v, lens, D ** -0.5,
                                                  ks, vs)
        want = kc.flash_decode_attention_int8_plain(q, k, v, lens,
                                                    D ** -0.5, ks, vs)
    else:
        k = _bf16_values(rng, B, SPLIT_T, nkv, D)
        v = _bf16_values(rng, B, SPLIT_T, nkv, D)
        got = kc.flash_decode_attention_mma_plain(q, k, v, lens, D ** -0.5)
        want = kc.flash_decode_attention_plain(q, k, v, lens, D ** -0.5)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    visible = (np.asarray(lengths)[:, None] - S + np.arange(S)[None]) >= 0
    assert not got.numpy()[~visible].any()


def test_mma_model_matches_pallas():
    """The tensor-core model against the Pallas kernel in interpret mode
    (fp32 arithmetic) on the same bf16-valued inputs, int8 K/V, a ragged
    GQA chunk (S 40, g 4: 160 rows), at 2e-5."""
    rng = np.random.default_rng(77)
    S, nh, nkv = 40, 8, 2
    lengths = np.array([0, 57, 300, SPLIT_T], np.int32)
    B = len(lengths)
    q = _bf16_values(rng, B, S, nh, D)
    k, ks = kv_cache.quantize_kv(_bf16_values(rng, B, SPLIT_T, nkv, D))
    v, vs = kv_cache.quantize_kv(_bf16_values(rng, B, SPLIT_T, nkv, D))
    scale = D ** -0.5
    want = np.asarray(jax_flash_decode(
        jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
        jnp.asarray(v.numpy()), jnp.asarray(lengths), scale,
        k_scale=jnp.asarray(ks.numpy()), v_scale=jnp.asarray(vs.numpy()),
        block_t=128, interpret=True))
    got = kc.flash_decode_attention_mma_plain(
        q, k, v, torch.from_numpy(lengths), scale, ks, vs)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
