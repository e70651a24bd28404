"""The PyTorch port's paged KV layout against the JAX package's, on the CPU.

- the host allocator (``PagedKV``): one scripted sequence of matches,
  growth, copy-on-writes, registrations, frees, evictions under pressure
  and an exhausted pool gives the same tables, refcounts, copy pairs and
  ``stats()`` in both, with the prefix cache on and off;
- the device ops: ``cache_write`` (decode and chunk shapes),
  ``insert_prefill`` and ``copy_page`` on fp32, int8 and ``hot_bf16``
  pools leave the same bytes as JAX's on the same inputs;
- the slice as a whole: the port's ``ContinuousBatcher`` serves a
  shared-prefix traffic (a system prompt under four requests, one prompt
  twice, three unrelated prompts) with greedy streams token-identical to
  the JAX batcher's (``attend_impl: "dense"``) and equal prefix hits,
  cached tokens and copy-on-writes, for uniform fp32, uniform int8 and
  ``hot_bf16`` pools; paged streams equal contiguous ones with the prefix
  cache on and off;
- the config's JAX validation messages, shedding a request that can never
  fit, and the generate CLI on the paged layout.

Weights are drawn once by the JAX package (a tiny fp32 model) and carried
across with ``convert.params_from_jax``.
"""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_config
from picotron_tpu.inference import ContinuousBatcher as JaxBatcher
from picotron_tpu.inference import InferenceEngine as JaxEngine
from picotron_tpu.inference import Request as JaxRequest
from picotron_tpu.inference import paged_kv as jax_paged
from picotron_tpu.models import llama as jax_llama
from picotron_tpu_torch import convert
from picotron_tpu_torch.config import Config
from picotron_tpu_torch.inference import kv_cache, paged_kv
from picotron_tpu_torch.inference.batcher import ContinuousBatcher, Request
from picotron_tpu_torch.inference.engine import InferenceEngine

MAX_LEN = 64
PAGE = 8
CHUNK = 16
BLOCK = 4
NEW = 8
SLOTS = 4
MODEL = dict(num_hidden_layers=2, num_attention_heads=8,
             num_key_value_heads=4, hidden_size=64, intermediate_size=128,
             vocab_size=256, max_position_embeddings=128,
             rope_theta=10000.0, dtype="float32", attention_impl="sdpa")
# cache storage per policy: (kv_cache_dtype, kv_page_policy)
POLICIES = {"uniform": ("auto", "uniform"), "int8": ("int8", "uniform"),
            "hot_bf16": ("auto", "hot_bf16")}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Six test workers share the machine: keep torch to one thread here,
    and restore the old count."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _traffic():
    """Shared-prefix traffic scaled down: a 20-token system prompt (it
    forks mid-page) under suffixes of 3, 6, 13 and 26 tokens (the last one
    chunked), the first prompt again, and three prompts of 25, 37 and 45
    tokens whose first tokens match no other prompt's."""
    rng = np.random.default_rng(5)
    system = rng.integers(1, 128, 20).tolist()
    prompts = [system + rng.integers(1, 256, n).tolist()
               for n in (3, 6, 13, 26)]
    prompts.append(list(prompts[0]))
    prompts += [rng.integers(128, 256, n).tolist() for n in (25, 37, 45)]
    assert len({p[0] for p in prompts[5:]} | {system[0]}) == 4
    return prompts


@pytest.fixture(scope="module")
def tiny():
    """(JAX config, JAX params, port params) for the tiny model."""
    jcfg = make_config(MODEL, seq=MAX_LEN)
    jparams = jax.jit(lambda k: jax_llama.init_params(k, jcfg.model))(
        jax.random.PRNGKey(0))
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, params


def _port_cfg(**inf) -> Config:
    return Config.from_dict({"model": MODEL, "inference": {
        "prefill_chunk": CHUNK, "decode_block_len": BLOCK, **inf}})


def _port_run(params, prompts, **inf):
    """Greedy streams and ``stats()`` of the port's batcher."""
    engine = InferenceEngine(_port_cfg(**inf), "cpu", slots=SLOTS,
                             max_seq_len=MAX_LEN)
    b = ContinuousBatcher(engine, params)
    res = b.run([Request(f"r{i}", p, max_new_tokens=NEW)
                 for i, p in enumerate(prompts)])
    return {u: r.tokens for u, r in res.items()}, b.stats()


# --------------------------------------------------------------------------- #
# the host allocator
# --------------------------------------------------------------------------- #


def _allocator_script(mod, prefix_cache):
    """One sequence through ``mod.PagedKV``; returns every observable after
    each step (tables, refcounts, free list, copy pairs, results, stats)."""
    p = mod.PagedKV(slots=3, page_len=4, max_pages=6, num_pages=14,
                    prefix_cache=prefix_cache)
    rng = np.random.default_rng(3)
    system = rng.integers(1, 50, 10).tolist()
    a, b = system + [60, 61, 62], system + [70, 71]
    trace = []

    def snap(tag, out=None):
        trace.append((tag, out, p.tables.tolist(), p.pool.refs.tolist(),
                      list(p.pool._free), p.host_len.tolist(),
                      p.future_need(), p.available_pages(), p.stats()))

    snap("match a", p.match_prefix(0, a))
    snap("ensure a", p.ensure_writable(0, 0, len(a)))
    p.set_len(0, len(a))
    p.register_prompt(0, a)
    p.priced[0] = p.pages_for(len(a) + 6)
    snap("register a")
    snap("peek b", p.peek_prefix(b))
    snap("match b", p.match_prefix(1, b))
    snap("ensure b (fork page)", p.ensure_writable(1, int(p.host_len[1]),
                                                   len(b)))
    p.set_len(1, len(b))
    p.register_prompt(1, b)
    snap("decode a (tail page)", p.ensure_writable(0, len(a), len(a) + 4))
    p.advance([4, 0, 0])
    snap("retry match into 2", p.match_prefix(2, a))
    snap("match a again into 2", p.match_prefix(2, a))
    snap("can admit 5", p.can_admit(5))
    p.free_slot(0)
    p.free_slot(2)
    snap("free 0, 2")
    c = rng.integers(100, 150, 20).tolist()
    snap("match c", p.match_prefix(0, c))
    snap("grow c (evicts)", p.ensure_writable(0, 0, 20))
    try:
        p.ensure_writable(2, 0, 24)
        out = "no raise"
    except mod.PagePoolExhausted as e:
        out = str(e)
    snap("exhausted", out)
    snap("quant flags", p.quant_flags().tolist())
    return trace


@pytest.mark.parametrize("prefix_cache", [True, False])
def test_allocator_matches_jax(prefix_cache):
    want = _allocator_script(jax_paged, prefix_cache)
    got = _allocator_script(paged_kv, prefix_cache)
    assert [t[0] for t in got] == [t[0] for t in want]
    for g, w in zip(got, want):
        assert g == w, g[0]
    stats = got[-1][-1]
    if prefix_cache:
        assert stats["prefix_hits"] >= 3 and stats["cow_copies"] >= 2
        assert stats["radix_evictions"] >= 1
    else:
        assert stats["prefix_hits"] == 0 and stats["cow_copies"] == 0
    assert got[-2][1].startswith("page pool exhausted")


def test_pool_refuses_double_free_and_the_null_page():
    pool = paged_kv.PagePool(3)
    pid = pool.alloc()
    assert pool.unref(pid) and pool.free_count == 2
    with pytest.raises(ValueError, match="double free"):
        pool.unref(pid)
    with pytest.raises(ValueError, match="resurrect"):
        pool.ref(pid)
    with pytest.raises(ValueError, match="NULL page"):
        pool.ref(paged_kv.NULL_PAGE)
    with pytest.raises(ValueError, match="num_pages must be >= 2"):
        paged_kv.PagePool(1)


# --------------------------------------------------------------------------- #
# the device ops
# --------------------------------------------------------------------------- #


def _pools(rng, policy):
    """(JAX cache, port cache) with the same random bytes: L 2, P 9 pages of
    4 rows, Hkv 2, D 8; three slots' tables (one NULL row) and lengths."""
    L, P, pl, H, D = 2, 9, 4, 2, 8
    m = make_config(dict(MODEL, num_hidden_layers=L, num_key_value_heads=H,
                         num_attention_heads=4, hidden_size=4 * D)).model
    jc = jax_paged.init_cache(m, 3, P, pl, 3, dtype=jnp.float32,
                              quantized=policy == "int8",
                              policy=policy == "hot_bf16")
    jc = dict(jc)
    for name, a in jc.items():
        if name in jax_paged.META_LEAVES:
            continue
        if a.dtype == jnp.int8:
            jc[name] = jnp.asarray(rng.integers(-127, 128, a.shape), jnp.int8)
        else:
            jc[name] = jnp.asarray(rng.standard_normal(a.shape), a.dtype)
    jc["block_tables"] = jnp.asarray([[3, 7, 1], [5, 0, 0], [0, 0, 0]],
                                     jnp.int32)
    if "page_quant" in jc:
        jc["page_quant"] = jnp.asarray(rng.integers(0, 2, P), jnp.int32)
    jc["lengths"] = jnp.asarray([9, 2, 0], jnp.int32)
    tc = {n: torch.from_numpy(np.array(a)) for n, a in jc.items()}
    return jc, tc


def _same(jc, tc, skip_null=False):
    for name, a in jc.items():
        want, got = np.asarray(a), tc[name].numpy()
        if skip_null and name not in jax_paged.META_LEAVES:
            # rows aimed at the NULL page may collide there; which write
            # wins is the scatter's choice in both frameworks
            want, got = want[:, 1:], got[:, 1:]
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("policy", list(POLICIES))
def test_device_ops_match_jax_bytes(policy):
    rng = np.random.default_rng(8)
    jc, tc = _pools(rng, policy)

    def layer(c, i, rows):
        lc = {n: a[i] for n, a in c.items()
              if n not in jax_paged.META_LEAVES}
        lc["block_tables"] = c["block_tables"][rows]
        if "page_quant" in c:
            lc["page_quant"] = c["page_quant"]
        return lc

    # decode (S = 1, three slots, one free) and a chunk (B = 1, S = 6
    # crossing a page edge, two rows past the window)
    for rows, pos, S in ((slice(None), [9, 2, 0], 1), (slice(0, 1), [8], 6)):
        B = len(pos)
        k_new = rng.standard_normal((B, S, 2, 8)).astype(np.float32)
        v_new = rng.standard_normal((B, S, 2, 8)).astype(np.float32)
        jl = jax_paged.cache_write(layer(jc, 1, rows), jnp.asarray(k_new),
                                   jnp.asarray(v_new),
                                   jnp.asarray(pos, jnp.int32))
        tl = layer(tc, 1, rows)
        assert kv_cache.cache_write(tl, torch.from_numpy(k_new),
                                    torch.from_numpy(v_new),
                                    torch.tensor(pos, dtype=torch.int32)) \
            is tl
        for name in jl:
            if name not in jax_paged.META_LEAVES:
                jc[name] = jc[name].at[1].set(jl[name])
        _same(jc, tc, skip_null=True)

    # a one-shot prefill of 7 rows (bucket 8) into slot 0's pages
    kv_shape = (2, 1, 8, 2, 8)
    names = [n for n in jc if n not in jax_paged.META_LEAVES]
    kv = {}
    for n in names:
        shp = kv_shape if jc[n].ndim == 5 else kv_shape[:-1]
        kv[n] = (rng.integers(-127, 128, shp).astype(np.int8)
                 if jc[n].dtype == jnp.int8
                 else rng.standard_normal(shp).astype(np.float32))
    jc = jax_paged.insert_prefill(jc, {n: jnp.asarray(a) for n, a in
                                       kv.items()}, 0, 7)
    paged_kv.insert_prefill(tc, {n: torch.from_numpy(a) for n, a in
                                 kv.items()}, 0, 7)
    _same(jc, tc, skip_null=True)
    jc = jax_paged.copy_page(jc, 3, 8)
    paged_kv.copy_page(tc, 3, 8)
    _same(jc, tc, skip_null=True)
    np.testing.assert_array_equal(
        paged_kv.slot_rows(tc, np.asarray(tc["block_tables"]), 0, 7),
        jax_paged.slot_rows(jc, np.asarray(jc["block_tables"]), 0, 7))
    assert all(bool(torch.isfinite(t.float()).all()) for t in tc.values())


def test_init_cache_is_zeroed_with_the_jax_shapes():
    m = Config.from_dict({"model": MODEL}).model
    for policy, (kvd, pp) in POLICIES.items():
        jc = jax_paged.init_cache(
            make_config(MODEL).model, 3, 7, 8, 4, dtype=jnp.float32,
            quantized=kvd == "int8", policy=pp == "hot_bf16")
        tc = paged_kv.init_cache(m, 3, 7, 8, 4, dtype=torch.float32,
                                 quantized=kvd == "int8",
                                 policy=pp == "hot_bf16")
        assert set(tc) == set(jc), policy
        for name, a in jc.items():
            assert tuple(tc[name].shape) == a.shape, (policy, name)
            assert str(tc[name].dtype).removeprefix("torch.") == \
                str(a.dtype), (policy, name)
            assert not tc[name].any(), (policy, name)
        assert paged_kv.is_policy(tc) == (pp == "hot_bf16")
    assert kv_cache.cache_bytes(tc) == sum(
        a.size * a.dtype.itemsize for a in jc.values())


# --------------------------------------------------------------------------- #
# the slice: engine + batcher against the JAX batcher
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def jax_streams(tiny):
    """The JAX batcher's greedy streams and stats on the shared-prefix
    traffic, per policy ("dense" attend: the jitted reference)."""
    jcfg, jparams, _ = tiny
    out = {}
    for policy, (kvd, pp) in POLICIES.items():
        engine = JaxEngine(jcfg, slots=SLOTS, max_seq_len=MAX_LEN,
                           prefill_chunk=CHUNK, decode_block_len=BLOCK,
                           attend_impl="dense", kv_layout="paged",
                           kv_page_len=PAGE, kv_page_policy=pp,
                           cache_dtype="int8" if kvd == "int8" else None)
        b = JaxBatcher(engine, engine.shard_params(jparams))
        res = b.run([JaxRequest(f"r{i}", p, max_new_tokens=NEW)
                     for i, p in enumerate(_traffic())])
        out[policy] = ({u: r.tokens for u, r in res.items()}, b.stats())
    return out


@pytest.mark.parametrize("attend", ["dense", "flash"])
@pytest.mark.parametrize("policy", list(POLICIES))
def test_batcher_paged_streams_match_jax(tiny, jax_streams, policy, attend):
    """Token-identical greedy streams and equal prefix counters. "flash"
    runs C's paged variants' plain versions, as a CPU tensor does."""
    _, _, params = tiny
    kvd, pp = POLICIES[policy]
    want, wstats = jax_streams[policy]
    got, stats = _port_run(params, _traffic(), attend_impl=attend,
                           kv_layout="paged", kv_page_len=PAGE,
                           kv_cache_dtype=kvd, kv_page_policy=pp)
    assert got == want
    for key in ("prefix_queries", "prefix_hits", "prefix_cached_tokens",
                "cow_copies", "kv_pages_live", "kv_pages_shared",
                "kv_pages_quant", "kv_pages_total", "radix_evictions"):
        assert stats[key] == wstats[key], key
    # four hits: three on the system prompt, one on the repeated prompt
    # (capped one token short of its end)
    assert stats["prefix_hits"] == 4
    assert stats["prefix_cached_tokens"] == 3 * 20 + 22
    assert stats["cow_copies"] >= 4


@pytest.mark.parametrize("prefix_cache", [True, False])
def test_paged_streams_equal_contiguous(tiny, prefix_cache):
    _, _, params = tiny
    want, _ = _port_run(params, _traffic(), attend_impl="flash")
    got, stats = _port_run(params, _traffic(), attend_impl="flash",
                           kv_layout="paged", kv_page_len=PAGE,
                           prefix_cache=prefix_cache)
    assert got == want
    assert stats["prefix_hits"] == (4 if prefix_cache else 0)
    assert stats["kv_layout"] == "paged"


def test_prefill_paged_shares_the_prefix_and_its_bytes(tiny):
    """A prefix hit takes chunk dispatches over the suffix only, shares
    the cached pages (refcount > 1) and parks the same rows a miss would
    have computed."""
    _, _, params = tiny
    engine = InferenceEngine(
        _port_cfg(attend_impl="flash", kv_layout="paged", kv_page_len=PAGE),
        "cpu", slots=2, max_seq_len=MAX_LEN)
    prompts = _traffic()
    cache = engine.init_cache()
    cache, want, n0, c0 = engine.prefill_paged(params, cache, prompts[3], 0)
    assert (n0, c0) == (3, 0)  # 46 tokens: three chunks of 16
    cache, got, n1, c1 = engine.prefill_paged(params, cache, prompts[3], 1)
    assert (n1, c1) == (1, 45)  # the last token only
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    p = engine.paged
    assert p.tables[0, :5].tolist() == p.tables[1, :5].tolist()
    assert p.tables[0, 5] != p.tables[1, 5]  # the tail page was copied
    assert all(p.pool.refs[pid] >= 3 for pid in p.tables[1, :5])
    rows0 = paged_kv.slot_rows(cache, p.tables, 0, 46)
    rows1 = paged_kv.slot_rows(cache, p.tables, 1, 46)
    np.testing.assert_allclose(rows1, rows0, rtol=2e-4, atol=2e-4)


# --------------------------------------------------------------------------- #
# config, admission, CLI
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("raw,match", [
    ({"kv_layout": "ring"}, r"unknown inference.kv_layout 'ring' "
                            r"\(contiguous\|paged\)"),
    ({"kv_page_len": 12}, "kv_page_len must be a power of two >= 8, got 12"),
    ({"kv_page_len": 4}, "kv_page_len must be a power of two >= 8, got 4"),
    ({"kv_num_pages": -1}, "kv_num_pages must be >= 0"),
    ({"kv_page_policy": "cold"}, r"unknown inference.kv_page_policy 'cold'"),
    ({"kv_page_policy": "hot_bf16"}, "'hot_bf16' requires the paged KV "
                                     "layout"),
    ({"kv_layout": "paged", "kv_page_policy": "hot_bf16",
      "kv_cache_dtype": "int8"}, "mutually exclusive with kv_cache_dtype"),
])
def test_config_validation_matches_jax(raw, match):
    from picotron_tpu.config import Config as JaxConfig

    with pytest.raises(ValueError, match=match) as port:
        Config.from_dict({"inference": raw})
    with pytest.raises(ValueError) as ref:
        JaxConfig.from_dict({"inference": raw})
    assert str(port.value) == str(ref.value)


def test_engine_validates_the_layout_and_sizes_the_pool():
    with pytest.raises(ValueError, match="requires the paged KV layout"):
        _port_cfg(kv_page_policy="hot_bf16")
    with pytest.raises(ValueError, match="power of two >= 8, got 24"):
        _port_cfg(kv_layout="paged", kv_page_len=24)
    # the cache_dtype override is the one way an int8 cache meets hot_bf16
    with pytest.raises(ValueError, match="mutually exclusive with an int8"):
        InferenceEngine(_port_cfg(kv_layout="paged",
                                  kv_page_policy="hot_bf16"), "cpu",
                        cache_dtype="int8")
    e = InferenceEngine(_port_cfg(kv_layout="paged", kv_page_len=8), "cpu",
                        slots=3, max_seq_len=60)
    assert (e.max_pages, e.num_pages) == (8, 1 + 3 * 8)
    assert e.paged is not None and e.kv_page_policy == "uniform"
    e = InferenceEngine(_port_cfg(kv_layout="paged", kv_page_len=8,
                                  kv_num_pages=11), "cpu", slots=3,
                        max_seq_len=60)
    assert e.num_pages == 11 == e.paged.pool.num_pages
    with pytest.raises(ValueError, match="kv_num_pages must be >= 2"):
        InferenceEngine(_port_cfg(kv_layout="paged", kv_num_pages=1), "cpu")
    assert InferenceEngine(_port_cfg(), "cpu").paged is None
    with pytest.raises(ValueError, match="needs kv_layout='paged'"):
        InferenceEngine(_port_cfg(), "cpu").prefill_paged(None, None, [1], 0)


def test_out_of_pages_sheds_and_spares_live_slots(tiny):
    """A pool of five usable pages: a request that could never fit sheds
    at the door, a waiting one is admitted after the live one returns its
    pages, and the live stream is the contiguous engine's."""
    _, _, params = tiny
    reqs = [Request("a", list(range(1, 9)), max_new_tokens=8),
            Request("big", list(range(1, 33)), max_new_tokens=64),
            Request("b", [41, 42, 43], max_new_tokens=8)]
    want = ContinuousBatcher(
        InferenceEngine(_port_cfg(), "cpu", slots=2, max_seq_len=MAX_LEN),
        params).run([Request("a", list(range(1, 9)), max_new_tokens=8)])
    engine = InferenceEngine(
        _port_cfg(kv_layout="paged", kv_page_len=PAGE, kv_num_pages=6),
        "cpu", slots=2, max_seq_len=MAX_LEN)
    b = ContinuousBatcher(engine, params)
    assert b.page_commitment(reqs[1]) == 8 > engine.paged.usable_pages
    assert b.page_load() == 0
    res = b.run(reqs)
    assert res["big"].finish_reason == "shed" and res["big"].tokens == []
    assert res["a"].finish_reason == "length"
    assert res["a"].tokens == want["a"].tokens
    assert res["b"].finish_reason == "length" and len(res["b"].tokens) == 8
    assert [r.finish_reason for r in res.values()].count("shed") == 1


def test_generate_cli_serves_paged_hot_bf16_on_the_cpu(tmp_path, capsys):
    from picotron_tpu_torch.tools import generate

    path = tmp_path / "tiny.json"
    path.write_text(json.dumps({
        "model": {"num_hidden_layers": 2, "num_attention_heads": 4,
                  "num_key_value_heads": 2, "hidden_size": 32,
                  "intermediate_size": 64, "vocab_size": 64,
                  "max_position_embeddings": 64, "dtype": "float32"},
        "inference": {"attend_impl": "flash", "prefill_chunk": 8,
                      "kv_page_len": 8},
        "training": {"seq_length": 64}}))
    shared = ",".join(str(i % 60 + 1) for i in range(13))
    rc = generate.main(["--config", str(path), "--random-init",
                        "--prompt-ids", shared, "--prompt-ids",
                        shared + ",7,8", "--max-new-tokens", "5",
                        "--slots", "2", "--decode-block-len", "2",
                        "--kv-layout", "paged",
                        "--kv-page-policy", "hot_bf16"], device="cpu")
    out = capsys.readouterr().out
    assert rc == 0, out
    assert re.search(r"^10 tokens in .*kv=float32, weights=bf16, ", out,
                     re.M), out
    m = re.search(r"^paged kv: page_len=8, policy=hot_bf16, pages live "
                  r"\d+/\d+ \(shared \d+, int8-read \d+\), prefix hits "
                  r"(\d+)/2, cached tokens (\d+), cow copies \d+, "
                  r"evictions 0$", out, re.M)
    assert m and m.groups() == ("1", "13"), out
    with pytest.raises(ValueError, match="requires the paged KV layout"):
        generate.main(["--config", str(path), "--random-init",
                       "--prompt-ids", "1,2", "--kv-page-policy",
                       "hot_bf16"], device="cpu")
