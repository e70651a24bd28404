"""The port's prefill/decode disaggregation against the JAX package's, on
the CPU: the KV page transport (``inference/page_transport.py``), the
radix cache's import half, the batcher's handoff seat, ``migrate_slot``,
``inference.role`` and the serve front end's ``/kv`` plane.

- the spec: ``transport_spec`` equals the JAX one, keys and leaf order
  (the CRC's order), for fp32, bf16, int8 and ``hot_bf16`` pools;
- the wire: a JAX payload imports into the port and the port's re-export
  is the JAX payload field for field (pages, ``crc32``, ``bytes_total``,
  ``token_ids``, ``first_token``); a port payload imports into a JAX
  batcher, whose re-export is the port payload;
- rejections: the same ``TransportError`` messages as the JAX package for
  the contiguous layout, the version, ``page_len``, a leaf dtype, the
  policy, the CRC, the page count, bad base64 and a short leaf, with the
  pool untouched; a write that raises and an exhausted pool leave the
  pool and its refcounts as before, a retry lands, a re-import
  allocates nothing;
- the radix cache's ``plan_adopt``, ``adopt`` and ``cached_prefixes`` and
  ``PagedKV``'s import half against the JAX ones over seeded random
  operation sequences;
- seating: a handoff seats with no prefill dispatch and gives the
  colocated tokens in decode blocks, in a verify (``spec_len`` 2), after a
  chunked prefill on the export side and with int8 KV, and the JAX
  handoff's tokens greedy and sampled; a remote hit equals a local one, a
  partial payload is a hint, a corrupt one self-prefills;
- ``migrate_slot`` against the JAX one (tables, refcounts, bytes), and a
  moved slot's stream equal to the unmoved one;
- the transport with ``ml_dtypes`` hidden (``sys.modules``);
- two port servers (``role`` prefill and decode) against a role-``both``
  one: the same streams, the role 503s, ``/kv/pages``, ``/kv/import``,
  ``/kv/prefixes``, an unusable ``"kv"`` dropped and counted, ``/metrics``
  agreeing with ``/statz``;
- ``inference.role`` validated with the JAX package's messages.

Weights are drawn once by the JAX package (a tiny fp32 model) and carried
across with ``convert.params_from_jax``. The model has 2 layers, hidden
64, 8/4 heads, 8-row pages; the prompt is 18 tokens: two pages and a
partial tail.
"""

import base64
import copy
import http.client
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from conftest import make_config
from picotron_tpu.config import Config as JaxConfig
from picotron_tpu.inference import ContinuousBatcher as JaxBatcher
from picotron_tpu.inference import InferenceEngine as JaxEngine
from picotron_tpu.inference import Request as JaxRequest
from picotron_tpu.inference import page_transport as jax_transport
from picotron_tpu.inference import paged_kv as jax_paged
from picotron_tpu.models import llama as jax_llama
from picotron_tpu_torch import convert
from picotron_tpu_torch.config import Config
from picotron_tpu_torch.inference import page_transport, paged_kv
from picotron_tpu_torch.inference.batcher import ContinuousBatcher, Request
from picotron_tpu_torch.inference.engine import InferenceEngine
from picotron_tpu_torch.inference.page_transport import TransportError
from picotron_tpu_torch.inference.paged_kv import PagePoolExhausted
from picotron_tpu_torch.obs import parse_prometheus
from picotron_tpu_torch.tools import serve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_LEN = 64
PAGE = 8
MODEL = dict(num_hidden_layers=2, num_attention_heads=8,
             num_key_value_heads=4, hidden_size=64, intermediate_size=128,
             vocab_size=256, max_position_embeddings=MAX_LEN,
             rope_theta=10000.0, dtype="float32", attention_impl="sdpa")
# 18 tokens: two full pages and a partial tail
PROMPT = list(range(1, 19))
NEW = 8
WAIT_S = 60.0
# storage variant -> (the port's cache_dtype and kv_page_policy, the JAX
# engine's keywords)
VARIANTS = {
    "fp32": ({}, {}),
    "bf16": ({"cache_dtype": torch.bfloat16}, {"cache_dtype": "bfloat16"}),
    "int8": ({"cache_dtype": "int8"}, {"cache_dtype": "int8"}),
    "hot_bf16": ({"kv_page_policy": "hot_bf16"},
                 {"kv_page_policy": "hot_bf16"}),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def tiny():
    """(JAX params, port params) of the tiny model."""
    jcfg = make_config(MODEL, seq=32)
    jparams = jax.jit(lambda k: jax_llama.init_params(k, jcfg.model))(
        jax.random.PRNGKey(0))
    return jparams, convert.params_from_jax(
        jax.tree.map(np.asarray, jparams))


def _port(variant="fp32", slots=2, **kw):
    """A port engine on the paged layout. ``kv_page_policy``,
    ``kv_num_pages``, ``kv_page_len`` and ``role`` go to the config, the
    rest to the engine."""
    inf = {"kv_layout": "paged", "kv_page_len": PAGE}
    eng_kw = dict(VARIANTS[variant][0])
    for key in ("kv_page_policy", "kv_num_pages", "kv_page_len", "role"):
        if key in eng_kw:
            inf[key] = eng_kw.pop(key)
        if key in kw:
            inf[key] = kw.pop(key)
    cfg = Config.from_dict({"model": MODEL, "inference": inf})
    return InferenceEngine(cfg, "cpu", slots=slots, max_seq_len=MAX_LEN,
                           **eng_kw, **kw)


def _jax(variant="fp32", slots=2, **kw):
    kw = {"kv_page_len": PAGE, **VARIANTS[variant][1], **kw}
    return JaxEngine(make_config(MODEL, seq=32), slots=slots,
                     max_seq_len=MAX_LEN, kv_layout="paged", **kw)


def _jax_batcher(tiny, variant="fp32", seed=0, **kw):
    eng = _jax(variant, **kw)
    return JaxBatcher(eng, eng.shard_params(tiny[0]), seed=seed)


def _exported(batcher, req_cls, prompt=PROMPT, **req_kw):
    """Prefill ``prompt`` with a one-token budget on ``batcher`` and export
    its pages with that token: the prefill replica's half of a handoff.
    Returns (payload, the first token)."""
    res = batcher.run([req_cls("pf", list(prompt), max_new_tokens=1,
                               **req_kw)])
    first = res["pf"].tokens[0]
    return batcher.export_prefix(list(prompt), first_token=first), first


# --------------------------------------------------------------------------- #
# the spec and the wire
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_transport_spec_matches_jax(variant):
    mine = _port(variant).transport_spec()
    theirs = jax_transport.transport_spec(_jax(variant))
    assert mine == theirs
    assert list(mine) == list(theirs)
    assert list(mine["leaves"]) == list(theirs["leaves"])
    eng = _port(variant)
    assert eng._page_bytes() == sum(
        page_transport.leaf_bytes(leaf) for leaf in mine["leaves"].values())


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_payloads_cross_the_packages_byte_for_byte(tiny, variant):
    """JAX export -> port import -> port export is the JAX payload; port
    export -> JAX import -> JAX export is the port payload."""
    jb = _jax_batcher(tiny, variant)
    jpayload, _ = _exported(jb, JaxRequest)
    assert jpayload["token_ids"] == PROMPT and len(jpayload["pages"]) == 3
    b = ContinuousBatcher(_port(variant), tiny[1])
    info = b.import_prefix(json.loads(json.dumps(jpayload)))
    assert info["pages_imported"] == 3 and info["created"] == 3
    assert info["bytes_total"] == jpayload["bytes_total"]
    again = b.export_prefix(PROMPT, first_token=jpayload["first_token"])
    assert again == jpayload
    assert b.stats()["prefix_remote_hits"] == 1

    pb = ContinuousBatcher(_port(variant), tiny[1])
    payload, _ = _exported(pb, Request)
    assert set(payload) == set(jpayload)
    jb2 = _jax_batcher(tiny, variant)
    jinfo = jb2.import_prefix(json.loads(json.dumps(payload)))
    assert jinfo["pages_imported"] == 3
    assert jb2.export_prefix(PROMPT, first_token=payload["first_token"]) \
        == payload


def _mutations(payload):
    """name -> a damaged copy of ``payload``."""
    out = {}
    out["version"] = dict(payload, version=2)
    out["page_len"] = dict(payload, page_len=16)
    leaves = copy.deepcopy(payload["leaves"])
    leaves["k"]["dtype"] = "bfloat16"
    out["dtype"] = dict(payload, leaves=leaves)
    out["policy"] = dict(payload, policy=True)
    out["crc"] = dict(payload, crc32=payload["crc32"] ^ 1)
    out["page_count"] = dict(payload, pages=payload["pages"][:2])
    pages = copy.deepcopy(payload["pages"])
    pages[1]["v"] = "not base64!"
    out["base64"] = dict(payload, pages=pages)
    pages = copy.deepcopy(payload["pages"])
    pages[2]["k"] = base64.b64encode(
        base64.b64decode(pages[2]["k"])[:-4]).decode()
    out["leaf_size"] = dict(payload, pages=pages)
    return out


@pytest.fixture(scope="module")
def rejection_rig(tiny):
    """A JAX payload, and a JAX and a port batcher to refuse its damaged
    copies."""
    jpayload, _ = _exported(_jax_batcher(tiny), JaxRequest)
    return (jpayload, _jax_batcher(tiny),
            ContinuousBatcher(_port(), tiny[1]))


@pytest.mark.parametrize("case", ["contiguous", "version", "page_len",
                                  "dtype", "policy", "crc", "page_count",
                                  "base64", "leaf_size"])
def test_rejections_match_jax_and_allocate_nothing(tiny, rejection_rig,
                                                   case):
    jpayload, jb, b = rejection_rig
    if case == "contiguous":
        cfg = Config.from_dict({"model": MODEL})
        with pytest.raises(TransportError) as mine:
            page_transport.transport_spec(InferenceEngine(
                cfg, "cpu", slots=2, max_seq_len=MAX_LEN))
        with pytest.raises(jax_transport.TransportError) as theirs:
            jax_transport.transport_spec(JaxEngine(
                make_config(MODEL, seq=32), slots=2, max_seq_len=MAX_LEN))
        assert str(mine.value) == str(theirs.value)
        assert "paged" in str(mine.value)
        return
    bad = _mutations(jpayload)[case]
    pools = (b.engine.paged.pool, jb.engine.paged.pool)
    before = [(p.free_count, p.refs.copy()) for p in pools]
    with pytest.raises(TransportError) as mine:
        b.import_prefix(bad)
    with pytest.raises(jax_transport.TransportError) as theirs:
        jb.import_prefix(bad)
    assert str(mine.value) == str(theirs.value)
    for p, (free, refs) in zip(pools, before):
        assert p.free_count == free and np.array_equal(p.refs, refs)
    assert b.engine.paged.radix.match(PROMPT) == ([], 0)


@pytest.mark.parametrize("fault", ["write_raises", "pool_exhausted"])
def test_failed_imports_leave_the_pool_and_retry(tiny, monkeypatch, fault):
    jpayload, _ = _exported(_jax_batcher(tiny), JaxRequest)
    if fault == "pool_exhausted":
        # room for 2 of the payload's 3 pages (page 0 is the NULL page)
        b = ContinuousBatcher(_port(kv_num_pages=3), tiny[1])
        jb = _jax_batcher(tiny, kv_num_pages=3)
        with pytest.raises(PagePoolExhausted):
            b.import_prefix(jpayload)
        with pytest.raises(jax_paged.PagePoolExhausted):
            jb.import_prefix(jpayload)
        for p in (b.engine.paged.pool, jb.engine.paged.pool):
            assert p.free_count == 2 and np.all(p.refs[1:] == 0)
        return
    b = ContinuousBatcher(_port(), tiny[1])
    jb = _jax_batcher(tiny)

    def bomb(*args):
        raise RuntimeError("device write fault")

    # the same sequence on both: a write that raises, a retry, a re-import
    for batcher, attr in ((b, "_write_pages"), (jb, "_write_pages_jit")):
        pool = batcher.engine.paged.pool
        free0, refs0 = pool.free_count, pool.refs.copy()
        monkeypatch.setattr(batcher.engine, attr, bomb)
        with pytest.raises(RuntimeError, match="write fault"):
            batcher.import_prefix(jpayload)
        assert pool.free_count == free0 and np.array_equal(pool.refs, refs0)
        assert batcher.engine.paged.radix.match(PROMPT) == ([], 0)
        monkeypatch.undo()
        info = batcher.import_prefix(jpayload)
        assert info["pages_imported"] == 3 and pool.free_count == free0 - 3
        info = batcher.import_prefix(jpayload)
        assert (info["pages_imported"], info["created"]) == (0, 0)
        assert pool.free_count == free0 - 3
    assert np.array_equal(jb.engine.paged.pool.refs,
                          b.engine.paged.pool.refs)
    assert b.export_prefix(PROMPT, jpayload["first_token"]) == jpayload


# --------------------------------------------------------------------------- #
# the radix cache's import half
# --------------------------------------------------------------------------- #


def _radix_script(mod, seed):
    """A seeded random sequence of adopts, registrations, matches, export
    pins, evictions and prefix listings through ``mod.PagedKV``; returns
    every observable after each step."""
    rng = np.random.default_rng(seed)
    p = mod.PagedKV(slots=2, page_len=4, max_pages=6, num_pages=24)
    bank = [rng.integers(1, 6, int(n)).tolist()
            for n in rng.integers(1, 15, 6)]
    log = []
    for _ in range(40):
        op = int(rng.integers(0, 5))
        salt = ["", "t"][int(rng.integers(0, 2))]
        ids = list(bank[int(rng.integers(0, len(bank)))])
        if rng.random() < 0.3:
            ids += rng.integers(1, 6, int(rng.integers(1, 6))).tolist()
        if op == 0:
            plan = p.radix.plan_adopt(ids, salt=salt)
            try:
                pids = p.alloc_import(len(plan))
            except mod.PagePoolExhausted:
                log.append(("exhausted",))
                continue
            log.append(("adopt", plan, pids,
                        p.finish_import(ids, dict(zip(plan, pids)),
                                        salt=salt)))
        elif op == 1:
            pids, matched = p.acquire_prefix(ids, salt=salt)
            log.append(("pin", pids, matched))
            p.release_pages(pids)
        elif op == 2:
            pool = p.pool
            pids = [pool.alloc() for _ in range(2)]
            if None in pids:
                pids = [q for q in pids if q is not None]
                p.release_pages(pids)
                log.append(("dry",))
                continue
            created, dups = p.radix.adopt(ids, {0: pids[0], 1: pids[1]},
                                          salt=salt)
            p.release_pages(pids)
            log.append(("raw_adopt", created, dups))
        elif op == 3:
            log.append(("evict", p.radix.evict_one()))
        else:
            log.append(("prefixes",
                        p.radix.cached_prefixes(int(rng.integers(0, 5)))))
        log.append((p.pool.refs.tolist(), p.pool.free_count,
                    p.radix.evictable_count()))
    return log


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_radix_import_half_matches_jax(seed):
    assert _radix_script(paged_kv, seed) == _radix_script(jax_paged, seed)


# --------------------------------------------------------------------------- #
# seating
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("case", ["block", "verify", "chunked", "int8"])
def test_handoff_seats_without_prefill_and_gives_colocated_tokens(tiny,
                                                                  case):
    variant, kw = {"block": ("fp32", dict(decode_block_len=4)),
                   "verify": ("fp32", dict(spec_len=2)),
                   "chunked": ("fp32", dict(prefill_chunk=8,
                                            decode_block_len=2)),
                   "int8": ("int8", dict(attend_impl="flash"))}[case]
    pb = ContinuousBatcher(_port(variant, **kw), tiny[1])
    payload, first = _exported(pb, Request)
    if case == "chunked":
        assert pb.prefill_dispatches == 3  # 18 tokens in chunks of 8
    db = ContinuousBatcher(_port(variant, role="decode", **kw), tiny[1])
    got = db.run([Request("d", PROMPT, max_new_tokens=NEW,
                          kv_import=json.loads(json.dumps(payload)))])["d"]
    assert (db.handoff_seated, db.prefill_dispatches) == (1, 0)
    assert db.stats()["handoff_seated"] == 1
    want = pb.run([Request("c", PROMPT, max_new_tokens=NEW)])["c"]
    assert got.tokens == want.tokens and got.tokens[0] == first
    assert got.finish_reason == want.finish_reason == "length"
    # the decode side's pages are held by its cache alone once it is done
    pool = db.engine.paged.pool
    assert pool.live_count == 3 and np.all(pool.refs[1:][
        pool.refs[1:] > 0] == 1)


def test_handoff_streams_match_the_jax_handoff(tiny):
    """The slot key schedule, greedy and at temperature 0.8: the first
    token from the prefill side's key chain, the rest from the decode
    side's; the port's handoff streams are the JAX handoff's, from either
    package's payload."""
    kw = dict(key_schedule="slot", decode_block_len=4)
    for temp in (0.0, 0.8):
        sample = dict(temperature=temp, top_p=0.9 if temp else 1.0)
        jpayload, _ = _exported(_jax_batcher(tiny, seed=3, **kw),
                                JaxRequest, **sample)
        jdb = _jax_batcher(tiny, seed=5, **kw)
        want = jdb.run([JaxRequest("d", PROMPT, max_new_tokens=NEW,
                                   kv_import=jpayload, **sample)])["d"]
        assert jdb.handoff_seated == 1
        payload, _ = _exported(ContinuousBatcher(
            _port(**kw), tiny[1], seed=3), Request, **sample)
        assert payload["first_token"] == jpayload["first_token"]
        for p in (payload, jpayload):
            db = ContinuousBatcher(_port(**kw), tiny[1], seed=5)
            got = db.run([Request("d", PROMPT, max_new_tokens=NEW,
                                  kv_import=p, **sample)])["d"]
            assert db.prefill_dispatches == 0
            assert got.tokens == want.tokens, temp


def test_remote_prefix_hit_equals_local_hit(tiny):
    extended = PROMPT + [41, 42, 43]
    local = ContinuousBatcher(_port(), tiny[1])
    local.run([Request("seed", PROMPT, max_new_tokens=1)])
    pf0 = local.prefill_dispatches
    want = local.run([Request("ext", extended, max_new_tokens=NEW)])["ext"]
    payload = local.export_prefix(PROMPT)
    assert "first_token" not in payload
    remote = ContinuousBatcher(_port(), tiny[1])
    remote.import_prefix(payload)
    got = remote.run([Request("ext", extended, max_new_tokens=NEW)])["ext"]
    assert got.tokens == want.tokens
    assert remote.prefill_dispatches == local.prefill_dispatches - pf0
    st = remote.stats()
    assert st["prefix_remote_hits"] == 1 and st["prefix_cached_tokens"] >= 16


def test_partial_payload_is_a_hint_and_a_corrupt_one_self_prefills(tiny):
    payload, _ = _exported(ContinuousBatcher(_port(), tiny[1]), Request)
    extended = PROMPT + [51, 52, 53, 54]
    want = ContinuousBatcher(_port(), tiny[1]).run(
        [Request("c", extended, max_new_tokens=6)])["c"]
    db = ContinuousBatcher(_port(), tiny[1])
    got = db.run([Request("d", extended, max_new_tokens=6,
                          kv_import=payload)])["d"]
    assert db.handoff_seated == 0 and db.prefill_dispatches >= 1
    assert got.tokens == want.tokens
    dropped = db.obs.registry.counter("picotron_handoff_dropped_total")
    bad = dict(payload, crc32=payload["crc32"] ^ 1)
    res = db.run([Request("bad", extended, max_new_tokens=6,
                          kv_import=bad)])["bad"]
    assert res.finish_reason == "length" and res.tokens == want.tokens
    assert db.handoff_seated == 0 and dropped.value == 1


# --------------------------------------------------------------------------- #
# migrate_slot
# --------------------------------------------------------------------------- #


def _decode_row(eng, params, cache, first, slot, n):
    """``n`` greedy tokens of ``slot`` alone from ``first``, in decode
    blocks."""
    out, tok = [], first
    gen = torch.Generator().manual_seed(0)
    zeros = np.zeros(eng.slots)
    while len(out) < n:
        tokens = np.zeros(eng.slots, np.int32)
        tokens[slot] = tok
        budget = np.zeros(eng.slots, np.int32)
        budget[slot] = n - len(out)
        cache, toks, counts = eng.decode_block(
            params, cache, tokens, gen, np.full(eng.slots, -1, np.int32),
            budget, zeros.astype(np.float32), zeros.astype(np.int32),
            np.ones(eng.slots, np.float32))[:3]
        row = toks[slot][: int(counts[slot])].tolist()
        out += row
        tok = row[-1]
    return out


def test_migrate_slot_matches_jax_and_keeps_the_stream(tiny):
    prompt = PROMPT + [60, 61, 62]
    jeng = _jax(slots=3)
    jparams = jeng.shard_params(tiny[0])
    jcache = jeng.init_cache()
    jcache, jlogits = jeng.prefill_paged(jparams, jcache, prompt, 0)[:2]
    jcache, jmoved = jeng.migrate_slot(jcache, 0, 2, prompt_ids=prompt)

    eng = _port(slots=3)
    cache = eng.init_cache()
    cache, logits = eng.prefill_paged(tiny[1], cache, prompt, 0)[:2]
    before = paged_kv.slot_rows(cache, eng.paged.tables, 0, len(prompt))
    cache, moved = eng.migrate_slot(cache, 0, 2, prompt_ids=prompt)
    assert moved == jmoved == 3 * eng._page_bytes()
    assert np.array_equal(eng.paged.tables, np.asarray(jeng.paged.tables))
    assert np.array_equal(eng.paged.pool.refs, jeng.paged.pool.refs)
    assert list(eng.paged.host_len) == list(jeng.paged.host_len)
    assert cache["lengths"].tolist() == np.asarray(
        jcache["lengths"]).tolist()
    after = paged_kv.slot_rows(cache, eng.paged.tables, 2, len(prompt))
    assert np.array_equal(before, after)
    with pytest.raises(ValueError, match="is empty"):
        eng.migrate_slot(cache, 0, 1)
    # the moved slot decodes the unmoved slot's stream
    first = int(torch.argmax(logits[0]))
    moved_stream = _decode_row(eng, tiny[1], cache, first, 2, NEW)
    eng2 = _port(slots=3)
    cache2 = eng2.init_cache()
    cache2 = eng2.prefill_paged(tiny[1], cache2, prompt, 0)[0]
    assert moved_stream == _decode_row(eng2, tiny[1], cache2, first, 0, NEW)


# --------------------------------------------------------------------------- #
# no ml_dtypes
# --------------------------------------------------------------------------- #


def test_transport_needs_no_ml_dtypes(tiny, monkeypatch):
    """The card's machine has no ml_dtypes: a bf16 export and import run
    with it hidden, here and in a fresh interpreter that never loaded
    it."""
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    pb = ContinuousBatcher(_port("bf16"), tiny[1])
    payload, _ = _exported(pb, Request)
    db = ContinuousBatcher(_port("bf16"), tiny[1])
    assert db.import_prefix(payload)["pages_imported"] == 3
    assert db.export_prefix(PROMPT, payload["first_token"]) == payload
    code = (
        "import sys; sys.modules['ml_dtypes'] = None\n"
        "import torch\n"
        "from picotron_tpu_torch.config import Config\n"
        "from picotron_tpu_torch.inference.batcher import "
        "ContinuousBatcher, Request\n"
        "from picotron_tpu_torch.inference.engine import InferenceEngine\n"
        "from picotron_tpu_torch.models import llama\n"
        f"cfg = Config.from_dict({{'model': {MODEL!r}, 'inference': "
        "{'kv_layout': 'paged', 'kv_page_len': 8}})\n"
        "mk = lambda: InferenceEngine(cfg, 'cpu', slots=2, max_seq_len=64, "
        "cache_dtype=torch.bfloat16)\n"
        "eng = mk(); p = llama.init_params(eng.cfg.model, seed=0, "
        "device=eng.device)\n"
        "a = ContinuousBatcher(eng, p); ids = list(range(1, 19))\n"
        "t = a.run([Request('x', ids, max_new_tokens=1)])['x'].tokens[0]\n"
        "pl = a.export_prefix(ids, first_token=t)\n"
        "b = ContinuousBatcher(mk(), p); b.import_prefix(pl)\n"
        "assert b.export_prefix(ids, first_token=t) == pl\n"
        "assert 'ml_dtypes' not in [m for m in sys.modules "
        "if sys.modules[m] is not None]\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO,
                         env=dict(os.environ, OMP_NUM_THREADS="1",
                                  PYTHONPATH=REPO))
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# --------------------------------------------------------------------------- #
# the serve /kv plane
# --------------------------------------------------------------------------- #


def _quiet(*a, **k):
    pass


def _http(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT_S)
    try:
        conn.request(method, path, None if body is None
                     else json.dumps(body))
        resp = conn.getresponse()
        text = resp.read().decode()
        try:
            return resp.status, json.loads(text)
        except ValueError:
            return resp.status, text
    finally:
        conn.close()


@pytest.fixture(scope="module")
def fleet(tiny):
    """Started port servers over the same weights: role prefill, decode
    and both, on the paged layout."""
    servers = {}
    try:
        for role in ("prefill", "decode", "both"):
            srv = serve.Server(_port(role=role, decode_block_len=1),
                               tiny[1], log=_quiet)
            srv.start()
            servers[role] = srv
        yield servers
    finally:
        for srv in servers.values():
            srv.drain_and_join(timeout=WAIT_S)


def test_servers_hand_off_over_http(fleet):
    pre, dec, both = fleet["prefill"], fleet["decode"], fleet["both"]
    spec = {"prompt": PROMPT, "max_new_tokens": NEW}
    st, want = _http(both.port, "POST", "/generate", spec)
    assert st == 200
    st, out = _http(pre.port, "POST", "/kv/export", spec)
    assert st == 200 and out["kv"]["token_ids"] == PROMPT
    st, got = _http(dec.port, "POST", "/generate", {**spec, "kv": out["kv"]})
    assert st == 200 and got["tokens"] == want["tokens"]
    dstz = _http(dec.port, "GET", "/statz")[1]
    assert (dstz["handoff_seated"], dstz["prefill_dispatches"],
            dstz["role"]) == (1, 0, "decode")
    # /metrics and /statz agree on the handoff families
    prom = parse_prometheus(_http(dec.port, "GET", "/metrics")[1])
    assert prom["picotron_prefix_remote_hits_total"] \
        == dstz["prefix_remote_hits"] == 1
    assert prom['picotron_handoff_bytes_total{dir="import"}'] \
        == out["kv"]["bytes_total"]
    assert prom['picotron_serve_role{role="decode"}'] == 1
    prom = parse_prometheus(_http(pre.port, "GET", "/metrics")[1])
    assert prom['picotron_handoff_bytes_total{dir="export"}'] \
        == out["kv"]["bytes_total"]
    pstz = _http(pre.port, "GET", "/statz")[1]
    assert pstz["admitted"] == 1 and pstz["role"] == "prefill"
    assert _http(dec.port, "GET", "/readyz")[1]["role"] == "decode"
    # the role's 503s
    st, body = _http(pre.port, "POST", "/generate", spec)
    assert st == 503 and "prefill" in body["error"]
    assert _http(pre.port, "GET", "/statz")[1]["rejected"]["role"] == 1
    st, body = _http(dec.port, "POST", "/kv/export", spec)
    assert st == 503 and "decode" in body["error"]
    # the lookup, the import and the listing
    ids = ",".join(str(t) for t in PROMPT)
    st, look = _http(pre.port, "GET", f"/kv/pages?ids={ids}")
    assert st == 200 and look["matched"] == len(PROMPT)
    assert "first_token" not in look["kv"]
    st, miss = _http(pre.port, "POST", "/kv/pages", {"ids": [250, 251]})
    assert st == 200 and miss["matched"] == 0
    st, info = _http(both.port, "POST", "/kv/import", {"kv": look["kv"]})
    # the both server prefilled this prompt already: nothing to land
    assert st == 200 and (info["tokens"], info["pages_imported"]) == (
        len(PROMPT), 0)
    st, pref = _http(pre.port, "GET", "/kv/prefixes?limit=2")
    assert st == 200 and pref["prefixes"] == [{"ids": PROMPT,
                                               "tenant": None}]
    assert _http(pre.port, "GET", "/kv/prefixes?limit=0")[0] == 400
    st, body = _http(both.port, "POST", "/kv/import",
                     {"kv": dict(look["kv"], crc32=0)})
    assert st == 400 and "CRC" in body["error"]


def test_unusable_kv_is_dropped_and_counted_not_refused(fleet):
    dec = fleet["decode"]
    spec = {"prompt": [9, 8, 7, 6, 5], "max_new_tokens": 4}
    stz0 = _http(dec.port, "GET", "/statz")[1]
    drops0 = parse_prometheus(_http(dec.port, "GET", "/metrics")[1]).get(
        "picotron_handoff_dropped_total", 0)
    bad = {"version": 1, "page_len": 16, "quantized": False,
           "policy": False, "leaves": {}, "token_ids": [], "pages": []}
    st, got = _http(dec.port, "POST", "/generate", {**spec, "kv": bad})
    assert st == 200 and len(got["tokens"]) == 4
    assert _http(dec.port, "POST", "/generate",
                 {**spec, "kv": [1]})[0] == 400
    stz = _http(dec.port, "GET", "/statz")[1]
    assert stz["handoff_seated"] == stz0["handoff_seated"]
    assert stz["prefill_dispatches"] == stz0["prefill_dispatches"] + 1
    prom = parse_prometheus(_http(dec.port, "GET", "/metrics")[1])
    assert prom["picotron_handoff_dropped_total"] == drops0 + 1
    assert prom["picotron_prefix_remote_hits_total"] \
        == stz["prefix_remote_hits"]


# --------------------------------------------------------------------------- #
# the config
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("role,layout", [("prefill", "paged"),
                                         ("decode", "paged"),
                                         ("both", "contiguous"),
                                         ("prefill", "contiguous"),
                                         ("router", "paged")])
def test_role_is_validated_with_the_jax_messages(role, layout):
    raw = {"inference": {"role": role, "kv_layout": layout}}
    try:
        JaxConfig.from_dict(raw).validate()
        theirs = None
    except ValueError as e:
        theirs = str(e)
    if theirs is None:
        assert Config.from_dict(raw).inference.role == role
        return
    with pytest.raises(ValueError) as mine:
        Config.from_dict(raw)
    assert str(mine.value) == theirs
