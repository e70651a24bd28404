"""The PyTorch port's speculative decoding against the JAX package's, on
the CPU.

Weights are drawn by the JAX package (a tiny fp32 model) and carried
across with ``convert.params_from_jax``; every other input is made by
numpy from a seed, and both sides take the same values:

- the cache writes of the verify shape (out-of-window rows and the ragged
  ``draft_valid`` mask dropped, contiguous and paged, bf16 and int8) bit
  for bit against the JAX writes, and rejected draft rows invisible to
  ``attend``;
- ``speculative_accept``: greedy emitted tokens and counts exactly the JAX
  rule's; sampled first- and second-position marginals within a total
  variation of 0.05 of the JAX rule's and of the sampler's distribution
  over 4,000 draws;
- greedy speculative streams (a scripted drafter that accepts whole,
  partial and no runs, and the real n-gram and learned drafters) equal
  the port's spec-off streams and the JAX batcher's speculative streams
  token for token: spec_len 1 and 3, contiguous, paged, int8 KV,
  ``hot_bf16`` and under adapter ids, EOS mid-verify, budgets and the
  window;
- a ragged verify equals each slot's solo verify (contiguous and paged),
  and the JAX verify on the same inputs; a zero-draft row is one decode
  step;
- the n-gram drafter's proposals, the hidden rows of ``return_hidden``
  (rtol 2e-4), the learned draft program's proposals (with and without a
  head) and the controller's decisions on scripted counts and latencies
  equal the JAX package's;
- the config's spec fields and their validation messages, and the
  generate CLI with ``--spec-len 2``.
"""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_config
from jax.sharding import PartitionSpec as P
from picotron_tpu.config import Config as JaxConfig
from picotron_tpu.config import SpecControllerConfig as JaxControllerConfig
from picotron_tpu.inference import ContinuousBatcher as JaxBatcher
from picotron_tpu.inference import InferenceEngine as JaxEngine
from picotron_tpu.inference import LearnedDrafter as JaxLearnedDrafter
from picotron_tpu.inference import NgramDrafter as JaxNgramDrafter
from picotron_tpu.inference import Request as JaxRequest
from picotron_tpu.inference import SpecController as JaxController
from picotron_tpu.inference import init_draft_head as jax_init_draft_head
from picotron_tpu.inference import kv_cache as jax_kv_cache
from picotron_tpu.inference import paged_kv as jax_paged_kv
from picotron_tpu.inference import sampling as jax_sampling
from picotron_tpu.inference import tenancy as jax_tenancy
from picotron_tpu.models import llama as jax_llama
from picotron_tpu.obs.metrics import MetricsRegistry
from picotron_tpu.topology import build_topology
from picotron_tpu.utils import shard_map as shard_map_compat
from picotron_tpu_torch import convert
from picotron_tpu_torch.config import Config, SpecControllerConfig
from picotron_tpu_torch.inference import kv_cache, paged_kv, sampling
from picotron_tpu_torch.inference.batcher import ContinuousBatcher, Request
from picotron_tpu_torch.inference.engine import InferenceEngine
from picotron_tpu_torch.inference.speculative import (
    DispatchLatency,
    LearnedDrafter,
    NgramDrafter,
    SpecController,
)

MODEL = dict(num_hidden_layers=2, num_attention_heads=8,
             num_key_value_heads=4, hidden_size=64, intermediate_size=128,
             vocab_size=256, max_position_embeddings=128, rope_theta=10000.0,
             dtype="float32", attention_impl="sdpa")
MAX_LEN = 96
CHUNK = 16
BLOCK = 4
SLOTS = 2
PAGE = 8
RTOL = ATOL = 2e-4  # fp32 on both sides
TV_BOUND = 0.05  # total variation, 4,000 draws over 8 tokens
DRAWS = 4000
# (uid, prompt, budget): a repetitive prompt, a short one, one over CHUNK
# tokens (chunked prefill), and one 7 tokens short of the window (its
# verify rows cross the end of the cache)
_RNG = np.random.default_rng(11)
TRAFFIC = (("a", [1, 2, 3, 1, 2, 3, 1, 2], 17),
           ("b", [9, 8, 7], 6),
           ("c", _RNG.integers(1, 256, 35).tolist(), 9),
           ("d", _RNG.integers(1, 256, 89).tolist(), 64))
# JAX functions that the unit tests call several times, compiled once
_JAX_ACCEPT = jax.jit(jax_sampling.speculative_accept)
_JAX_PROBS = jax.jit(jax_sampling.filtered_probs)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Six test workers share the machine: keep torch to one thread here,
    and restore the old count."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


class OracleDrafter:
    """A scripted drafter both batchers take: for a request with a script
    (its prompt and greedy stream) it proposes the script's next tokens,
    with the second draft made wrong on every other history length, so
    rounds accept whole runs, part of one, or nothing; for the others a
    run of tokens that follows no model. Deterministic in (history,
    ctx)."""

    kind = "ngram"
    stateful = True
    needs_hidden = False

    def __init__(self, scripts):
        self.scripts = scripts

    def begin(self, ctx):
        pass

    def forget(self, ctx):
        pass

    def propose(self, history, n, ctx=None):
        h = np.asarray(history, np.int32).reshape(-1)
        script = self.scripts.get(ctx)
        if script is None:
            return ((h[-1] + 1 + np.arange(n)) % 251).astype(np.int32)
        out = np.zeros(n, np.int32)
        tail = script[h.size: h.size + n]
        out[: len(tail)] = tail
        if h.size % 2 and n > 1:
            out[1] = (out[1] + 7) % 256
        return out


@pytest.fixture(scope="module")
def tiny():
    """(JAX config, JAX params, port params, JAX pack, port pack)."""
    jcfg = make_config(MODEL, seq=MAX_LEN)
    jparams = jax.jit(lambda k: jax_llama.init_params(k, jcfg.model))(
        jax.random.PRNGKey(0))
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams))
    jpack = jax_tenancy.AdapterPack(jcfg.model, slots=3, rank=4)
    for t in (1, 2):
        jpack.set_slot(t, jpack.random_leaves(4, seed=t, scale=0.5))
    pack = convert.adapter_pack_from_jax(jpack._host)
    return jcfg, jparams, params, jpack, pack


# the stream cases: (name, spec_len, kv_layout, kv_cache_dtype,
# kv_page_policy, adapters)
CASES = {"contiguous-1": (1, "contiguous", "auto", "uniform", False),
         "contiguous-3": (3, "contiguous", "auto", "uniform", False),
         "paged-3": (3, "paged", "auto", "uniform", False),
         "int8-3": (3, "contiguous", "int8", "uniform", False),
         "hot_bf16-3": (3, "paged", "auto", "hot_bf16", False),
         "adapters-3": (3, "paged", "auto", "uniform", True)}


def _requests(mod_request, adapters=False, eos=None):
    return [mod_request(uid, list(p), max_new_tokens=n,
                        adapter_slot=(i % 3 if adapters else 0),
                        eos_id=(eos or {}).get(uid))
            for i, (uid, p, n) in enumerate(TRAFFIC)]


def _jax_engine(tiny, spec_len, layout="contiguous", kvd="auto",
                policy="uniform", adapters=False, **kw):
    jcfg, jparams, _, jpack, _ = tiny
    eng = JaxEngine(jcfg, slots=SLOTS, max_seq_len=MAX_LEN,
                    prefill_chunk=CHUNK, decode_block_len=BLOCK,
                    attend_impl="dense", kv_layout=layout, kv_page_len=PAGE,
                    kv_page_policy=policy, spec_len=spec_len,
                    cache_dtype="int8" if kvd == "int8" else None,
                    adapters=jpack if adapters else None, **kw)
    return eng, eng.shard_params(jparams)


def _port_engine(tiny, g, layout="contiguous", kvd="auto",
                 policy="uniform", adapters=False, attend="flash",
                 slots=SLOTS, **inf):
    cfg = Config.from_dict({"model": MODEL, "inference": {
        "prefill_chunk": CHUNK, "decode_block_len": BLOCK,
        "attend_impl": attend, "kv_layout": layout, "kv_page_len": PAGE,
        "kv_cache_dtype": kvd, "kv_page_policy": policy, **inf}})
    return InferenceEngine(cfg, "cpu", slots=slots, max_seq_len=MAX_LEN,
                           spec_len=g,
                           adapters=tiny[4] if adapters else None)


def _tokens(results):
    return {u: r.tokens for u, r in results.items()}


@pytest.fixture(scope="module")
def jax_runs(tiny):
    """Per stream case: the port's spec-off streams, the oracle scripts
    made of them, the JAX speculative streams under the oracle drafter
    (the JAX package's own tests pin them to its spec-off streams), its
    dispatch count and accept rate; then, on the contiguous spec_len 3
    engine, the streams of the real n-gram drafter and of an EOS taken
    from the middle of a stream."""
    out = {}
    for name, (g, layout, kvd, policy, ad) in CASES.items():
        off = _tokens(ContinuousBatcher(
            _port_engine(tiny, 0, layout, kvd, policy, ad), tiny[2]).run(
                _requests(Request, ad)))
        scripts = {uid: list(p) + off[uid] for uid, p, _ in TRAFFIC[:3]}
        eng, params = _jax_engine(tiny, g, layout, kvd, policy, ad)
        b = JaxBatcher(eng, params, drafter=OracleDrafter(scripts))
        on = _tokens(b.run(_requests(JaxRequest, ad)))
        out[name] = {"off": off, "scripts": scripts, "on": on,
                     "accept_rate": b.accept_rate,
                     "dispatches": b.decode_dispatches}
        out[name]["engine"] = (eng, params)
        if name == "contiguous-3":
            out["ngram"] = _tokens(JaxBatcher(eng, params).run(
                _requests(JaxRequest)))
            eos = {"a": off["a"][5]}
            assert eos["a"] not in off["a"][:5]
            res = JaxBatcher(eng, params, drafter=OracleDrafter(
                scripts)).run(_requests(JaxRequest, eos=eos))
            out["eos"] = ({u: (r.tokens, r.finish_reason)
                           for u, r in res.items()}, eos)
    return out


# --------------------------------------------------------------------------- #
# the cache writes of the verify shape
# --------------------------------------------------------------------------- #


def _block(rng, B, T, H, D, quantized):
    base = {"k": rng.normal(size=(B, T, H, D)).astype(np.float32),
            "v": rng.normal(size=(B, T, H, D)).astype(np.float32)}
    if quantized:
        qk, ks = jax_kv_cache.quantize_kv(jnp.asarray(base["k"]))
        qv, vs = jax_kv_cache.quantize_kv(jnp.asarray(base["v"]))
        base = {"k": np.asarray(qk), "v": np.asarray(qv),
                "k_scale": np.asarray(ks), "v_scale": np.asarray(vs)}
    return base


@pytest.mark.parametrize("valid", [None, (2, 3)])
@pytest.mark.parametrize("quantized", [False, True])
def test_batched_write_drops_out_of_window_rows(quantized, valid):
    """A verify write (B 2, S 3) whose first slot starts 2 rows from the
    end of an 8-row window: its third row drops instead of landing on row
    7 over the second, and with ``draft_valid`` the rows at or past each
    slot's count drop too. Every byte equals the JAX write's."""
    rng = np.random.default_rng(0)
    B, T, H, D, S = 2, 8, 2, 4, 3
    base = _block(rng, B, T, H, D, quantized)
    k_new = rng.normal(size=(B, S, H, D)).astype(np.float32)
    v_new = rng.normal(size=(B, S, H, D)).astype(np.float32)
    pos = np.asarray([6, 2], np.int32)
    jlc = {n: jnp.asarray(a) for n, a in base.items()}
    lc = {n: torch.from_numpy(a.copy()) for n, a in base.items()}
    if valid is not None:
        jlc["draft_valid"] = jnp.asarray(valid, jnp.int32)
        lc["draft_valid"] = torch.tensor(valid, dtype=torch.int32)
    want = jax_kv_cache.cache_write(jlc, jnp.asarray(k_new),
                                    jnp.asarray(v_new), jnp.asarray(pos))
    got = kv_cache.cache_write(lc, torch.from_numpy(k_new),
                               torch.from_numpy(v_new),
                               torch.from_numpy(pos))
    for name in base:
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)
    # row 7 of slot 0 holds its second fresh row, not its third
    if not quantized and valid is None:
        np.testing.assert_array_equal(got["k"][0, 7].numpy(), k_new[0, 1])


@pytest.mark.parametrize("policy", ["uniform", "int8", "hot_bf16"])
def test_paged_verify_write_sends_masked_rows_to_null(policy):
    """The paged verify write: each slot's S rows through its table row,
    rows at or past its ``draft_valid`` count and past the window to the
    NULL page. Every page but NULL equals the JAX write's bit for bit."""
    rng = np.random.default_rng(1)
    B, H, D, S, maxp = 3, 2, 4, 4, 3
    P = 1 + B * maxp
    quant = policy == "int8"
    pool = _block(rng, P, PAGE, H, D, quant)
    if policy == "hot_bf16":
        side = _block(rng, P, PAGE, H, D, True)
        pool.update({"k_q": side["k"], "v_q": side["v"],
                     "k_scale": side["k_scale"], "v_scale": side["v_scale"]})
    tables = (1 + np.arange(B * maxp, dtype=np.int32)).reshape(B, maxp)
    tables[2, 2] = 0  # an unallocated entry reads NULL
    pos = np.asarray([5, 21, 14], np.int32)  # slot 1 crosses the window
    valid = np.asarray([4, 3, 2], np.int32)
    k_new = rng.normal(size=(B, S, H, D)).astype(np.float32)
    v_new = rng.normal(size=(B, S, H, D)).astype(np.float32)
    jlc = {n: jnp.asarray(a) for n, a in pool.items()}
    lc = {n: torch.from_numpy(a.copy()) for n, a in pool.items()}
    for d, mod in ((jlc, jnp), (lc, torch)):
        d["block_tables"] = mod.asarray(tables)
        d["draft_valid"] = mod.asarray(valid)
    want = jax_paged_kv.cache_write(jlc, jnp.asarray(k_new),
                                    jnp.asarray(v_new), jnp.asarray(pos))
    got = paged_kv.cache_write(lc, torch.from_numpy(k_new),
                               torch.from_numpy(v_new),
                               torch.from_numpy(pos))
    for name in pool:
        np.testing.assert_array_equal(got[name][1:].numpy(),
                                      np.asarray(want[name])[1:],
                                      err_msg=name)


@pytest.mark.parametrize("quantized", [False, True])
def test_rejected_draft_rows_invisible_to_attend(quantized):
    """A verify's draft rows past the accepted length leave ``attend``
    bit for bit as if never written, now and after the next step
    overwrites one of them, and both match the JAX attend (rtol 2e-4)."""
    rng = np.random.default_rng(2)
    B, T, H, D, S = 2, 16, 4, 8, 4
    base = _block(rng, B, T, H, D, quantized)
    pos = np.asarray([6, 3], np.int32)
    k_new = rng.normal(size=(B, S, H, D)).astype(np.float32)
    v_new = rng.normal(size=(B, S, H, D)).astype(np.float32)
    q = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    k2 = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    t = torch.from_numpy

    def fresh():
        return {n: t(a.copy()) for n, a in base.items()}

    spec = kv_cache.cache_write(fresh(), t(k_new), t(v_new), t(pos))
    clean = kv_cache.cache_write(fresh(), t(k_new[:, :1]), t(v_new[:, :1]),
                                 t(pos))
    lengths = t(pos + 1)
    for impl in ("dense", "flash"):
        a = kv_cache.attend(t(q), spec, lengths, 0.3, impl=impl)
        b = kv_cache.attend(t(q), clean, lengths, 0.3, impl=impl)
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    want = jax.jit(lambda c, kn, vn, p, qq: jax_kv_cache.attend(
        qq, jax_kv_cache.cache_write(c, kn, vn, p), p + 1, 0.3))(
            {n: jnp.asarray(a) for n, a in base.items()}, jnp.asarray(k_new),
            jnp.asarray(v_new), jnp.asarray(pos), jnp.asarray(q))
    np.testing.assert_allclose(a.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    spec = kv_cache.cache_write(spec, t(k2), t(k2), lengths)
    clean = kv_cache.cache_write(clean, t(k2), t(k2), lengths)
    torch.testing.assert_close(
        kv_cache.attend(t(q), spec, lengths + 1, 0.3),
        kv_cache.attend(t(q), clean, lengths + 1, 0.3), rtol=0, atol=0)


# --------------------------------------------------------------------------- #
# the acceptance rule
# --------------------------------------------------------------------------- #


def test_speculative_accept_greedy_matches_jax():
    """Greedy rows, ragged and full, drafts that match the argmax chain
    for 0 to G positions: the emitted tokens and counts equal the JAX
    rule's exactly, and a mixed batch's greedy rows keep them."""
    rng = np.random.default_rng(3)
    B, G, V = 6, 4, 32
    logits = rng.normal(size=(B, G + 1, V)).astype(np.float32)
    chain = logits.argmax(-1)
    draft = chain[:, :G].copy()
    for b in range(B):  # row b matches its first b drafts (b < G)
        if b < G:
            draft[b, b] = (draft[b, b] + 1) % V
    draft_len = np.asarray([4, 4, 2, 0, 3, 4], np.int32)
    zero = np.zeros(B, np.float32)
    for dl in (None, draft_len):
        want = _JAX_ACCEPT(
            jnp.asarray(logits), jnp.asarray(draft.astype(np.int32)),
            jax.random.PRNGKey(0), jnp.asarray(zero),
            jnp.zeros(B, jnp.int32), jnp.ones(B),
            draft_len=None if dl is None else jnp.asarray(dl))
        gen = torch.Generator().manual_seed(0)
        for greedy_only in (True, None):
            got = sampling.speculative_accept(
                torch.from_numpy(logits),
                torch.from_numpy(draft.astype(np.int32)), gen,
                torch.from_numpy(zero), torch.zeros(B, dtype=torch.int32),
                torch.ones(B), draft_len=(None if dl is None
                                          else torch.from_numpy(dl)),
                greedy_only=greedy_only)
            for g_, w_ in zip(got, want):
                np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))
    # one sampled row beside them leaves the greedy rows as they were
    temp = zero.copy()
    temp[5] = 1.0
    got = sampling.speculative_accept(
        torch.from_numpy(logits), torch.from_numpy(draft.astype(np.int32)),
        torch.Generator().manual_seed(0), torch.from_numpy(temp),
        torch.zeros(B, dtype=torch.int32), torch.ones(B),
        draft_len=torch.from_numpy(draft_len))
    want = _JAX_ACCEPT(
        jnp.asarray(logits), jnp.asarray(draft.astype(np.int32)),
        jax.random.PRNGKey(0), jnp.asarray(zero), jnp.zeros(B, jnp.int32),
        jnp.ones(B), draft_len=jnp.asarray(draft_len))
    np.testing.assert_array_equal(got[0][:5].numpy(),
                                  np.asarray(want[0])[:5])
    np.testing.assert_array_equal(got[1][:5].numpy(),
                                  np.asarray(want[1])[:5])


def _tv(p, q) -> float:
    return 0.5 * float(np.abs(np.asarray(p) - np.asarray(q)).sum())


@pytest.mark.parametrize("top_k", [0, 3])
@pytest.mark.parametrize("likely", [True, False])
def test_speculative_accept_sampled_marginals(top_k, likely):
    """Sampled rows over 4,000 draws of one [2, 8] logits row and a
    one-token draft (the most or the least likely token): the first
    emitted token's frequencies, the acceptance rate and, given an
    accepted draft, the second token's frequencies are within a total
    variation of 0.05 of the JAX rule's draws and of the sampler's own
    distribution (``filtered_probs``)."""
    rng = np.random.default_rng(4)
    V = 8
    row = rng.normal(size=(2, V)).astype(np.float32)
    logits = np.broadcast_to(row, (DRAWS, 2, V)).copy()
    p0 = np.asarray(_JAX_PROBS(
        jnp.asarray(row), jnp.ones(2), jnp.full(2, top_k, jnp.int32),
        jnp.ones(2)))
    tok = int(np.argmax(p0[0]) if likely else np.argmin(p0[0] + (p0[0] == 0)))
    draft = np.full((DRAWS, 1), tok, np.int32)
    ones, ks = np.ones(DRAWS, np.float32), np.full(DRAWS, top_k, np.int32)
    got_e, got_c = sampling.speculative_accept(
        torch.from_numpy(logits), torch.from_numpy(draft),
        torch.Generator().manual_seed(5), torch.from_numpy(ones),
        torch.from_numpy(ks), torch.from_numpy(ones))
    want_e, want_c = _JAX_ACCEPT(
        jnp.asarray(logits), jnp.asarray(draft), jax.random.PRNGKey(5),
        jnp.asarray(ones), jnp.asarray(ks), jnp.asarray(ones))
    got_e, got_c = got_e.numpy(), got_c.numpy()
    want_e, want_c = np.asarray(want_e), np.asarray(want_c)
    ours = np.bincount(got_e[:, 0], minlength=V) / DRAWS
    theirs = np.bincount(want_e[:, 0], minlength=V) / DRAWS
    assert _tv(ours, theirs) < TV_BOUND
    assert _tv(ours, p0[0]) < TV_BOUND
    assert abs((got_c == 2).mean() - (want_c == 2).mean()) < TV_BOUND
    assert abs((got_c == 2).mean() - p0[0][tok]) < TV_BOUND
    sel, jsel = got_c == 2, want_c == 2
    if sel.sum() > DRAWS // 4 and jsel.sum() > DRAWS // 4:
        ours2 = np.bincount(got_e[sel, 1], minlength=V) / sel.sum()
        theirs2 = np.bincount(want_e[jsel, 1], minlength=V) / jsel.sum()
        assert _tv(ours2, theirs2) < 2 * TV_BOUND
        assert _tv(ours2, p0[1]) < 2 * TV_BOUND
    # filtered_probs itself is the JAX function's
    np.testing.assert_allclose(
        sampling.filtered_probs(torch.from_numpy(row), torch.ones(2),
                                torch.full((2,), top_k, dtype=torch.int32),
                                torch.ones(2)).numpy(), p0, rtol=1e-6,
        atol=1e-7)


# --------------------------------------------------------------------------- #
# the slice: greedy speculative streams
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("case", list(CASES))
def test_spec_streams_match_spec_off_and_jax(tiny, jax_runs, case):
    """Greedy streams through the speculative batcher under the oracle
    drafter (whole, partial and no accepts) equal the port's spec-off
    streams and the JAX batcher's speculative streams token for token,
    budgets and the window held (request d: 89 prompt tokens under a
    96-row window leave 7), with the JAX run's dispatch count and accept
    rate. The port attends through C's plain versions."""
    g, layout, kvd, policy, ad = CASES[case]
    params = tiny[2]
    run = jax_runs[case]
    off = run["off"]
    b = ContinuousBatcher(_port_engine(tiny, g, layout, kvd, policy, ad),
                          params, drafter=OracleDrafter(run["scripts"]))
    res = b.run(_requests(Request, ad))
    on = _tokens(res)
    assert on == off, case
    assert on == run["on"], case
    assert [len(on[u]) for u, _, _ in TRAFFIC] == [17, 6, 9, 7]
    assert all(r.finish_reason == "length" for r in res.values())
    assert b.decode_dispatches == run["dispatches"]
    assert b.accept_rate == pytest.approx(run["accept_rate"])
    assert 0.2 < b.accept_rate < 1.0  # whole, partial and no accepts
    assert res["a"].spec_len_final == g and res["a"].drafter == "ngram"
    st = b.stats()
    assert st["accept_rate"] == b.accept_rate
    if layout == "paged":
        assert st["prefix_queries"] == len(TRAFFIC)


def test_ngram_streams_and_eos_mid_verify(tiny, jax_runs):
    """The real n-gram drafter's greedy streams equal spec-off and the
    JAX batcher's; an EOS id taken from the middle of a stream ends it
    there (inside an accepted run) as in JAX, and the request queued
    behind it completes."""
    params = tiny[2]
    eng = _port_engine(tiny, 3)
    b = ContinuousBatcher(eng, params)
    assert isinstance(b.drafter, NgramDrafter)
    got = _tokens(b.run(_requests(Request)))
    assert got == jax_runs["ngram"] == jax_runs["contiguous-3"]["off"]
    assert b.draft_proposed > 0
    want, eos = jax_runs["eos"]
    res = ContinuousBatcher(eng, params, drafter=OracleDrafter(
        jax_runs["contiguous-3"]["scripts"])).run(
            _requests(Request, eos=eos))
    assert {u: (r.tokens, r.finish_reason) for u, r in res.items()} == want
    assert res["a"].finish_reason == "eos" and len(res["a"].tokens) == 6


def test_sampled_spec_rows_keep_the_filter_support(tiny, jax_runs):
    """A sampled request beside greedy ones: the greedy streams stay the
    spec-off streams, and every sampled token lies in the JAX filter's
    support at its position (top-k 4 over the full-sequence logits)."""
    jcfg, jparams, params = tiny[:3]
    reqs = _requests(Request)
    reqs[1] = Request("b", list(TRAFFIC[1][1]), max_new_tokens=12,
                      temperature=0.9, top_k=4)
    res = ContinuousBatcher(_port_engine(tiny, 3), params, seed=3,
                            drafter=OracleDrafter(
                                jax_runs["contiguous-3"]["scripts"])).run(
                                    reqs)
    off = jax_runs["contiguous-3"]["off"]
    for u in ("a", "c", "d"):
        assert res[u].tokens == off[u]
    toks = res["b"].tokens
    seq = list(TRAFFIC[1][1]) + toks
    mesh = build_topology(1, 1, 1, 1).mesh
    logits = np.asarray(jax.jit(shard_map_compat(
        lambda p, t: jax_llama.forward_logits(p, t, jcfg), mesh,
        in_specs=(P(), P()), out_specs=P()))(
            jparams, jnp.asarray([seq], jnp.int32)))[0]
    n = len(TRAFFIC[1][1])
    rows = jnp.asarray(logits[n - 1: len(seq) - 1] / 0.9)
    kept = np.asarray(jax_sampling.filter_top_k_top_p(
        rows, jnp.full((len(toks),), 4, jnp.int32),
        jnp.ones(len(toks))))
    assert (kept[np.arange(len(toks)), toks] > -1e29).all()


# --------------------------------------------------------------------------- #
# the verify dispatch
# --------------------------------------------------------------------------- #


def _park(engine, params, prompts):
    """A fresh cache with each prompt parked in its slot."""
    cache = engine.init_cache()
    for s, p in enumerate(prompts):
        if engine.paged is not None:
            cache = engine.prefill_paged(params, cache, p, s)[0]
        else:
            kv = engine.prefill(params, p)[0]
            cache = engine.insert(cache, kv, s, len(p))
    return cache


RAGGED_PROMPTS = [[1, 2, 3, 1, 2, 3], [9, 8, 7, 6]]


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_ragged_verify_matches_solo_and_jax(tiny, jax_runs, layout):
    """Ragged verifies over prompts parked but for their last token, which
    column 0 feeds, slot 0's first two drafts its greedy stream: draft
    lengths (3, 0), then (3, 1) with slot 0's budget cutting its run at 2.
    Each emits, counts, accepts and advances every slot as that slot's
    solo verify does, and as the JAX verify on the same inputs; the
    0-draft row is one decode step's token."""
    parked = [p[:-1] for p in RAGGED_PROMPTS]
    params = tiny[2]
    eng = _port_engine(tiny, 3, layout)
    jeng, jparams = jax_runs[f"{layout}-3"]["engine"]
    drafts = np.random.default_rng(6).integers(1, 256, (2, 3))
    tokens = np.concatenate(
        [np.asarray([[p[-1]] for p in RAGGED_PROMPTS]), drafts],
        1).astype(np.int32)
    first = ContinuousBatcher(_port_engine(tiny, 0, layout), params).run(
        [Request("x", RAGGED_PROMPTS[0], max_new_tokens=3)])
    tokens[0, 1:3] = first["x"].tokens[:2]
    eos = np.full(2, -1, np.int32)
    zeros, ones = np.zeros(2, np.float32), np.ones(2, np.float32)
    k0 = np.zeros(2, np.int32)

    def one_run(budget, draft_len):
        cache = _park(eng, params, parked)
        cache, em, ct, ac = eng.verify(
            params, cache, tokens, torch.Generator(), eos, budget, zeros,
            k0, ones, draft_len=draft_len)
        return (em.numpy(), ct.numpy(), ac.numpy(),
                cache["lengths"].numpy().copy())

    for draft_len, budget in (((3, 0), (8, 8)), ((3, 1), (2, 8))):
        draft_len = np.asarray(draft_len, np.int32)
        budget = np.asarray(budget, np.int32)
        g_em, g_ct, g_ac, g_len = one_run(budget, draft_len)
        for s in range(2):
            solo = np.zeros(2, np.int32)
            solo[s] = budget[s]
            em, ct, ac, ln = one_run(solo, draft_len)
            assert (ct[s], ac[s], ln[s]) == (g_ct[s], g_ac[s], g_len[s])
            np.testing.assert_array_equal(em[s], g_em[s])
        assert g_ac[0] == min(2, budget[0])
        assert np.all(g_ct <= draft_len + 1) and np.all(g_ac <= draft_len)
        jcache = jeng.init_cache()
        for s, p in enumerate(parked):
            if layout == "paged":
                jcache = jeng.prefill_paged(jparams, jcache, p, s)[0]
            else:
                jcache = jeng.insert(jcache, jeng.prefill(jparams, p)[0], s,
                                     len(p))
        jcache, em, ct, ac = jeng.verify(
            jparams, jcache, tokens, jax.random.PRNGKey(0), eos, budget,
            zeros, k0, ones, draft_len=draft_len)
        np.testing.assert_array_equal(g_em, np.asarray(em))
        np.testing.assert_array_equal(g_ct, np.asarray(ct))
        np.testing.assert_array_equal(g_ac, np.asarray(ac))
        np.testing.assert_array_equal(g_len, np.asarray(jcache["lengths"]))
        if draft_len[1] == 0:  # the 0-draft row: one greedy decode step
            step = _port_engine(tiny, 0, layout)
            step.decode_block_len = 1
            _, toks, _ = step.decode_block(
                params, _park(step, params, parked), tokens[:, 0],
                torch.Generator(), eos, np.ones(2, np.int32), zeros, k0,
                ones)
            assert g_ct[1] == 1 and g_em[1, 0] == int(toks[1, 0])


def test_verify_validates_like_jax(tiny):
    """The verify's argument checks give the JAX engine's messages."""
    params = tiny[2]
    eng = _port_engine(tiny, 3)
    args = (np.full(2, -1, np.int32), np.ones(2, np.int32),
            np.zeros(2, np.float32), np.zeros(2, np.int32),
            np.ones(2, np.float32))
    cache = eng.init_cache()
    for tokens, dl, match in (
            (np.zeros((2, 3), np.int32), None,
             r"verify tokens must be \[slots, spec_len \+ 1\] = \[2, 4\]"),
            (np.zeros((2, 4), np.int32), np.zeros(3, np.int32),
             r"draft_len must be \[slots\] = \[2\]"),
            (np.zeros((2, 4), np.int32), np.asarray([4, 0], np.int32),
             r"draft_len entries must be in \[0, spec_len = 3\]")):
        with pytest.raises(ValueError, match=match):
            eng.verify(params, cache, tokens, torch.Generator(), *args,
                       draft_len=dl)
    off = _port_engine(tiny, 0)
    with pytest.raises(ValueError, match="speculative decoding is off"):
        off.verify(params, cache, np.zeros((2, 1), np.int32),
                   torch.Generator(), *args)
    with pytest.raises(ValueError, match="spec_len must be >= 0"):
        _port_engine(tiny, -1)
    with pytest.raises(ValueError, match="leaves no room"):
        _port_engine(tiny, MAX_LEN)


# --------------------------------------------------------------------------- #
# the drafters
# --------------------------------------------------------------------------- #


def test_ngram_drafter_matches_jax():
    """Cycle, longest suffix, fallback, the incremental index against the
    full scan (unbounded and windowed), the window, and a stale ctx: the
    same proposals as the JAX drafter on the same histories."""
    cases = [([1, 2, 3, 1, 2, 3, 1, 2], 4, 3, 0),
             ([1, 2, 3, 1, 2, 3, 1, 2], 7, 3, 0),
             ([9, 5, 2, 9, 7, 2, 9], 1, 3, 0),
             ([4, 5, 6], 3, 3, 0), ([2], 2, 3, 0), ([], 2, 3, 0),
             ([7, 8, 9, 1, 1, 1, 1, 1, 1, 1, 7, 8], 1, 2, 0),
             ([7, 8, 9, 1, 1, 1, 1, 1, 1, 1, 7, 8], 1, 2, 4)]
    for hist, n, k, w in cases:
        h = np.asarray(hist, np.int32)
        want = JaxNgramDrafter(k, window=w).propose(h, n)
        np.testing.assert_array_equal(
            NgramDrafter(k, window=w).propose(h, n), want)
        np.testing.assert_array_equal(
            NgramDrafter(k, window=w).propose(h, n, ctx="x"), want)
    rng = np.random.default_rng(7)
    for window in (0, 12):
        inc, ref = NgramDrafter(3, window=window), JaxNgramDrafter(
            3, window=window)
        inc.begin("r")
        hist = list(rng.integers(0, 6, 5))
        for round_ in range(40):
            h = np.asarray(hist, np.int32)
            np.testing.assert_array_equal(inc.propose(h, 4, ctx="r"),
                                          ref.propose(h, 4),
                                          err_msg=f"{window} {round_}")
            if round_ % 3 == 0:
                hist.extend(hist[-3:])
            hist.append(int(rng.integers(0, 6)))
        inc.forget("r")
        assert "r" not in inc._idx
    d = NgramDrafter(3)
    d.propose(np.asarray([1, 2, 3, 4, 5, 1, 2, 3, 4], np.int32), 2, ctx="s")
    short = np.asarray([9, 8], np.int32)
    np.testing.assert_array_equal(d.propose(short, 2, ctx="s"),
                                  JaxNgramDrafter(3).propose(short, 2))
    for bad in ({"ngram": 0}, {"window": -1}):
        with pytest.raises(ValueError) as ours:
            NgramDrafter(**bad)
        with pytest.raises(ValueError) as theirs:
            JaxNgramDrafter(**bad)
        assert str(ours.value) == str(theirs.value)


@pytest.fixture(scope="module")
def jax_learned(tiny):
    """A JAX learned-drafter engine (spec_len 3, return_hidden) and its
    params."""
    return _jax_engine(tiny, 3, drafter="learned")


def test_return_hidden_matches_jax(tiny, jax_learned):
    """The hidden rows of prefill, decode_block and a ragged verify equal
    the JAX engine's (rtol 2e-4), with its tokens and counts."""
    params = tiny[2]
    jeng, jparams = jax_learned
    eng = _port_engine(tiny, 3, drafter="learned")
    assert eng.return_hidden and jeng.return_hidden
    prompts = [[1, 2, 3, 4, 5], [9, 8]]
    cache, jcache = eng.init_cache(), jeng.init_cache()
    first = []
    for s, p in enumerate(prompts):
        kv, logits, hid = eng.prefill(params, p)
        jkv, jlogits, jhid = jeng.prefill(jparams, p)
        np.testing.assert_allclose(hid.numpy(), np.asarray(jhid),
                                   rtol=RTOL, atol=ATOL)
        cache = eng.insert(cache, kv, s, len(p))
        jcache = jeng.insert(jcache, jkv, s, len(p))
        first.append(int(np.argmax(np.asarray(jlogits)[0])))
    first = np.asarray(first, np.int32)
    args = (np.full(2, -1, np.int32), np.asarray([4, 2], np.int32),
            np.zeros(2, np.float32), np.zeros(2, np.int32),
            np.ones(2, np.float32))
    keys = np.stack([np.asarray(jax.random.PRNGKey(i)) for i in range(4)])
    cache, toks, counts, hid = eng.decode_block(params, cache, first,
                                                torch.Generator(), *args)
    jcache, jtoks, jcounts, jhid = jeng.decode_block(jparams, jcache, first,
                                                     keys, *args)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    np.testing.assert_allclose(hid.numpy(), np.asarray(jhid), rtol=RTOL,
                               atol=ATOL)
    last = np.asarray([toks[s, counts[s] - 1] for s in range(2)], np.int32)
    tokens = np.zeros((2, 4), np.int32)
    tokens[:, 0] = last
    tokens[0, 1:3] = [7, 7]
    vargs = (np.full(2, -1, np.int32), np.full(2, 8, np.int32)) + args[2:]
    dl = np.asarray([2, 0], np.int32)
    out = eng.verify(params, cache, tokens, torch.Generator(), *vargs,
                     draft_len=dl)
    jout = jeng.verify(jparams, jcache, tokens, jax.random.PRNGKey(9),
                       *vargs, draft_len=dl)
    for i in (1, 2, 3):
        np.testing.assert_array_equal(out[i].numpy(), np.asarray(jout[i]))
    np.testing.assert_allclose(out[4].numpy(), np.asarray(jout[4]),
                               rtol=RTOL, atol=ATOL)
    # chunked and paged prefills return the same row as the one-shot one
    long = list(range(3, 40))
    want = eng.prefill(params, long)[2]
    got = eng.prefill_chunked(params, eng.init_cache(), long, 0)[2]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL)
    paged = _port_engine(tiny, 3, "paged", drafter="learned")
    got = paged.prefill_paged(params, paged.init_cache(), long, 0)[4]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("with_head", [False, True])
def test_draft_program_matches_jax(tiny, jax_learned, with_head):
    """The learned drafter's proposals from the same hidden rows and
    tokens (and the same head, drawn by the JAX package and carried
    across as numpy) equal the JAX draft program's; the drafter refuses
    a wrong length and per-slot proposal, and engines without the hook."""
    params = tiny[2]
    jeng, jparams = jax_learned
    eng = _port_engine(tiny, 3, drafter="learned")
    hidden = np.random.default_rng(8).normal(size=(2, 64)).astype(np.float32)
    toks = np.asarray([5, 9], np.int32)
    jhead = (jax_init_draft_head(jax.random.PRNGKey(1), 64) if with_head
             else None)
    head = ({"w": torch.from_numpy(np.asarray(jhead["w"]))} if with_head
            else None)
    want = JaxLearnedDrafter(jeng, jparams, head=jhead).propose_batch(
        toks, jnp.asarray(hidden), 3)
    d = LearnedDrafter(eng, params, head=head)
    got = d.propose_batch(toks, torch.from_numpy(hidden), 3)
    assert got.dtype == np.int32 and got.shape == (2, 3)
    np.testing.assert_array_equal(got, np.asarray(want))
    with pytest.raises(ValueError, match="spec_len"):
        d.propose_batch(toks, torch.from_numpy(hidden), 2)
    with pytest.raises(TypeError, match="propose_batch"):
        d.propose(np.asarray([1, 2]), 3)
    with pytest.raises(ValueError, match="speculative engine"):
        LearnedDrafter(_port_engine(tiny, 0), params)
    with pytest.raises(ValueError, match="return_hidden"):
        LearnedDrafter(_port_engine(tiny, 3), params)


def test_learned_drafter_streams_bit_identical(tiny, jax_runs):
    """Greedy streams with the learned drafter, with and without the
    controller, equal spec-off and the JAX streams; it drafts, and its
    slots report it."""
    params = tiny[2]
    off = jax_runs["contiguous-3"]["off"]
    for ctl in (False, True):
        eng = _port_engine(tiny, 3, drafter="learned", spec_len=3,
                           spec_controller={"enabled": ctl, "window": 4})
        b = ContinuousBatcher(eng, params)
        res = b.run(_requests(Request))
        assert _tokens(res) == off
        assert isinstance(b.drafter, LearnedDrafter)
        assert list(b._drafters) == ["learned", "ngram"]
        assert b.draft_proposed > 0
        assert all(r.drafter in ("learned", "ngram") for r in res.values())
        assert (b.controller is not None) == ctl


# --------------------------------------------------------------------------- #
# the controller
# --------------------------------------------------------------------------- #


def _controllers(kinds=("ngram",), gmax=4, block_len=8, **kw):
    jc = JaxController(JaxControllerConfig(enabled=True, **kw),
                       MetricsRegistry(), slots=1, max_spec_len=gmax,
                       block_len=block_len, kinds=kinds)
    pc = SpecController(SpecControllerConfig(enabled=True, **kw),
                        DispatchLatency(), slots=1, max_spec_len=gmax,
                        block_len=block_len, kinds=kinds)
    return jc, pc


def _observe(jc, pc, kind, seconds):
    jc.registry.histogram("picotron_dispatch_seconds",
                          "dispatch wall time incl. host sync, by kind",
                          kind=kind).observe(seconds)
    pc.latency.observe(kind, seconds)


def _round(jc, pc, proposed, accepted):
    """One round's counts into both (the JAX registry's per-slot counters,
    which the JAX batcher writes, and the port's record), then the tick;
    both must then agree."""
    reg = jc.registry
    reg.counter("picotron_slot_draft_proposed_total",
                slot="0").inc(proposed)
    reg.counter("picotron_slot_draft_accepted_total",
                slot="0").inc(accepted)
    for c in (jc, pc):
        c.record(0, proposed, accepted)
        c.after_round(0)
    assert list(pc.lens()) == list(jc.lens())
    assert pc.drafter_kinds() == jc.drafter_kinds()
    assert pc.decisions == jc.decisions


SCRIPTS = {
    # accept-rate flip-flop: the hysteresis streak never completes
    "hysteresis": (dict(window=4, hysteresis=2, cooloff=1000), None,
                   [(4, 4 if i % 2 == 0 else 0) for i in range(40)]),
    # hard traffic: down to 1, off, then probes after the cooloff
    "off_and_probe": (dict(window=4, hysteresis=2, low=0.25, cooloff=3),
                      None, [(4, 0)] * 2 + [(2, 0)] * 4 + [(1, 0)] * 8
                      + [(0, 0)] * 4 + [(1, 1)] * 10),
    # down to 1, then full acceptance ramps back to the ceiling
    "ramp_up": (dict(window=2, hysteresis=2, target=0.5, cooloff=1000),
                None, [(4, 0)] * 2 + [(2, 0)] * 2 + [(1, 1)] * 4
                + [(2, 2)] * 4 + [(4, 4)] * 4),
    # a learned primary switches to the n-gram drafter before going off
    "switch": (dict(window=2, hysteresis=1, cooloff=1000), None,
               [(4, 0), (2, 0)] + [(1, 0)] * 8),
    # measured verify cost loses to a decode block: off at full acceptance
    "latency_veto": (dict(window=2, hysteresis=1, latency_min_samples=4),
                     "veto", [(4, 4), (2, 2), (1, 1), (1, 1), (1, 1)]),
    # a TPOT SLO the verify cadence misses halves the width each round
    "slo_cap": (dict(window=64, hysteresis=2), "slo",
                [(4, 4), (2, 2), (1, 1), (1, 1)]),
}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_controller_decisions_match_jax(name):
    """The port's controller and the JAX one, fed the same scripted draft
    counts and dispatch latencies, make the same decisions round by
    round: lengths, drafters and the tally of actions."""
    kw, latency, rounds = SCRIPTS[name]
    kinds = ("learned", "ngram") if name == "switch" else ("ngram",)
    jc, pc = _controllers(kinds=kinds, **kw)
    if latency == "veto":
        for _ in range(8):
            _observe(jc, pc, "verify", 0.2)
            _observe(jc, pc, "decode", 0.08)
    if latency == "slo":
        for _ in range(16):
            _observe(jc, pc, "verify", 0.05)
            _observe(jc, pc, "draft", 0.01)
    slo = 0.02 if latency == "slo" else None
    for c in (jc, pc):
        c.reset(0, tpot_slo_s=slo)
    assert list(pc.lens()) == list(jc.lens())
    for proposed, accepted in rounds:
        _round(jc, pc, proposed, accepted)
    expect = {"hysteresis": set(), "off_and_probe": {"spec_off", "probe"},
              "ramp_up": {"ramp_up"}, "switch": {"switch_drafter"},
              "latency_veto": {"spec_off"}, "slo_cap": set()}[name]
    assert expect <= set(pc.decisions)
    if name == "slo_cap":  # the SLO is missed at admission: start at 1
        assert int(pc.lens()[0]) == 1
    if name == "hysteresis":
        assert not pc.decisions and int(pc.lens()[0]) == 4


def test_controller_slo_cap_halves_a_live_slot():
    """A slot admitted before the verify latency is known starts at the
    full draft; once the measured verify + draft time passes its SLO, each
    round halves it (``slo_cap``), as in JAX."""
    jc, pc = _controllers(window=64, hysteresis=2)
    for c in (jc, pc):
        c.reset(0, tpot_slo_s=0.02)
    assert int(pc.lens()[0]) == 4
    for _ in range(16):
        _observe(jc, pc, "verify", 0.05)
    for _ in range(3):
        _round(jc, pc, 4, 4)
    assert pc.decisions == {"slo_cap": 2} and int(pc.lens()[0]) == 1
    assert pc.spec_len_mean([0]) == jc.spec_len_mean([0])


# --------------------------------------------------------------------------- #
# the config and the CLI
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("raw", [
    {"spec_len": -1}, {"spec_ngram": 0}, {"drafter": "oracle"},
    {"spec_history_window": -1}, {"spec_controller": {"enabled": True}},
    {"spec_len": 4, "spec_controller": {"low": 0.9, "target": 0.5}},
    {"spec_len": 4, "spec_controller": {"target": 0.0}},
    {"spec_len": 4, "spec_controller": {"window": 0}},
    {"spec_len": 4, "spec_controller": {"hysteresis": 0}},
    {"spec_len": 4, "spec_controller": {"cooloff": -1}},
    {"spec_len": 4, "spec_controller": {"latency_min_samples": 0}},
    {"spec_len": 4, "spec_controller": {"enabled": "true"}},
])
def test_spec_config_validation_matches_jax(raw):
    with pytest.raises(ValueError) as theirs:
        JaxConfig.from_dict({"inference": raw})
    with pytest.raises(ValueError) as ours:
        Config.from_dict({"inference": raw})
    assert str(ours.value) == str(theirs.value)


def test_spec_config_loads_and_round_trips():
    """spec_len 4 loads with every spec field read; the nested controller
    section round-trips; dp sharding is still refused, and the
    disaggregation roles, served since the page transport, need the paged
    layout."""
    cfg = Config.from_dict({"inference": {
        "spec_len": 4, "drafter": "learned", "spec_ngram": 2,
        "spec_history_window": 16,
        "spec_controller": {"enabled": True, "window": 8}}})
    back = Config.from_dict(cfg.to_dict())
    assert back.inference.spec_controller.window == 8
    assert back.inference.drafter == "learned"
    assert (back.inference.spec_len, back.inference.spec_ngram,
            back.inference.spec_history_window) == (4, 2, 16)
    jdefaults = JaxControllerConfig()
    for f in ("enabled", "target", "low", "window", "hysteresis", "cooloff",
              "latency_min_samples"):
        assert getattr(SpecControllerConfig(), f) == getattr(jdefaults, f)
    with pytest.raises(ValueError, match="not in the PyTorch port yet"):
        Config.from_dict({"inference": {"dp_size": 2}})
    for role in ("decode", "prefill"):
        with pytest.raises(ValueError, match="requires the paged KV layout"):
            Config.from_dict({"inference": {"role": role}})
        assert Config.from_dict({"inference": {
            "role": role, "kv_layout": "paged"}}).inference.role == role
    eng = InferenceEngine(Config.from_dict({"model": MODEL, "inference": {
        "spec_len": 3, "spec_ngram": 2, "drafter": "learned"}}), "cpu",
        slots=2, max_seq_len=MAX_LEN)
    assert (eng.spec_len, eng.spec_ngram, eng.drafter_kind,
            eng.return_hidden) == (3, 2, "learned", True)
    assert InferenceEngine(eng.cfg, "cpu", spec_len=0,
                           max_seq_len=MAX_LEN).spec_len == 0


def test_generate_cli_speculates_on_the_cpu(tmp_path, capsys):
    """``--spec-len 2 --spec-ngram 2``: the same greedy tokens as without
    speculation, and the JAX tool's summary line with ``spec=2
    accept=R``."""
    from picotron_tpu_torch.tools import generate

    path = tmp_path / "tiny.json"
    path.write_text(json.dumps({
        "model": {**MODEL, "num_hidden_layers": 1},
        "inference": {"attend_impl": "flash", "prefill_chunk": 8},
        "training": {"seq_length": 48}}))
    argv = ["--config", str(path), "--random-init", "--seed", "3",
            "--prompt-ids", "1,2,3,1,2,3,1,2", "--prompt-ids",
            ",".join(str(i % 60 + 1) for i in range(13)),
            "--max-new-tokens", "9", "--slots", "2"]
    assert generate.main(argv, device="cpu") == 0
    off = capsys.readouterr().out
    assert generate.main(argv + ["--spec-len", "2", "--spec-ngram", "2"],
                         device="cpu") == 0
    on = capsys.readouterr().out
    streams = re.compile(r"^\[req\d\] .*$", re.M)
    assert streams.findall(on) == streams.findall(off)
    assert re.search(r"weights=bf16, spec=2 accept=[\d.]+ \d+ decode "
                     r"dispatches = [\d.]+/token\)$", on, re.M), on
