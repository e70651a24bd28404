"""The port's per-slot key schedule, ``decode_step`` and sampling in the
dispatch against the JAX package's, on the CPU.

Weights are drawn by the JAX package (a tiny fp32 model) and carried
across with ``convert.params_from_jax``; every other input is made by
numpy from a seed, and both sides take the same values:

- ``prng`` against ``jax.random``: ``PRNGKey``, ``split``, ``fold_in``,
  32-bit ``bits`` and the uniforms on [0, 1) and [tiny, 1) bit for bit;
  the Gumbel noise within 2 ulp at the scale of ``max(|g|, 1)`` (``log``
  rounds differently in torch and in XLA: up to 1 ulp of ``-log(u)``,
  which is near 1), and ``categorical`` token for token;
- ``sampling.sample_rowkeys`` and ``sampling.speculative_match`` token for
  token against the JAX functions (sampled, greedy, filtered, NaN and
  ragged rows), a row drawn alone equal to the same row in a batch;
- the slot schedule's batcher streams at temperature 0.8 and seed 7 equal
  the JAX batcher's token for token, and are the same at
  ``decode_block_len`` 2 and 4, under speculation (``spec_len`` 3) and
  on the paged layout;
- ``decode_step`` (tokens, logits, lengths) and sampling in the dispatch
  (``sample_on_device``: the prefill family's token, ``decode_step``
  without logits, the batcher's streams the same as without it) against
  the JAX engine's, and their refusals with the JAX messages;
- ``kv_cache.live_tokens``, and the key schedule's resolution and errors
  against the JAX engine's;
- ``generate --sample-on-device``: the streams printed without it.
"""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_config
from picotron_tpu.config import Config as JaxConfig
from picotron_tpu.inference import ContinuousBatcher as JaxBatcher
from picotron_tpu.inference import InferenceEngine as JaxEngine
from picotron_tpu.inference import Request as JaxRequest
from picotron_tpu.inference import kv_cache as jax_kv_cache
from picotron_tpu.inference import sampling as jax_sampling
from picotron_tpu.models import llama as jax_llama
from picotron_tpu_torch import convert
from picotron_tpu_torch.config import Config
from picotron_tpu_torch.inference import kv_cache, prng, sampling
from picotron_tpu_torch.inference.batcher import ContinuousBatcher, Request
from picotron_tpu_torch.inference.engine import InferenceEngine

MODEL = dict(num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, hidden_size=32, intermediate_size=64,
             vocab_size=128, max_position_embeddings=96, rope_theta=10000.0,
             dtype="float32", attention_impl="sdpa")
MAX_LEN = 96
SLOTS = 3
TINY = float(np.finfo(np.float32).tiny)
# the JAX functions the unit tests call, compiled once
_JAX_ROWKEYS = jax.jit(jax_sampling.sample_rowkeys)
_JAX_MATCH = jax.jit(jax_sampling.speculative_match)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Six test workers share the machine: keep torch to one thread here,
    and restore the old count."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def tiny():
    """(JAX config, JAX params, port params)."""
    jcfg = make_config(MODEL, seq=MAX_LEN)
    jparams = jax.jit(lambda k: jax_llama.init_params(k, jcfg.model))(
        jax.random.PRNGKey(0))
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, params


def _jax_keys(seed: int, n: int) -> np.ndarray:
    """``n`` keys of the JAX package: ``fold_in(PRNGKey(seed), i)``."""
    k = jax.random.PRNGKey(seed)
    return np.stack([np.asarray(jax.random.fold_in(k, i))
                     for i in range(n)])


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """|a - b| in ulps of float32 at the scale of max(|a|, |b|, 1)."""
    scale = np.maximum(np.maximum(np.abs(a), np.abs(b)), 1.0)
    return np.abs(a.astype(np.float64) - b) / np.spacing(
        scale.astype(np.float32))


# --------------------------------------------------------------------------- #
# prng against jax.random
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("seed", [0, 7, 123456789])
def test_key_split_and_fold_in_match_jax(seed):
    k = jax.random.PRNGKey(seed)
    ours = prng.PRNGKey(seed)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(k))
    for num in (2, 5):
        np.testing.assert_array_equal(prng.split(ours, num).numpy(),
                                      np.asarray(jax.random.split(k, num)))
    data = [0, 1, 123, 2047, 2 ** 31 + 5, 2 ** 32 - 1]
    want = np.stack([np.asarray(jax.random.fold_in(k, d)) for d in data])
    got = prng.fold_in(ours[None, :].expand(len(data), 2),
                       torch.tensor(data, dtype=torch.int64))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [1, 7, 1000])
def test_bits_uniforms_gumbel_categorical_match_jax(n):
    keys = _jax_keys(3, 5)
    ours = prng.as_key(keys)
    jb = np.stack([np.asarray(jax.random.bits(jnp.asarray(k), (n,),
                                              jnp.uint32)) for k in keys])
    np.testing.assert_array_equal(prng.bits(ours, n).numpy(),
                                  jb.astype(np.int64))
    # the ranges the samplers draw on (a wider one is a product and a sum,
    # which XLA may contract into one rounding)
    for lo, hi in ((0.0, 1.0), (TINY, 1.0)):
        ju = np.stack([np.asarray(jax.random.uniform(
            jnp.asarray(k), (n,), jnp.float32, lo, hi)) for k in keys])
        np.testing.assert_array_equal(prng.uniform(ours, n, lo, hi).numpy(),
                                      ju)
    jg = np.stack([np.asarray(jax.random.gumbel(jnp.asarray(k), (n,),
                                                jnp.float32)) for k in keys])
    assert _ulps(prng.gumbel(ours, n).numpy(), jg).max() <= 2.0
    logits = np.random.default_rng(n).normal(size=(5, n)).astype(np.float32)
    jc = [int(jax.random.categorical(jnp.asarray(k), jnp.asarray(row)))
          for k, row in zip(keys, logits)]
    assert prng.categorical(ours, torch.from_numpy(logits)).tolist() == jc


# --------------------------------------------------------------------------- #
# the samplers
# --------------------------------------------------------------------------- #


def _sampling_inputs(B, V, seed=0):
    rng = np.random.default_rng(seed)
    logits = (3.0 * rng.normal(size=(B, V))).astype(np.float32)
    temp = np.resize(np.float32([0.8, 0.0, 1.0, 0.5, 0.8, 1.3]), B)
    top_k = np.resize(np.int32([0, 0, 5, 40, 0, 3]), B)
    top_p = np.resize(np.float32([1.0, 1.0, 0.9, 0.95, 0.6, 1.0]), B)
    return logits, temp, top_k, top_p


def test_sample_rowkeys_matches_jax():
    B, V = 6, 128
    logits, temp, top_k, top_p = _sampling_inputs(B, V)
    logits[4, 9] = np.nan  # a poisoned sampled row: its sanitized argmax
    keys = _jax_keys(11, B)
    want = np.asarray(_JAX_ROWKEYS(jnp.asarray(logits), jnp.asarray(keys),
                                   temp, top_k, top_p))
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    got = sampling.sample_rowkeys(t(logits), prng.as_key(keys), t(temp),
                                  t(top_k), t(top_p))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # a row drawn alone is the same row of the batch
    for b in range(B):
        alone = sampling.sample_rowkeys(
            t(logits[b:b + 1]), prng.as_key(keys[b:b + 1]),
            t(temp[b:b + 1]), t(top_k[b:b + 1]), t(top_p[b:b + 1]))
        assert int(alone[0]) == int(want[b])
    # an all-greedy batch is the sanitized argmax, with or without the hint
    zero = np.zeros(B, np.float32)
    greedy = np.asarray(_JAX_ROWKEYS(jnp.asarray(logits), jnp.asarray(keys),
                                     zero, top_k, top_p))
    for hint in (None, True):
        np.testing.assert_array_equal(sampling.sample_rowkeys(
            t(logits), None if hint else prng.as_key(keys), t(zero),
            t(top_k), t(top_p), greedy_only=hint).numpy(), greedy)


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_speculative_match_matches_jax(ragged, temperature):
    """Drafts made of the JAX chain's own draws, spoiled at one column per
    row (none, the first, the middle, never): whole, partial and empty
    accepts."""
    B, S, V = 4, 4, 64
    G = S - 1
    logits, _, top_k, top_p = _sampling_inputs(B * S, V, seed=5)
    logits = logits.reshape(B, S, V)
    temp = np.float32([temperature, temperature, 0.0, temperature])
    top_k, top_p = top_k[:B], top_p[:B]
    base = _jax_keys(13, B)
    positions = (np.int32([[3], [17], [0], [40]])
                 + np.arange(S, dtype=np.int32)[None, :])
    draft_len = np.int32([3, 2, 0, 1]) if ragged else None
    chain, _ = _JAX_MATCH(jnp.asarray(logits), jnp.zeros((B, G), jnp.int32),
                          jnp.asarray(base), jnp.asarray(positions), temp,
                          top_k, top_p, None)
    # emitted[:, 0] of an all-mismatch draft is the chain's first draw;
    # draw the rest of the chain the same way, one column at a time
    want_chain = np.zeros((B, S), np.int32)
    for i in range(S):
        keys = np.stack([np.asarray(jax.random.fold_in(jnp.asarray(k), p))
                         for k, p in zip(base, positions[:, i])])
        want_chain[:, i] = np.asarray(_JAX_ROWKEYS(
            jnp.asarray(logits[:, i]), jnp.asarray(keys), temp, top_k,
            top_p))
    assert np.asarray(chain)[:, 0].tolist() == want_chain[:, 0].tolist()
    draft = want_chain[:, :G].copy()
    for b, col in enumerate((None, 0, 1, None)):
        if col is not None:
            draft[b, col] = (draft[b, col] + 1) % V
    jargs = (jnp.asarray(logits), jnp.asarray(draft), jnp.asarray(base),
             jnp.asarray(positions), temp, top_k, top_p,
             None if draft_len is None else jnp.asarray(draft_len))
    jem, jct = _JAX_MATCH(*jargs)
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    em, ct = sampling.speculative_match(
        t(logits), t(draft), prng.as_key(base), t(positions), t(temp),
        t(top_k), t(top_p), None if draft_len is None else t(draft_len))
    np.testing.assert_array_equal(em.numpy(), np.asarray(jem))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(jct))
    # the emitted run is the chain, whatever was drafted
    for b in range(B):
        n = int(ct[b])
        assert em[b, :n].tolist() == want_chain[b, :n].tolist()


# --------------------------------------------------------------------------- #
# the slot schedule through the batchers
# --------------------------------------------------------------------------- #


def _requests(mod_request, temp=0.8):
    """Mixed lengths and settings: two sampled rows with filters, a greedy
    one; one prompt longer than the chunk, so chunked prefill runs."""
    k = dict(top_k=40, top_p=0.95)
    long = [(5 * i + 2) % 127 + 1 for i in range(20)]
    return [mod_request("a", [5, 9, 5, 9, 5, 9], max_new_tokens=19,
                        temperature=temp, **k),
            mod_request("b", [7, 3, 7, 3, 7], max_new_tokens=13,
                        temperature=0.0),
            mod_request("c", long, max_new_tokens=9, temperature=temp, **k),
            mod_request("d", [11, 12, 11, 12], max_new_tokens=6,
                        temperature=temp, **k)]


def _port_engine(block=4, spec_len=0, layout="contiguous", **kw):
    cfg = Config.from_dict({"model": MODEL, "inference": {
        "decode_block_len": block, "prefill_chunk": 8, "attend_impl": "flash",
        "kv_layout": layout, "kv_page_len": 8, "key_schedule": "slot"}})
    return InferenceEngine(cfg, "cpu", slots=SLOTS, max_seq_len=MAX_LEN,
                           spec_len=spec_len, **kw)


def _streams(results) -> dict:
    return {u: (r.tokens, r.finish_reason) for u, r in results.items()}


@pytest.fixture(scope="module")
def jax_slot_streams(tiny):
    """The JAX batcher's slot-schedule streams (seed 7, block 4)."""
    jcfg, jparams, _ = tiny
    eng = JaxEngine(jcfg, slots=SLOTS, max_seq_len=MAX_LEN,
                    decode_block_len=4, prefill_chunk=8, attend_impl="dense",
                    key_schedule="slot")
    return _streams(JaxBatcher(eng, eng.shard_params(jparams), seed=7).run(
        _requests(JaxRequest)))


@pytest.mark.parametrize("case", ["block4", "block2", "spec3", "paged",
                                  "sample_on_device"])
def test_slot_streams_match_jax_and_round_structure(tiny, jax_slot_streams,
                                                    case):
    kw = {"block4": {}, "block2": {"block": 2},
          "spec3": {"block": 1, "spec_len": 3},
          "paged": {"layout": "paged"},
          "sample_on_device": {"sample_on_device": True}}[case]
    engine = _port_engine(**kw)
    assert engine.key_schedule == "slot"
    got = _streams(ContinuousBatcher(engine, tiny[2], seed=7).run(
        _requests(Request)))
    assert got == jax_slot_streams
    assert {u: len(t) for u, (t, _) in got.items()} == {
        "a": 19, "b": 13, "c": 9, "d": 6}


def test_slot_base_keys_are_the_jax_admission_chain(tiny):
    """One split of ``PRNGKey(seed)`` per admission, in admission order, as
    the JAX batcher takes them: the slots' base keys after the first
    round are the JAX batcher's."""
    jcfg, jparams, params = tiny
    jeng = JaxEngine(jcfg, slots=SLOTS, max_seq_len=MAX_LEN,
                     decode_block_len=4, prefill_chunk=8, key_schedule="slot")
    jb = JaxBatcher(jeng, jeng.shard_params(jparams), seed=7)
    b = ContinuousBatcher(_port_engine(), params, seed=7)
    for batcher, mod in ((jb, JaxRequest), (b, Request)):
        for r in _requests(mod):
            batcher.submit(r)
        batcher.step()
    np.testing.assert_array_equal(b._base_keys,
                                  jb._base_keys.astype(np.int64))


# --------------------------------------------------------------------------- #
# decode_step and sampling in the dispatch
# --------------------------------------------------------------------------- #


PROMPTS = ([5, 9, 5, 9, 5, 9], [7, 3, 7], [1, 2, 3, 4, 5, 6, 7, 8, 9, 10])


def _parked(engine, params, prompts, sample=None):
    """A cache with ``prompts`` parked in the first slots (one-shot
    prefills, drawing with ``sample`` on a ``sample_on_device`` engine),
    and their last tokens."""
    cache = engine.init_cache()
    for s, p in enumerate(prompts):
        cache = engine.insert(cache, engine.prefill(params, p,
                                                    sample=sample)[0],
                              s, len(p))
    last = np.zeros(engine.slots, np.int32)
    last[:len(prompts)] = [p[-1] for p in prompts]
    return cache, last


@pytest.mark.parametrize("sample_on_device", [False, True])
def test_decode_step_matches_jax(tiny, sample_on_device):
    """Greedy steps: the same tokens and logits (rtol 2e-4) as the JAX
    engine's ``decode_step``, parked slots one row longer each step, free
    slots at 0; no logits on a ``sample_on_device`` engine."""
    jcfg, jparams, params = tiny
    jeng = JaxEngine(jcfg, slots=4, max_seq_len=MAX_LEN, attend_impl="dense",
                     sample_on_device=sample_on_device)
    jp = jeng.shard_params(jparams)
    eng = InferenceEngine(Config.from_dict({"model": MODEL}), "cpu", slots=4,
                          max_seq_len=MAX_LEN,
                          sample_on_device=sample_on_device)
    greedy = (0.0, 0, 1.0) if sample_on_device else None
    cache, tok = _parked(eng, params, PROMPTS, greedy and (
        torch.Generator(), *greedy))
    jcache, jtok = _parked(jeng, jp, PROMPTS, greedy and (
        jax.random.PRNGKey(0), *greedy))
    zero = np.zeros(4, np.float32)
    k0, p1 = np.zeros(4, np.int32), np.ones(4, np.float32)
    gen = torch.Generator().manual_seed(0)
    for step in range(3):
        cache, nxt, logits = eng.decode_step(params, cache, tok, gen, zero,
                                             k0, p1)
        jcache, jnxt, jlogits = jeng.decode_step(
            jp, jcache, jtok, jax.random.PRNGKey(step), zero, k0, p1)
        np.testing.assert_array_equal(nxt.numpy()[:3], np.asarray(jnxt)[:3])
        if sample_on_device:
            assert logits is None and jlogits is None
        else:
            np.testing.assert_allclose(logits.numpy()[:3],
                                       np.asarray(jlogits)[:3], rtol=2e-4,
                                       atol=2e-4)
        tok, jtok = nxt.numpy(), np.asarray(jnxt)
        want = [len(p) + step + 1 for p in PROMPTS] + [0]
        assert cache["lengths"].tolist() == want
        np.testing.assert_array_equal(np.asarray(jcache["lengths"]), want)


def test_decode_step_and_sampling_refusals_match_jax(tiny):
    jcfg, jparams, params = tiny
    jslot = JaxEngine(jcfg, slots=2, max_seq_len=MAX_LEN, key_schedule="slot")
    slot = _port_engine()
    with pytest.raises(ValueError) as theirs:
        jslot.decode_step(None, None, np.zeros(2), None, np.zeros(2),
                          np.zeros(2), np.ones(2))
    with pytest.raises(ValueError) as ours:
        slot.decode_step(params, slot.init_cache(), np.zeros(SLOTS), None,
                         np.zeros(SLOTS), np.zeros(SLOTS), np.ones(SLOTS))
    assert str(ours.value) == str(theirs.value)
    # base keys of the wrong shape
    bad = np.zeros((SLOTS + 1, 2), np.uint32)
    with pytest.raises(ValueError, match=r"per-slot base keys \[slots, 2\] = "
                                         rf"\[{SLOTS}, 2\]; got "
                                         rf"\({SLOTS + 1}, 2\)"):
        slot.decode_block(params, slot.init_cache(), np.zeros(SLOTS), bad,
                          np.full(SLOTS, -1), np.zeros(SLOTS),
                          np.zeros(SLOTS), np.zeros(SLOTS), np.ones(SLOTS))
    # where a prefill samples: the caller and the engine must agree
    for on in (False, True):
        jeng = JaxEngine(jcfg, slots=2, max_seq_len=MAX_LEN,
                         sample_on_device=on)
        eng = InferenceEngine(Config.from_dict({"model": MODEL}), "cpu",
                              slots=2, max_seq_len=MAX_LEN,
                              sample_on_device=on)
        sample = None if on else (torch.Generator(), 0.0, 0, 1.0)
        jsample = None if on else (jax.random.PRNGKey(0), 0.0, 0, 1.0)
        with pytest.raises(ValueError) as theirs:
            jeng.prefill(jparams, [1, 2, 3], sample=jsample)
        with pytest.raises(ValueError) as ours:
            eng.prefill(params, [1, 2, 3], sample=sample)
        assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_sample_on_device_prefills_match_jax(tiny, layout):
    """The prefill family's token on a ``sample_on_device`` engine: greedy,
    the JAX engine's; sampled under a slot key, the JAX epilogue's draw
    with the same key; a round-keyed draw, the token the batcher draws
    from the returned logits with the same generator state."""
    jcfg, jparams, params = tiny
    prompt = [(3 * i + 1) % 127 for i in range(13)]  # chunked: 8 + 5
    jeng = JaxEngine(jcfg, slots=2, max_seq_len=MAX_LEN, attend_impl="dense",
                     prefill_chunk=8, kv_layout=layout, kv_page_len=8,
                     sample_on_device=True)
    jp = jeng.shard_params(jparams)
    cfg = Config.from_dict({"model": MODEL, "inference": {
        "prefill_chunk": 8, "kv_layout": layout, "kv_page_len": 8}})
    on = InferenceEngine(cfg, "cpu", slots=2, max_seq_len=MAX_LEN,
                         sample_on_device=True)
    off = InferenceEngine(cfg, "cpu", slots=2, max_seq_len=MAX_LEN)
    key = prng.fold_in(prng.PRNGKey(5), len(prompt) - 1)
    jkey = jax.random.fold_in(jax.random.PRNGKey(5), len(prompt) - 1)
    for temp in (0.0, 0.8):
        jsample = (jkey, temp, 0, 0.9)
        if layout == "paged":
            got = on.prefill_paged(params, on.init_cache(), prompt, 0,
                                   sample=(key, temp, 0, 0.9))[1]
            want = jeng.prefill_paged(jp, jeng.init_cache(), prompt, 0,
                                      sample=jsample)[1]
        else:
            got = on.prefill_chunked(params, on.init_cache(), prompt, 0,
                                     sample=(key, temp, 0, 0.9))[1]
            want = jeng.prefill_chunked(jp, jeng.init_cache(), prompt, 0,
                                        sample=jsample)[1]
            one = on.prefill(params, prompt[:5],
                             sample=(key, temp, 0, 0.9))[1]
            jone = jeng.prefill(jp, prompt[:5], sample=jsample)[1]
            assert one.tolist() == np.asarray(jone).tolist()
        assert got.dtype == torch.int32
        assert got.tolist() == np.asarray(want).tolist()
        # round-keyed: the same draw as from the returned logits
        g1, g2 = torch.Generator().manual_seed(3), torch.Generator()
        g2.manual_seed(3)
        tok = on.prefill(params, prompt[:5], sample=(g1, temp, 0, 0.9))[1]
        logits = off.prefill(params, prompt[:5])[1]
        host = sampling.sample(logits, g2, torch.tensor([temp]),
                               torch.tensor([0], dtype=torch.int32),
                               torch.tensor([0.9]))
        assert tok.tolist() == host.tolist()


def test_sample_on_device_batcher_streams_match_host_sampling(tiny):
    """Round schedule, sampled and greedy rows: the batcher's streams with
    sampling in the dispatch equal those without it (one generator, the
    same draws)."""
    def run(on):
        cfg = Config.from_dict({"model": MODEL, "inference": {
            "prefill_chunk": 8, "decode_block_len": 3,
            "sample_on_device": on}})
        eng = InferenceEngine(cfg, "cpu", slots=SLOTS, max_seq_len=MAX_LEN)
        return _streams(ContinuousBatcher(eng, tiny[2], seed=4).run(
            _requests(Request)))

    assert run(True) == run(False)


# --------------------------------------------------------------------------- #
# live_tokens, the schedule's resolution
# --------------------------------------------------------------------------- #


def test_live_tokens_matches_jax(tiny):
    jcfg, jparams, params = tiny
    jeng = JaxEngine(jcfg, slots=4, max_seq_len=MAX_LEN)
    eng = InferenceEngine(Config.from_dict({"model": MODEL}), "cpu", slots=4,
                          max_seq_len=MAX_LEN)
    cache, _ = _parked(eng, params, PROMPTS)
    jcache, _ = _parked(jeng, jeng.shard_params(jparams), PROMPTS)
    got = kv_cache.live_tokens(cache)
    assert int(got) == int(jax_kv_cache.live_tokens(jcache)) == sum(
        map(len, PROMPTS))
    assert int(kv_cache.live_tokens(eng.release(cache, 1))) == 16


@pytest.mark.parametrize("schedule,feature", [
    *[pytest.param(s, None, id=str(s))
      for s in (None, "auto", "round", "slot", "bogus")],
    *[pytest.param(s, f, id=f"{f}-{s}")
      for f in ("overlap", "mixed_dispatch")
      for s in (None, "auto", "round", "slot")]])
def test_key_schedule_resolution_matches_jax(tiny, schedule, feature):
    """The schedule an engine resolves, and its refusals, as the JAX
    engine's: "auto" is "slot" under overlap or mixed dispatch, and either
    refuses "round", from the engine's keywords and from the config (the
    config's own messages)."""
    jcfg = tiny[0]
    cfg = Config.from_dict({"model": MODEL})
    kw = {feature: True} if feature else {}
    inf = {**kw} if schedule is None else {**kw, "key_schedule": schedule}
    try:
        want = JaxEngine(jcfg, slots=2, max_seq_len=MAX_LEN,
                         key_schedule=schedule, **kw).key_schedule
    except ValueError as theirs:
        with pytest.raises(ValueError) as ours:
            InferenceEngine(cfg, "cpu", slots=2, max_seq_len=MAX_LEN,
                            key_schedule=schedule, **kw)
        assert str(ours.value) == str(theirs)
        # and through the config file, with the config's message
        with pytest.raises(ValueError) as theirs_cfg:
            JaxConfig.from_dict({"inference": inf})
        with pytest.raises(ValueError) as ours_cfg:
            Config.from_dict({"inference": inf})
        assert str(ours_cfg.value) == str(theirs_cfg.value)
        return
    eng = InferenceEngine(cfg, "cpu", slots=2, max_seq_len=MAX_LEN,
                          key_schedule=schedule, **kw)
    assert eng.key_schedule == want
    assert (eng.overlap, eng.mixed) == (feature == "overlap",
                                        feature == "mixed_dispatch")
    if inf:
        raw = {"model": MODEL, "inference": inf}
        eng = InferenceEngine(Config.from_dict(raw), "cpu", slots=2,
                              max_seq_len=MAX_LEN)
        assert eng.key_schedule == want
        assert (eng.overlap, eng.mixed) == (feature == "overlap",
                                            feature == "mixed_dispatch")


@pytest.mark.parametrize("schedule", ["round", "slot"])
def test_generate_cli_samples_on_device(tmp_path, capsys, schedule):
    """``generate --sample-on-device`` prints the streams it prints
    without the flag (sampled at temperature 0.8, on either schedule)."""
    from picotron_tpu_torch.tools import generate

    path = tmp_path / "tiny.json"
    path.write_text(json.dumps({
        "model": {**MODEL, "num_hidden_layers": 1},
        "inference": {"attend_impl": "flash", "prefill_chunk": 8,
                      "key_schedule": schedule},
        "training": {"seq_length": 48}}))
    argv = ["--config", str(path), "--random-init", "--seed", "3",
            "--prompt-ids", "1,2,3,1,2,3,1,2", "--prompt-ids",
            ",".join(str(i % 60 + 1) for i in range(13)),
            "--max-new-tokens", "9", "--slots", "2", "--temperature", "0.8"]
    assert generate.main(argv, device="cpu") == 0
    off = capsys.readouterr().out
    assert generate.main(argv + ["--sample-on-device"], device="cpu") == 0
    on = capsys.readouterr().out
    streams = re.compile(r"^\[req\d\] .*$", re.M)
    assert len(streams.findall(on)) == 2
    assert streams.findall(on) == streams.findall(off)
