"""The port's mixed prefill lane (``inference.mixed_dispatch``) against its
serial scheduler and the JAX package's lane, on the CPU.

Weights are drawn by the JAX package (a tiny fp32 model) and carried
across with ``convert.params_from_jax``; every other input is made from a
seed with numpy, and both sides take the same values. The JAX batcher
runs once per case in a module fixture. Both sides key sampled tokens by
the slot schedule, and the lane's chunk is the serial chunk's own
computation, so fusing it into a decode or verify dispatch moves no bit:

- the engine: ``decode_block(..., lanes=)`` and ``verify(..., lanes=)``
  against the JAX engine's, chunk after chunk of one prompt beside two
  decoding slots: the emitted tokens, counts, ``next_tok``, the lane's
  logits (or, on a ``sample_on_device`` engine, its token), the cache
  lengths and the lane slot's K/V rows (fp32, within 2e-4, as
  ``tests/test_torch_engine.py`` holds the engine), contiguous and paged;
- the streams: the lane, and the lane under the overlap pipeline, equal
  the port's serial streams and the JAX package's lane with overlap,
  token for token, greedy and at temperature 0.8, on ``decode_block``
  (contiguous and paged) and on the n-gram ``verify``;
- the contracts: a lane chunk is a prefill dispatch, as a serial chunk is
  (and no solo prefill stalls a decoder); a cold prompt at or under one
  chunk still prefills alone; a failing slot is isolated while the lane
  runs, its chunk re-run with the same bytes; ``lanes=`` on an engine
  without mixed dispatch, malformed lanes and mixed dispatch under
  ``key_schedule: "round"`` are refused with the JAX package's messages.
"""

import jax
import numpy as np
import pytest
import torch

from conftest import make_config
from picotron_tpu.config import Config as JaxConfig
from picotron_tpu.inference import ContinuousBatcher as JaxBatcher
from picotron_tpu.inference import InferenceEngine as JaxEngine
from picotron_tpu.inference import Request as JaxRequest
from picotron_tpu.inference import paged_kv as jax_paged
from picotron_tpu.models import llama as jax_llama
from picotron_tpu_torch import convert
from picotron_tpu_torch.config import Config
from picotron_tpu_torch.inference import paged_kv
from picotron_tpu_torch.inference.batcher import ContinuousBatcher, Request
from picotron_tpu_torch.inference.engine import InferenceEngine
from picotron_tpu_torch.resilience.chaos import ServingChaos

MODEL = dict(num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, hidden_size=32, intermediate_size=64,
             vocab_size=128, max_position_embeddings=96, rope_theta=10000.0,
             dtype="float32", attention_impl="sdpa")
MAX_LEN = 96
SLOTS = 3
BLOCK = 4
CHUNK = 8
SPEC_LEN = 3
RTOL = ATOL = 2e-4  # fp32 on both sides; sums reassociate between XLA and torch
CASES = [(p, lay, t) for p, lay in (("block", "contiguous"),
                                    ("block", "paged"),
                                    ("verify", "contiguous"))
         for t in (0.0, 0.8)]


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


def _long(n, a=5, b=2):
    return [(a * i + b) % 127 + 1 for i in range(n)]


def _requests(mod_request, program="block", temp=0.0):
    """Three prompts over one chunk (lane-worthy: 20, 17 and 10 tokens)
    and a cold short one, which prefills alone, for three slots; the
    verify traffic repeats itself (the n-gram drafter accepts there)."""
    k = dict(temperature=temp, top_k=0 if temp == 0 else 40, top_p=0.95)
    if program == "verify":
        prompts = ([5, 9] * 10, [7, 3, 7] * 6, [11, 12] * 5,
                   [3, 1, 4, 3, 1, 4, 3])
        news = (14, 10, 4, 9)
    else:
        prompts = (_long(20), _long(17, 3, 7), [11, 12] * 5, [3, 1, 4])
        news = (14, 10, 4, 6)
    return [mod_request(u, list(p), max_new_tokens=n, **k)
            for u, p, n in zip("abcd", prompts, news)]


def _engine(mixed, overlap=False, layout="contiguous", spec_len=0,
            hooks=None, **kw):
    cfg = Config.from_dict({"model": MODEL, "inference": {
        "decode_block_len": BLOCK, "prefill_chunk": CHUNK,
        "attend_impl": "flash", "kv_layout": layout, "kv_page_len": 8,
        "key_schedule": "slot"}})
    return InferenceEngine(cfg, "cpu", slots=SLOTS, max_seq_len=MAX_LEN,
                           spec_len=spec_len, mixed_dispatch=mixed,
                           overlap=overlap, hooks=hooks, **kw)


def _streams(results) -> dict:
    return {u: (r.tokens, r.finish_reason) for u, r in results.items()}


def _run(params, mixed, overlap=False, program="block", layout="contiguous",
         temp=0.0, reqs=None, hooks=None):
    eng = _engine(mixed, overlap, layout,
                  SPEC_LEN if program == "verify" else 0, hooks)
    b = ContinuousBatcher(eng, params, seed=7, sleep=lambda s: None)
    res = b.run([Request(**vars(r)) for r in reqs] if reqs is not None
                else _requests(Request, program, temp))
    return _streams(res), b


@pytest.fixture(scope="module")
def jax_streams(tiny):
    """The JAX lane's streams under overlap, for every case of ``CASES``."""
    jcfg, jparams, _ = tiny
    out = {}
    for program, layout in {(p, lay) for p, lay, _ in CASES}:
        eng = JaxEngine(jcfg, slots=SLOTS, max_seq_len=MAX_LEN,
                        decode_block_len=BLOCK, prefill_chunk=CHUNK,
                        attend_impl="dense", kv_layout=layout, kv_page_len=8,
                        spec_len=SPEC_LEN if program == "verify" else 0,
                        key_schedule="slot", mixed_dispatch=True,
                        overlap=True)
        params = eng.shard_params(jparams)
        for temp in (0.0, 0.8):
            b = JaxBatcher(eng, params, seed=7)
            out[program, layout, temp] = _streams(b.run(
                _requests(JaxRequest, program, temp)))
    return out


# --------------------------------------------------------------------------- #
# the engine: decode_block and verify with a lane, against the JAX engine's
# --------------------------------------------------------------------------- #


def _lane_rows(eng, cache, slot, n, jax_side):
    """The lane slot's first ``n`` K and V rows, [L, n, Hkv, D] each."""
    if eng.paged is not None:
        mod = jax_paged if jax_side else paged_kv
        return [np.asarray(mod.slot_rows(cache, eng.paged.tables, slot, n,
                                         name)) for name in ("k", "v")]
    return [np.asarray(cache[name])[:, slot, :n] for name in ("k", "v")]


@pytest.mark.parametrize("program,layout,sample_on_device", [
    ("block", "contiguous", False), ("block", "paged", False),
    ("verify", "contiguous", False), ("verify", "paged", False),
    ("block", "contiguous", True)])
def test_lane_engine_outputs_match_jax(tiny, program, layout,
                                       sample_on_device):
    """Slots 0 and 1 decode (one sampled, one greedy) while slot 2's
    20-token prompt goes through the lane in chunks of 8, 8 and 4: each
    dispatch's outputs, the lengths and the lane's K/V rows agree."""
    jcfg, jparams, params = tiny
    spec = SPEC_LEN if program == "verify" else 0
    jeng = JaxEngine(jcfg, slots=SLOTS, max_seq_len=MAX_LEN,
                     decode_block_len=BLOCK, prefill_chunk=CHUNK,
                     attend_impl="dense", kv_layout=layout, kv_page_len=8,
                     spec_len=spec, key_schedule="slot", mixed_dispatch=True,
                     sample_on_device=sample_on_device)
    jparams = jeng.shard_params(jparams)
    eng = _engine(True, layout=layout, spec_len=spec,
                  sample_on_device=sample_on_device)
    rng = np.random.default_rng(11)
    keys = rng.integers(0, 2 ** 32, (SLOTS, 2), dtype=np.uint64).astype(
        np.uint32)
    lane_key = rng.integers(0, 2 ** 32, 2, dtype=np.uint64).astype(np.uint32)
    parked = [rng.integers(1, 127, n).tolist() for n in (6, 5)]
    drafts = rng.integers(1, 127, (3, SLOTS, SPEC_LEN)).astype(np.int32)
    prompt = _long(20)
    caches = []
    for e, p in ((eng, params), (jeng, jparams)):
        cache = e.init_cache()
        for slot, ids in enumerate(parked):
            sample = ({"sample": (keys[slot], 0.0, 0, 1.0)}
                      if sample_on_device else {})
            cache = e.insert(cache, e.prefill(p, ids, **sample)[0], slot,
                             len(ids))
        caches.append(cache)
    eos = np.full(SLOTS, -1, np.int32)
    budget = np.array([9, 7, 0], np.int32)
    temp = np.array([0.8, 0.0, 0.0], np.float32)
    top_k = np.array([40, 0, 0], np.int32)
    top_p = np.array([0.95, 1.0, 1.0], np.float32)
    last = np.array([17, 23, 0], np.int32)
    for r, (s0, end) in enumerate(((0, 8), (8, 16), (16, 20))):
        lane = {"slot": 2, "tokens": prompt[s0:end], "start": s0}
        if sample_on_device:
            lane.update(key=lane_key, temperature=0.8, top_k=40, top_p=0.95)
        outs = []
        for k, (e, p) in enumerate(((eng, params), (jeng, jparams))):
            if program == "verify":
                toks = np.concatenate([last[:, None], drafts[r]], axis=1)
                out = e.verify(p, caches[k], toks, keys, eos, budget, temp,
                               top_k, top_p,
                               draft_len=np.array([3, 2, 0], np.int32),
                               lanes=[lane])
            else:
                out = e.decode_block(p, caches[k], last, keys, eos, budget,
                                     temp, top_k, top_p, lanes=[lane])
            caches[k] = out[0]
            outs.append([np.asarray(o) for o in out[1:]])
        got, want = outs
        assert len(got) == len(want)
        # tokens, counts[, accepted], next_tok: the same; the lane's logits
        # within the tolerance, its token the same
        for g, w in zip(got[:-1], want[:-1]):
            np.testing.assert_array_equal(g, w)
        if sample_on_device:
            np.testing.assert_array_equal(got[-1], want[-1])
        else:
            np.testing.assert_allclose(got[-1], want[-1], rtol=RTOL,
                                       atol=ATOL)
        np.testing.assert_array_equal(np.asarray(caches[0]["lengths"]),
                                      np.asarray(caches[1]["lengths"]))
        assert int(caches[0]["lengths"][2]) == end
        for g, w in zip(_lane_rows(eng, caches[0], 2, end, False),
                        _lane_rows(jeng, caches[1], 2, end, True)):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
        counts = got[1]
        last = np.where(counts > 0, got[-2], last).astype(np.int32)
        budget = np.maximum(budget - counts, 0).astype(np.int32)
        if eng.paged is not None:  # what the batcher's land does
            eng.paged.set_len(2, end)
            jeng.paged.set_len(2, end)


# --------------------------------------------------------------------------- #
# the streams: the lane (with and without overlap) = serial = the JAX lane
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("program,layout,temp", CASES)
def test_lane_streams_match_serial_and_jax(tiny, jax_streams, program,
                                           layout, temp):
    params = tiny[2]
    off, b_off = _run(params, False, program=program, layout=layout,
                      temp=temp)
    mixed, b_mixed = _run(params, True, program=program, layout=layout,
                          temp=temp)
    both, b_both = _run(params, True, True, program, layout, temp)
    assert mixed == off == both == jax_streams[program, layout, temp]
    for b in (b_mixed, b_both):
        assert b.lane_tokens > 0
        st = b.stats()
        assert st["mixed"] == {"enabled": True, "lanes_active": 0}
        assert st["prefill_lane_tokens"] == b.lane_tokens
        assert all(s is None for s in b._slots) and b._inflight is None
        assert b.prefill_dispatches == b_off.prefill_dispatches
        if layout == "paged":
            assert (st["prefix_hits"], st["prefix_cached_tokens"]) == (
                b_off.stats()["prefix_hits"],
                b_off.stats()["prefix_cached_tokens"])
    assert b_off.lane_tokens == 0


# --------------------------------------------------------------------------- #
# the lane's contracts
# --------------------------------------------------------------------------- #


def test_lane_chunks_count_as_the_serial_chunks(tiny):
    """The 20-, 17- and 10-token prompts at chunk 8 are 3 + 3 + 2 chunks
    either way; the lane takes every prompt token, and no solo prefill
    stalls a seated decoder (serially, the second and third do)."""
    reqs = _requests(Request)[:3]
    _, b_off = _run(tiny[2], False, reqs=reqs)
    _, b_on = _run(tiny[2], True, reqs=reqs)
    assert b_on.prefill_dispatches == b_off.prefill_dispatches == 8
    assert b_on.lane_tokens == 20 + 17 + 10
    assert b_off.decode_stalls >= 1 and b_off.decode_stall_s > 0
    assert b_on.decode_stalls == 0 and b_on.decode_stall_s == 0.0


def test_cold_short_prompt_admits_alone(tiny):
    reqs = [Request("s", [3, 1, 4], max_new_tokens=6),
            Request("l", _long(20), max_new_tokens=6)]
    off, _ = _run(tiny[2], False, reqs=reqs)
    on, b = _run(tiny[2], True, reqs=reqs)
    assert on == off
    assert b.lane_tokens == 20


@pytest.mark.parametrize("overlap", [False, True])
def test_lane_isolates_a_failing_slot(tiny, overlap):
    """Every dispatch with slot 1 decoding fails ("b", seated there through
    the lane): the isolation's solo dispatches run the lane's chunk again
    (the same rows, the same bytes), "b" ends "error", and "a" and "c"
    keep the fault-free streams."""
    reqs = _requests(Request, temp=0.8)[:3]
    clean, _ = _run(tiny[2], True, overlap, reqs=reqs)
    hooks = ServingChaos(Config.from_dict({"resilience": {
        "chaos_dispatch_fail_slot": 1}}).resilience, sleep=lambda s: None)
    on, b = _run(tiny[2], True, overlap, reqs=reqs, hooks=hooks)
    assert on["b"][1] == "error"
    assert on["b"][0] == clean["b"][0][: len(on["b"][0])]
    for u in ("a", "c"):
        assert on[u] == clean[u]
    assert all(s is None for s in b._slots) and b._lanes == [None]
    assert not b._pending and b._inflight is None
    assert b.counters == {"admitted": 3, "completed": 2, "expired": 0,
                          "errored": 1, "shed": 0}


def _raise_same(ours, theirs) -> None:
    with pytest.raises(ValueError) as jerr:
        theirs()
    with pytest.raises(ValueError) as perr:
        ours()
    assert str(perr.value) == str(jerr.value)


def test_lane_refusals_match_jax(tiny):
    """``lanes=`` on an engine without mixed dispatch (``decode_block`` and
    ``verify``), malformed lanes on a mixed engine, and mixed dispatch
    under the round schedule, from the config and from the engine."""
    jcfg, jparams, params = tiny
    kw = dict(slots=SLOTS, max_seq_len=MAX_LEN, decode_block_len=BLOCK,
              prefill_chunk=CHUNK, spec_len=SPEC_LEN, key_schedule="slot")
    z = np.zeros(SLOTS, np.int32)
    f = np.ones(SLOTS, np.float32)
    keys = np.zeros((SLOTS, 2), np.uint32)
    toks = np.zeros((SLOTS, SPEC_LEN + 1), np.int32)
    for mixed, lanes in ((False, [None]),
                         (True, [None, None]),
                         (True, [{"slot": 5, "tokens": [1], "start": 0}]),
                         (True, [{"slot": 1, "tokens": [], "start": 0}]),
                         (True, [{"slot": 1, "tokens": list(range(9)),
                                  "start": 0}])):
        jeng = JaxEngine(jcfg, attend_impl="dense", mixed_dispatch=mixed,
                         **kw)
        eng = _engine(mixed, spec_len=SPEC_LEN)
        jp = jeng.shard_params(jparams)
        for e, p in ((eng, params), (jeng, jp)):
            e._cache_for_test = e.init_cache()
        _raise_same(
            lambda: eng.decode_block(params, eng._cache_for_test, z, keys,
                                     z - 1, z, f, z, f, lanes=lanes),
            lambda: jeng.decode_block(jp, jeng._cache_for_test, z, keys,
                                      z - 1, z, f, z, f, lanes=lanes))
        _raise_same(
            lambda: eng.verify(params, eng._cache_for_test, toks, keys,
                               z - 1, z, f, z, f, lanes=lanes),
            lambda: jeng.verify(jp, jeng._cache_for_test, toks, keys,
                                z - 1, z, f, z, f, lanes=lanes))
    raw = {"mixed_dispatch": True, "key_schedule": "round"}
    _raise_same(lambda: Config.from_dict({"inference": raw}),
                lambda: JaxConfig.from_dict({"inference": raw}))
    _raise_same(
        lambda: InferenceEngine(Config.from_dict({"model": MODEL}), "cpu",
                                slots=2, max_seq_len=MAX_LEN,
                                mixed_dispatch=True, key_schedule="round"),
        lambda: JaxEngine(jcfg, slots=2, max_seq_len=MAX_LEN,
                          mixed_dispatch=True, key_schedule="round"))


def test_generate_cli_serves_overlap_and_the_lane_from_the_config(
        tmp_path, capsys):
    """``inference.overlap`` and ``inference.mixed_dispatch`` in a config
    serve through ``generate``, which prints the streams it prints without
    them (a 12-token prompt through the lane at chunk 8, a short one
    alone)."""
    import json

    from picotron_tpu_torch.tools import generate

    outs = []
    for extra in ({}, {"overlap": True, "mixed_dispatch": True}):
        path = tmp_path / f"tiny{len(extra)}.json"
        path.write_text(json.dumps({
            "model": {**MODEL, "num_hidden_layers": 1},
            "inference": {"prefill_chunk": 8, "decode_block_len": 4,
                          "key_schedule": "slot", **extra},
            "training": {"seq_length": 48}}))
        rc = generate.main(["--config", str(path), "--random-init",
                            "--seed", "3", "--prompt-ids",
                            ",".join(str(t) for t in range(1, 13)),
                            "--prompt-ids", "5,6,7", "--max-new-tokens",
                            "8", "--slots", "2"], device="cpu")
        assert rc == 0
        outs.append([line for line in capsys.readouterr().out.splitlines()
                     if line.startswith("[req")])
    assert len(outs[0]) == 2 and outs[0] == outs[1]
