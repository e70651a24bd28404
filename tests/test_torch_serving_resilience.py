"""The port's fault-tolerant serving round, on the CPU.

Mirrors, at the batcher level, what the JAX package's serving suite holds
its batcher to (``tests/test_serving.py``, ``tests/test_inference.py``,
``tests/test_paged_kv.py``), on a tiny fp32 model with weights drawn by
the JAX package:

- ``ServingChaos`` counts rounds, fires, sleeps and poisons as the JAX
  class does, call for call;
- a transient dispatch fault, and a fault in the middle of a decode block
  (in-block step 2 of 4) or of a verify after its draws, retry to the
  fault-free bits: the engine restores the lengths, the paged host lengths
  and the generator a failed attempt advanced;
- a slot whose every dispatch fails finishes "error" with its prefill's
  token alone, and the other slots' streams are bit-identical to a
  fault-free run, greedy and sampled, on both key schedules, in decode
  blocks and in verifies; nothing leaks;
- a chaos run (a raise, a latency spike, NaN logits) accounts for every
  request and spares what runs after it; NaN logits give defined tokens;
- a prefill that keeps failing costs only its request; a retried paged
  prefill takes no page twice;
- deadlines free slots, which the queue refills (contiguous and paged);
- a lost cache empties the pool and the queue is served on; a lost device
  raises out of ``step()`` unretried.
"""

import contextlib

import jax
import numpy as np
import pytest
import torch

from conftest import make_config
from picotron_tpu.config import Config as JaxConfig
from picotron_tpu.models import llama as jax_llama
from picotron_tpu.resilience.chaos import ChaosError as JaxChaosError
from picotron_tpu.resilience.chaos import ServingChaos as JaxChaos
from picotron_tpu_torch import convert
from picotron_tpu_torch.config import Config
from picotron_tpu_torch.inference import paged_kv, sampling
from picotron_tpu_torch.inference.batcher import ContinuousBatcher, Request
from picotron_tpu_torch.inference.engine import CacheLost, InferenceEngine
from picotron_tpu_torch.inference.paged_kv import NULL_PAGE, PagedKV
from picotron_tpu_torch.resilience.chaos import ChaosError, ServingChaos

MODEL = dict(num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, hidden_size=32, intermediate_size=64,
             vocab_size=128, max_position_embeddings=64, rope_theta=10000.0,
             dtype="float32", attention_impl="sdpa")
MAX_LEN = 64


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Six test workers share the machine: keep torch to one thread here,
    and restore the old count."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def params():
    jcfg = make_config(MODEL, seq=32)
    jparams = jax.jit(lambda k: jax_llama.init_params(k, jcfg.model))(
        jax.random.PRNGKey(0))
    return convert.params_from_jax(jax.tree.map(np.asarray, jparams))


def _chaos(sleep=lambda s: None, **kw):
    return ServingChaos(Config.from_dict({"resilience": kw}).resilience,
                        sleep=sleep)


def _engine(slots=3, hooks=None, schedule="round", block=2, spec_len=0,
            layout="contiguous", **inf):
    cfg = Config.from_dict({"model": MODEL, "inference": {
        "decode_block_len": block, "prefill_chunk": 8, "attend_impl": "flash",
        "kv_layout": layout, "kv_page_len": 8, "key_schedule": schedule,
        **inf}})
    return InferenceEngine(cfg, "cpu", slots=slots, max_seq_len=MAX_LEN,
                           spec_len=spec_len, hooks=hooks)


def _batcher(engine, params, seed=7, **kw):
    return ContinuousBatcher(engine, params, seed=seed, sleep=lambda s: None,
                             **kw)


def _requests(n=3, temperature=0.8, max_new=10):
    # even-indexed requests sample, so with slot 1 faulted the survivors
    # hold a sampled row and a greedy one
    return [Request(f"q{i}", [3 + i, 7 + i, 11 + i, 3 + i, 7 + i],
                    max_new_tokens=max_new,
                    temperature=0.0 if i % 2 else temperature, top_p=0.95)
            for i in range(n)]


def _run(engine, params, reqs, **kw):
    b = _batcher(engine, params, **kw)
    return b, b.run([Request(**vars(r)) for r in reqs])


def _no_leaks(b):
    assert all(s is None for s in b._slots) and not b._pending
    assert b._cache["lengths"].tolist() == [0] * len(b._slots)
    if b.paged is not None:
        p = b.paged
        assert np.all(p.tables == NULL_PAGE) and np.all(p.host_len == 0)
        assert p.pool.live_count == p.radix.evictable_count()


# --------------------------------------------------------------------------- #
# the chaos hooks against the JAX class
# --------------------------------------------------------------------------- #


def test_serving_chaos_counts_rounds_like_jax():
    """The same calls into both hooks: the same rounds, raises, sleeps and
    poisonings (prefill kinds pass, every decode or verify attempt
    counts)."""
    kw = dict(chaos_dispatch_raise_round=3, chaos_dispatch_fail_slot=2,
              chaos_latency_round=2, chaos_latency_s=0.5,
              chaos_poison_logits_round=4)
    slept = {"ours": [], "theirs": []}
    ours = _chaos(sleep=slept["ours"].append, **kw)
    theirs = JaxChaos(JaxConfig.from_dict({"resilience": kw}).resilience,
                      sleep=slept["theirs"].append)
    calls = [("prefill", []), ("decode", [0, 1]), ("decode", [0, 1]),
             ("prefill_chunk", []), ("decode", [0]), ("verify", [0, 1]),
             ("decode", [2]), ("verify", [1, 2]), ("decode", [0]),
             ("verify", [0])]
    for kind, slots in calls:
        got = []
        for hook, err in ((ours, ChaosError), (theirs, JaxChaosError)):
            try:
                hook.before_dispatch(kind, slots)
                got.append(("ok", hook.poison_logits(kind)))
            except err as e:
                got.append(("raise", str(e)))
        assert got[0] == got[1], (kind, slots, got)
        assert ours.round == theirs.round
    assert slept["ours"] == slept["theirs"] == [0.5]
    assert ours._fired == theirs._fired == {"latency", "raise", "poison"}


# --------------------------------------------------------------------------- #
# retries: a transient fault, a fault mid-block, a fault after the draws
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("schedule", ["round", "slot"])
def test_transient_dispatch_fault_is_retried_bit_identical(params, schedule):
    reqs = _requests(3, max_new=20)
    _, clean = _run(_engine(schedule=schedule), params, reqs)
    chaos = _chaos(chaos_dispatch_raise_round=2)
    b, res = _run(_engine(schedule=schedule, hooks=chaos), params, reqs)
    assert "raise" in chaos._fired
    assert {u: r.tokens for u, r in res.items()} == {
        u: r.tokens for u, r in clean.items()}
    assert b.counters == {"admitted": 3, "completed": 3, "expired": 0,
                          "errored": 0, "shed": 0}


class _FailOnce:
    """Wraps a callable: the ``at``-th call raises once (after running the
    real call when ``after``), every other call runs it."""

    def __init__(self, fn, at, after=False):
        self.fn, self.at, self.after, self.calls = fn, at, after, 0

    def __call__(self, *a, **kw):
        self.calls += 1
        if self.calls == self.at and not self.after:
            raise ChaosError(f"injected fault at call {self.calls}")
        out = self.fn(*a, **kw)
        if self.calls == self.at:
            raise ChaosError(f"injected fault after call {self.calls}")
        return out


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("schedule", ["round", "slot"])
def test_fault_mid_block_retries_to_fault_free_bits(params, schedule,
                                                    layout):
    """decode_block_len 4: the second decode round's model step 2 raises
    after steps 0 and 1 advanced the lengths (and drew from the
    generator); the retry must start from the round's own start and give
    the fault-free bits."""
    reqs = _requests(3, max_new=16)
    _, clean = _run(_engine(schedule=schedule, block=4, layout=layout),
                    params, reqs)
    engine = _engine(schedule=schedule, block=4, layout=layout)
    engine._decode_core = _FailOnce(engine._decode_core, at=4 + 3)
    b, res = _run(engine, params, reqs)
    assert engine._decode_core.calls > 7
    assert {u: r.tokens for u, r in res.items()} == {
        u: r.tokens for u, r in clean.items()}
    assert b.counters["errored"] == 0
    _no_leaks(b)


@pytest.mark.parametrize("schedule", ["round", "slot"])
def test_fault_after_the_verify_draws_retries_bit_identical(params, schedule,
                                                            monkeypatch):
    """A verify that fails after its acceptance rule drew (round schedule:
    from the generator) retries to the fault-free bits."""
    reqs = _requests(3, max_new=12)
    _, clean = _run(_engine(schedule=schedule, spec_len=3), params, reqs)
    name = ("speculative_match" if schedule == "slot"
            else "speculative_accept")
    wrapper = _FailOnce(getattr(sampling, name), at=2, after=True)
    monkeypatch.setattr(sampling, name, wrapper)
    b, res = _run(_engine(schedule=schedule, spec_len=3), params, reqs)
    assert wrapper.calls > 2
    assert {u: r.tokens for u, r in res.items()} == {
        u: r.tokens for u, r in clean.items()}
    assert b.counters["errored"] == 0


# --------------------------------------------------------------------------- #
# isolation: the failing slot alone finishes "error"
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("schedule,spec_len,layout", [
    ("round", 0, "contiguous"), ("slot", 0, "contiguous"),
    ("round", 3, "contiguous"), ("slot", 3, "contiguous"),
    ("round", 0, "paged"), ("slot", 3, "paged")])
def test_slot_isolation_survivors_bit_identical(params, schedule, spec_len,
                                                layout):
    reqs = _requests(3, max_new=10)
    kw = dict(schedule=schedule, spec_len=spec_len, layout=layout)
    _, clean = _run(_engine(**kw), params, reqs)
    chaos = _chaos(chaos_dispatch_fail_slot=1)
    b, res = _run(_engine(hooks=chaos, **kw), params, reqs)
    # q1 sat in slot 1: it ends "error" with its prefill's token alone
    assert res["q1"].finish_reason == "error"
    assert res["q1"].tokens == clean["q1"].tokens[:1]
    for uid in ("q0", "q2"):
        assert res[uid].finish_reason == clean[uid].finish_reason
        assert res[uid].tokens == clean[uid].tokens
    _no_leaks(b)
    assert b.counters == {"admitted": 3, "completed": 2, "expired": 0,
                          "errored": 1, "shed": 0}


def test_slots_that_fail_alone_retire_and_the_queue_moves_on(params):
    """Every dispatch fails unless slot 1 runs alone: slot 0's requests
    finish "error" one after the other, slot 1's finishes whole, and the
    queue drains."""
    class AlwaysFail:
        def before_dispatch(self, kind, slots):
            if kind == "decode" and slots and slots != [1]:
                raise ChaosError("decode fault")

        def poison_logits(self, kind):
            return False

    engine = _engine(slots=2, hooks=AlwaysFail())
    b, res = _run(engine, params, [
        Request("a", [1, 2, 3], max_new_tokens=5),
        Request("b", [4, 5, 6], max_new_tokens=5),
        Request("c", [7, 8, 9], max_new_tokens=5)])
    assert res["a"].finish_reason == "error"
    assert res["b"].finish_reason == "length" and len(res["b"].tokens) == 5
    # c took slot 0 once a's error freed it, and failed there too
    assert res["c"].finish_reason == "error"
    _no_leaks(b)


# --------------------------------------------------------------------------- #
# the chaos run, NaN logits
# --------------------------------------------------------------------------- #


def test_chaos_run_accounts_everything_and_spares_the_unaffected(params):
    """A raise, a latency spike and NaN logits in one batcher: every request
    ends accounted for, all three faults fire, and the requests that run
    after them are bit-identical to a chaos-off run."""
    batch_a = [Request(f"a{i}", [2 + i, 9 + i], max_new_tokens=6)
               for i in range(3)]
    batch_b = [Request(f"b{i}", [30 + i, 40 + i, 50 + i], max_new_tokens=5)
               for i in range(3)]
    _, want_b = _run(_engine(slots=2), params, batch_b)
    slept = []
    chaos = _chaos(sleep=slept.append, chaos_dispatch_raise_round=2,
                   chaos_latency_round=3, chaos_latency_s=0.1,
                   chaos_poison_logits_round=4)
    b = _batcher(_engine(slots=2, hooks=chaos), params)
    res_a = b.run([Request(**vars(r)) for r in batch_a])
    assert chaos._fired >= {"raise", "latency", "poison"} and slept == [0.1]
    for r in res_a.values():
        assert r.finish_reason in ("eos", "length", "timeout", "error")
        assert all(0 <= t < MODEL["vocab_size"] for t in r.tokens)
    res_b = b.run([Request(**vars(r)) for r in batch_b])
    assert {u: r.tokens for u, r in res_b.items()} == {
        u: r.tokens for u, r in want_b.items()}
    c = b.counters
    assert c["completed"] + c["expired"] + c["errored"] == c["admitted"] == 6
    assert c["shed"] == 0 and b.stats()["active_slots"] == 0


@pytest.mark.parametrize("spec_len", [0, 4])
@pytest.mark.parametrize("schedule", ["round", "slot"])
def test_poisoned_round_emits_defined_tokens(params, schedule, spec_len):
    """NaN logits in round 2 (a decode block, or a verify): the samplers'
    non-finite gate and the acceptance rules keep every token defined, and
    generation ends normally."""
    chaos = _chaos(chaos_poison_logits_round=2)
    engine = _engine(slots=2, hooks=chaos, schedule=schedule,
                     spec_len=spec_len)
    _, res = _run(engine, params, _requests(2, max_new=10))
    assert "poison" in chaos._fired
    for r in res.values():
        assert r.finish_reason == "length" and len(r.tokens) == 10
        assert all(0 <= t < MODEL["vocab_size"] for t in r.tokens)


# --------------------------------------------------------------------------- #
# prefills: isolation, retries on pages
# --------------------------------------------------------------------------- #


class _PrefillBomb:
    """Fails the 2nd and 3rd prefill dispatches: one admission's attempt
    and its retry."""

    def __init__(self, calls=(2, 3)):
        self.n, self.calls = 0, calls

    def before_dispatch(self, kind, slots):
        if kind not in ("prefill", "prefill_chunk"):
            return
        self.n += 1
        if self.n in self.calls:
            raise ChaosError("prefill bomb")

    def poison_logits(self, kind):
        return False


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_prefill_failure_costs_only_the_incoming_request(params, layout):
    reqs = _requests(3, temperature=0.0, max_new=6)
    _, clean = _run(_engine(slots=2, layout=layout), params, reqs)
    b, res = _run(_engine(slots=2, layout=layout, hooks=_PrefillBomb()),
                  params, reqs)
    assert res["q1"].finish_reason == "error" and res["q1"].tokens == []
    for uid in ("q0", "q2"):
        assert res[uid].tokens == clean[uid].tokens
        assert res[uid].finish_reason == clean[uid].finish_reason
    _no_leaks(b)
    assert b.counters == {"admitted": 3, "completed": 2, "expired": 0,
                          "errored": 1, "shed": 0}


def test_match_prefix_idempotent_under_retry():
    """A retried paged admission re-runs ``match_prefix`` on the same slot:
    it must drop the failed attempt's holdings first (``PagedKV``, as
    ``tests/test_paged_kv.py`` holds the JAX allocator)."""
    mgr = PagedKV(slots=1, page_len=8, max_pages=4, num_pages=16)
    prompt = list(range(100, 118))  # 2 full pages + a 2-row tail
    mgr.ensure_writable(0, 0, len(prompt))
    cached_pages = [int(p) for p in mgr.tables[0] if p != NULL_PAGE]
    mgr.set_len(0, len(prompt))
    mgr.register_prompt(0, prompt)
    mgr.free_slot(0)
    live0 = mgr.pool.live_count
    assert mgr.match_prefix(0, prompt + [7]) == 18
    mgr.ensure_writable(0, 18, 19)  # the suffix copy a real attempt plans
    assert mgr.match_prefix(0, prompt + [7]) == 18  # the retry
    mgr.free_slot(0)
    assert mgr.pool.live_count == live0
    assert all(mgr.pool.refs[p] == 1 for p in cached_pages)
    assert mgr.radix.evictable_count() == live0


def test_retried_paged_dispatches_take_no_page_twice(params):
    """A system prompt's tail page is shared with the radix cache, so each
    request's first decode block copies it. A decode block that fails
    after its copy retries without a second one (the pages it made the
    slot's own stay its own): every counter and the pool end as in a
    fault-free run. A prefix hit whose chunk dispatch fails once re-runs
    the admission, whose re-match releases the failed attempt's pages
    (the allocator counts the query twice, as the JAX one does): the same
    streams, the same pages live."""
    system = list(range(1, 18))
    reqs = [Request("s0", system + [40], max_new_tokens=4),
            Request("s1", system + [50, 51], max_new_tokens=4)]

    def run(hooks=None, fail_decode_at=None):
        engine = _engine(slots=1, layout="paged", hooks=hooks)
        if fail_decode_at is not None:
            engine._decode_core = _FailOnce(engine._decode_core,
                                            at=fail_decode_at)
        b = _batcher(engine, params)
        res = b.run([Request(**vars(r)) for r in reqs])
        _no_leaks(b)
        return {u: r.tokens for u, r in res.items()}, b.stats()

    keys = ("prefix_queries", "prefix_hits", "prefix_cached_tokens",
            "cow_copies", "kv_pages_live")
    want, clean = run()
    assert clean["cow_copies"] >= 2 and clean["prefix_hits"] == 1
    got, st = run(fail_decode_at=1)  # s0's first block, after its copy
    assert got == want
    assert {k: st[k] for k in keys} == {k: clean[k] for k in keys}
    got, st = run(hooks=_PrefillBomb(calls=(4,)))  # s1's suffix chunk
    assert got == want
    assert st["prefix_queries"] == clean["prefix_queries"] + 1
    assert st["prefix_hits"] == clean["prefix_hits"] + 1
    assert st["kv_pages_live"] == clean["kv_pages_live"]


# --------------------------------------------------------------------------- #
# deadlines, a lost cache, a lost device
# --------------------------------------------------------------------------- #


class _Clock:
    """One second per reading."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_timeout_frees_and_recycles_the_slot(params, layout):
    engine = _engine(slots=1, layout=layout)
    b = _batcher(engine, params, clock=_Clock())
    res = b.run([Request("hog", [1, 2, 3], max_new_tokens=48,
                         timeout_s=6.0),
                 Request("queued", [4, 5, 6], max_new_tokens=4)])
    assert res["hog"].finish_reason == "timeout"
    assert 0 < len(res["hog"].tokens) < 48  # its partial stream returns
    assert res["queued"].finish_reason == "length"
    assert len(res["queued"].tokens) == 4
    _, free = _run(engine, params, [Request("queued", [4, 5, 6],
                                            max_new_tokens=4)])
    assert res["queued"].tokens == free["queued"].tokens
    assert b.counters == {"admitted": 2, "completed": 1, "expired": 1,
                          "errored": 0, "shed": 0}
    _no_leaks(b)


def test_expired_slot_is_refilled_in_the_same_round(params):
    """The deadline check runs before admission: the round that retires a
    timed-out request seats the next one."""
    b = _batcher(_engine(slots=1), params, clock=_Clock())
    b.submit(Request("hog", [1, 2, 3], max_new_tokens=48, timeout_s=1.0))
    b.submit(Request("next", [4, 5, 6], max_new_tokens=4))
    b.step()
    assert b._slots[0].req.uid == "hog"
    b.step()
    assert b.take_results()["hog"].finish_reason == "timeout"
    assert b._slots[0] is not None and b._slots[0].req.uid == "next"


def test_restore_failure_raises_cache_lost(params):
    class Unrestorable:
        def get_state(self):
            return b"state"

        def set_state(self, state):
            raise RuntimeError("state gone")

    engine = _engine()
    cache = engine.init_cache()
    with pytest.raises(CacheLost, match="left the cache unrestorable"):
        with engine._restoring(cache, Unrestorable()):
            raise ChaosError("dispatch fault")


def test_cache_lost_resets_the_pool_and_serves_the_queue(params):
    """Round 2 fails and its state cannot be restored: the parked requests
    finish "error", the pool is empty (no table, no reference, no radix
    page), and the queued requests are served as a fault-free run serves
    them."""
    queued = [Request("c", [20, 21, 22], max_new_tokens=5),
              Request("d", [30, 31, 32, 33], max_new_tokens=5)]
    _, want = _run(_engine(slots=2, layout="paged"), params, queued)
    engine = _engine(slots=2, layout="paged")
    # round 2's first model step fails inside the dispatch
    engine._decode_core = _FailOnce(engine._decode_core, at=3)
    restoring = engine._restoring

    @contextlib.contextmanager
    def unrestorable(cache, generator=None):
        with restoring(cache, generator):
            try:
                yield
            except ChaosError as e:
                raise CacheLost("restore failed") from e

    engine._restoring = unrestorable
    b = _batcher(engine, params)
    for r in [Request("a", [1, 2, 3], max_new_tokens=8),
              Request("b", [4, 5, 6, 7], max_new_tokens=8), *queued]:
        b.submit(Request(**vars(r)))
    b.step()  # round 1
    b.step()  # round 2: lost
    res = b.take_results()
    assert {u: r.finish_reason for u, r in res.items()} == {
        "a": "error", "b": "error"}
    p = engine.paged
    assert p.pool.free_count == p.pool.usable_pages
    assert np.all(p.tables == NULL_PAGE) and np.all(p.host_len == 0)
    assert p.radix.evictable_count() == 0
    assert b._cache["lengths"].tolist() == [0, 0]
    res = b.run()
    assert {u: (r.tokens, r.finish_reason) for u, r in res.items()} == {
        u: (r.tokens, r.finish_reason) for u, r in want.items()}


def test_radix_clear_drops_every_domain():
    mgr = PagedKV(slots=2, page_len=8, max_pages=4, num_pages=16)
    for slot, salt in ((0, ""), (1, "acme")):
        mgr.ensure_writable(slot, 0, 20)
        mgr.set_len(slot, 20)
        mgr.register_prompt(slot, list(range(20)), salt=salt)
        mgr.free_slot(slot)
    assert mgr.pool.live_count == 6
    mgr.radix.clear()
    assert mgr.pool.live_count == 0
    assert mgr.match_prefix(0, list(range(20))) == 0
    assert mgr.peek_prefix(list(range(20)), salt="acme") == 0


def test_lost_device_raises_out_of_step_unretried(params):
    class DeviceGone:
        calls = 0

        def before_dispatch(self, kind, slots):
            if kind == "decode":
                self.calls += 1
                raise RuntimeError("CUDA error: an illegal memory access was "
                                   "encountered")

        def poison_logits(self, kind):
            return False

    hook = DeviceGone()
    b = _batcher(_engine(hooks=hook), params)
    b.submit(Request("a", [1, 2, 3], max_new_tokens=4))
    with pytest.raises(RuntimeError, match="CUDA error"):
        b.step()
    assert hook.calls == 1
