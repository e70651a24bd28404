"""The port's overlap pipeline (``inference.overlap``) against its serial
scheduler and the JAX package's pipeline, on the CPU.

Weights are drawn by the JAX package (a tiny fp32 model) and carried
across with ``convert.params_from_jax``; the requests are the same on
both sides, and the JAX batcher runs once per case in a module fixture.
Both sides key sampled tokens by the slot schedule ("auto" resolves to
it under overlap), so a stream depends only on the base key, the
positions and the logits, never on how the rounds were laid out:

- the streams with overlap equal the port's serial streams and the JAX
  pipeline's, token for token, greedy and at temperature 0.8, on
  ``decode_block`` (contiguous and paged) and on the n-gram ``verify``;
- a round issued against a stale budget or before an EOS is read back
  delivers every token once (late stops by budget and by EOS);
- a slot whose every dispatch fails is isolated by the serial recovery
  the issue falls back to, and the others keep their bits; a run of chaos
  faults (a raise, a latency spike, NaN logits) accounts for every
  request; ``busy`` covers the round in flight, so a drain loop flushes
  it;
- overlap under ``key_schedule: "round"`` is refused, by the config and
  by the engine, with the JAX package's messages;
- the issue stage reads nothing back: ``_issue_round`` calls no
  ``Tensor.cpu``, ``item``, ``tolist`` or ``numpy`` (nor ``int``,
  ``float``, ``bool`` of a tensor) on a decode round with a lane chunk,
  contiguous and paged, and on an n-gram verify round. Its half on the
  card (``torch.cuda.set_sync_debug_mode("error")``) is in
  ``chip_smoke.py``.
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
from picotron_tpu.models import llama as jax_llama
from picotron_tpu_torch import convert
from picotron_tpu_torch.config import Config
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
# (program, layout, temperature): the stream cases
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


def _requests(mod_request, program="block", temp=0.0, **extra):
    """Four requests for three slots, so one waits for a retired slot and
    is seated while a round is in flight; budgets end mid-block and the
    slots retire at different rounds. The verify traffic repeats itself
    (the n-gram drafter accepts there)."""
    k = dict(temperature=temp, top_k=0 if temp == 0 else 40, top_p=0.95,
             **extra)
    if program == "verify":
        prompts = ([5, 9, 5, 9, 5, 9], [7, 3, 7, 3, 7], [11, 12, 11, 12],
                   [3, 1, 4, 3, 1, 4, 3])
        news = (18, 11, 4, 9)
    else:
        prompts = ([5, 9, 5, 9, 5, 9], [7, 3, 7, 3, 7], [11, 12, 11, 12],
                   [3, 1, 4, 1, 5])
        news = (19, 13, 4, 7)
    return [mod_request(u, list(p), max_new_tokens=n, **k)
            for u, p, n in zip("abcd", prompts, news)]


def _inference(layout="contiguous", **kw) -> dict:
    return {"decode_block_len": BLOCK, "prefill_chunk": CHUNK,
            "attend_impl": "flash", "kv_layout": layout, "kv_page_len": 8,
            "key_schedule": "slot", **kw}


def _engine(overlap, layout="contiguous", spec_len=0, hooks=None, **kw):
    cfg = Config.from_dict({"model": MODEL,
                            "inference": _inference(layout, **kw)})
    return InferenceEngine(cfg, "cpu", slots=SLOTS, max_seq_len=MAX_LEN,
                           spec_len=spec_len, overlap=overlap, hooks=hooks)


def _streams(results) -> dict:
    return {u: (r.tokens, r.finish_reason) for u, r in results.items()}


def _run(params, overlap, program="block", layout="contiguous", temp=0.0,
         hooks=None, reqs=None, **kw):
    spec_len = SPEC_LEN if program == "verify" else 0
    b = ContinuousBatcher(_engine(overlap, layout, spec_len, hooks, **kw),
                          params, seed=7, sleep=lambda s: None)
    res = b.run(reqs if reqs is not None else _requests(Request, program,
                                                         temp))
    return _streams(res), b


def _chaos(**kw):
    return ServingChaos(Config.from_dict({"resilience": kw}).resilience,
                        sleep=lambda s: None)


@pytest.fixture(scope="module")
def jax_streams(tiny):
    """The JAX pipeline's streams for every case of ``CASES``."""
    jcfg, jparams, _ = tiny
    out = {}
    for program, layout in {(p, lay) for p, lay, _ in CASES}:
        eng = JaxEngine(jcfg, slots=SLOTS, max_seq_len=MAX_LEN,
                        decode_block_len=BLOCK, prefill_chunk=CHUNK,
                        attend_impl="dense", kv_layout=layout, kv_page_len=8,
                        spec_len=SPEC_LEN if program == "verify" else 0,
                        key_schedule="slot", overlap=True)
        params = eng.shard_params(jparams)
        for temp in (0.0, 0.8):
            b = JaxBatcher(eng, params, seed=7)
            out[program, layout, temp] = _streams(b.run(
                _requests(JaxRequest, program, temp)))
            assert b._inflight is None
    return out


# --------------------------------------------------------------------------- #
# the streams: overlap on = overlap off = the JAX pipeline
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("program,layout,temp", CASES)
def test_overlap_streams_match_serial_and_jax(tiny, jax_streams, program,
                                              layout, temp):
    params = tiny[2]
    off, _ = _run(params, False, program, layout, temp)
    on, b = _run(params, True, program, layout, temp)
    assert on == off == jax_streams[program, layout, temp]
    assert b._inflight is None and b.engine.defer_advance
    ov = b.stats()["overlap"]
    assert ov["enabled"]
    # most rounds were issued while the round before was in flight
    assert ov["dispatch_gap_s"]["p50"] == 0.0
    assert 0.0 < ov["overlap_efficiency"] <= 1.0
    if layout == "paged":
        p = b.paged
        assert np.all(p.host_len == 0)
        assert p.pool.live_count == p.radix.evictable_count()


# --------------------------------------------------------------------------- #
# late stops: an overshot round delivers every token once
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("temp", [0.0, 0.8])
def test_late_stop_by_budget_delivers_once(tiny, temp):
    """Budgets that end mid-block: the round in flight was issued against
    a stale budget and overshoots, and the sync's walk cuts at the
    request's own limit."""
    on, b = _run(tiny[2], True, temp=temp)
    assert {u: len(t) for u, (t, _) in on.items()} == {
        "a": 19, "b": 13, "c": 4, "d": 7}
    assert all(r == "length" for _, r in on.values())
    assert b.counters == {"admitted": 4, "completed": 4, "expired": 0,
                          "errored": 0, "shed": 0}


def test_late_eos_delivers_once(tiny):
    """An EOS mid-round while the next round is already in flight: the
    device stops the row, the sync drops what the retired seat's later
    round made, and the stream is the serial one to its last token."""
    base, _ = _run(tiny[2], False)
    eos = base["a"][0][5]
    reqs = [Request(**{**vars(r), **({"eos_id": eos} if r.uid == "a"
                                     else {})})
            for r in _requests(Request)]
    off, _ = _run(tiny[2], False, reqs=reqs)
    on, _ = _run(tiny[2], True,
                 reqs=[Request(**vars(r)) for r in reqs])
    assert on == off
    assert on["a"][1] == "eos" and on["a"][0][-1] == eos
    assert eos not in on["a"][0][:-1]


# --------------------------------------------------------------------------- #
# faults under the pipeline
# --------------------------------------------------------------------------- #


def test_overlap_isolates_a_failing_slot(tiny):
    """Every dispatch with slot 1 active fails: the issue falls back to the
    serial recovery, which isolates the slot; its requests ("b", then "d"
    seated in its place) end "error" with their prefill's first token, and
    the others keep the fault-free pipeline's bits."""
    params = tiny[2]
    clean, _ = _run(params, True, temp=0.8)
    on, b = _run(params, True, temp=0.8,
                 hooks=_chaos(chaos_dispatch_fail_slot=1))
    for u in ("b", "d"):
        assert on[u] == (clean[u][0][:1], "error")
    for u in ("a", "c"):
        assert on[u] == clean[u]
    assert all(s is None for s in b._slots) and b._inflight is None
    assert not b._pending
    assert b.counters == {"admitted": 4, "completed": 2, "expired": 0,
                          "errored": 2, "shed": 0}


def test_overlap_chaos_accounts_for_every_request(tiny):
    """A raise at the second dispatch, a latency spike at the third and NaN
    logits at the fourth, inside the pipeline: every request ends with its
    full budget of in-vocabulary tokens, the raise absorbed by a retry."""
    params = tiny[2]
    clean, _ = _run(params, True, temp=0.8)
    hooks = _chaos(chaos_dispatch_raise_round=2, chaos_latency_round=3,
                   chaos_latency_s=0.05, chaos_poison_logits_round=4)
    on, b = _run(params, True, temp=0.8, hooks=hooks)
    assert hooks._fired >= {"raise", "latency", "poison"}
    assert all(r in ("length", "eos") for _, r in on.values())
    assert all(0 <= t < MODEL["vocab_size"]
               for toks, _ in on.values() for t in toks)
    assert {u: len(t) for u, (t, _) in on.items()} == {
        u: len(t) for u, (t, _) in clean.items()}
    assert b.counters["errored"] == 0 and b.counters["completed"] == 4


def test_busy_drains_the_round_in_flight(tiny):
    """``busy`` covers the round in flight: stepped by hand, the batcher
    stays busy while only that round is left, and the flushed streams are
    whole."""
    b = ContinuousBatcher(_engine(True), tiny[2], seed=7)
    for r in _requests(Request):
        b.submit(r)
    only_inflight = False
    for _ in range(200):
        if not b.busy:
            break
        b.step()
        if (b._inflight is not None and not b._pending
                and all(s is None for s in b._slots)):
            only_inflight = True
    assert not b.busy and only_inflight and b._inflight is None
    assert {u: len(r.tokens) for u, r in b.take_results().items()} == {
        "a": 19, "b": 13, "c": 4, "d": 7}


def test_overlap_refuses_the_round_schedule_with_jax_messages(tiny):
    raw = {"overlap": True, "key_schedule": "round"}
    with pytest.raises(ValueError, match="key schedule") as theirs:
        JaxConfig.from_dict({"inference": raw})
    with pytest.raises(ValueError) as ours:
        Config.from_dict({"inference": raw})
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="key schedule") as theirs:
        JaxEngine(tiny[0], slots=2, max_seq_len=MAX_LEN, overlap=True,
                  key_schedule="round")
    with pytest.raises(ValueError) as ours:
        InferenceEngine(Config.from_dict({"model": MODEL}), "cpu", slots=2,
                        max_seq_len=MAX_LEN, overlap=True,
                        key_schedule="round")
    assert str(ours.value) == str(theirs.value)


# --------------------------------------------------------------------------- #
# the issue stage reads nothing back
# --------------------------------------------------------------------------- #


READS = ("cpu", "item", "tolist", "numpy", "__int__", "__float__",
         "__bool__", "__index__")


@pytest.mark.parametrize("program,layout", [("block", "contiguous"),
                                            ("block", "paged"),
                                            ("verify", "contiguous")])
def test_issue_round_reads_nothing_back(tiny, monkeypatch, program, layout):
    """``_issue_round`` under spies on every ``torch.Tensor`` read-back
    (the sync stage, outside it, reads as it must): none is called, on
    decode rounds that carry a lane chunk and on n-gram verify rounds,
    while the streams stay the serial ones."""
    params = tiny[2]
    long_reqs = [Request("l", [(5 * i + 2) % 127 + 1 for i in range(20)],
                         max_new_tokens=6)]
    reqs = _requests(Request, program, 0.8) + long_reqs
    spec_len = SPEC_LEN if program == "verify" else 0
    eng = _engine(True, layout, spec_len, mixed_dispatch=True)
    b = ContinuousBatcher(eng, params, seed=7)
    orig = {name: getattr(torch.Tensor, name) for name in READS}
    calls, issued = [], []

    def spy(name):
        def read(self, *a, **k):
            calls.append(name)
            return orig[name](self, *a, **k)
        return read

    issue = b._issue_round

    def gated(budget):
        issued.append(b._lanes[0] is not None)
        for name in READS:
            monkeypatch.setattr(torch.Tensor, name, spy(name))
        try:
            return issue(budget)
        finally:
            for name in READS:
                monkeypatch.setattr(torch.Tensor, name, orig[name])

    b._issue_round = gated
    on = _streams(b.run([Request(**vars(r)) for r in reqs]))
    assert calls == []
    assert len(issued) > 3 and any(issued)  # lane chunks rode the rounds
    off, _ = _run(params, False, program, layout,
                  reqs=[Request(**vars(r)) for r in reqs])
    assert on == off
