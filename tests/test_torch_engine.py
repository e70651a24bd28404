"""The PyTorch port's model, engine and batcher against the JAX package's,
on the CPU.

Weights are drawn once by the JAX package (the tiny conftest model, fp32)
and carried across with ``convert.params_from_jax``, so both sides compute
with the same numbers:

- ``decoder_layer`` (full sequence, ``return_kv``, and the cache hook at
  decode and chunk shapes) and ``forward_logits``: fp32 allclose at
  rtol 2e-4;
- the slice as a whole: the port's ``ContinuousBatcher`` gives greedy
  streams token-identical to the JAX batcher's for three prompts (one
  longer than ``prefill_chunk``, queued behind a full slot table), through
  both the plain ops and the kernels' plain versions;
- sampled streams, which cannot match the JAX draws token for token (the
  two random generators differ): top_k = 1 reproduces greedy, and every
  drawn token lies inside the JAX filter's support at its position;
- ``init_params`` draws the JAX package's tree, shapes, types and laws,
  and the generate CLI runs end to end with the JAX tool's summary line.
"""

import json
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from conftest import make_config
from picotron_tpu.inference import ContinuousBatcher as JaxBatcher
from picotron_tpu.inference import InferenceEngine as JaxEngine
from picotron_tpu.inference import Request as JaxRequest
from picotron_tpu.inference import sampling as jax_sampling
from picotron_tpu.models import llama as jax_llama
from picotron_tpu.ops import rope as jax_rope
from picotron_tpu.topology import build_topology
from picotron_tpu.utils import shard_map as shard_map_compat
from picotron_tpu_torch import convert
from picotron_tpu_torch.config import Config
from picotron_tpu_torch.inference.batcher import ContinuousBatcher, Request
from picotron_tpu_torch.inference.engine import InferenceEngine
from picotron_tpu_torch.models import llama
from picotron_tpu_torch.ops import rope

MAX_LEN = 64
CHUNK = 16
BLOCK = 4
RTOL = ATOL = 2e-4  # fp32 on both sides; sums reassociate between XLA and torch
# three prompts: two one-shot prefills and one over CHUNK tokens (two
# chunks); with two slots the third waits for a retired slot
PROMPT_LENS = (5, 23, 11)
NEW_TOKENS = (9, 6, 12)  # budgets ending mid-block and on a block edge


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Six test workers share the machine with timing-sensitive serving
    tests: keep torch to one thread here, and restore the old count."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def tiny():
    """(JAX config, port config, JAX params, port params) for the conftest
    model: 4 layers, GQA 8/4, H=64, fp32."""
    kwargs = dict(num_hidden_layers=4, num_attention_heads=8,
                  num_key_value_heads=4, hidden_size=64,
                  intermediate_size=128, vocab_size=256,
                  max_position_embeddings=128, rope_theta=10000.0,
                  dtype="float32", attention_impl="sdpa")
    jcfg = make_config(kwargs, seq=MAX_LEN)
    cfg = Config.from_dict({"model": kwargs, "inference": {
        "prefill_chunk": CHUNK, "decode_block_len": BLOCK}})
    jparams = jax.jit(lambda k: jax_llama.init_params(k, jcfg.model))(
        jax.random.PRNGKey(0))
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, cfg, jparams, params


def _replicated(fn, n_in):
    """``fn`` under a one-device ('dp','pp','cp','tp') mesh, every operand
    replicated: the JAX model's tp collectives need the named axes."""
    mesh = build_topology(1, 1, 1, 1).mesh
    return jax.jit(shard_map_compat(fn, mesh, in_specs=(P(),) * n_in,
                                    out_specs=P()))


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def _prompts(vocab):
    rng = np.random.default_rng(7)
    return [rng.integers(1, vocab, n).tolist() for n in PROMPT_LENS]


# --------------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------------- #


def test_decoder_layer_full_sequence_and_return_kv(tiny):
    jcfg, cfg, jparams, params = tiny
    m = cfg.model
    B, S = 2, 12
    h = np.random.default_rng(1).standard_normal(
        (B, S, m.hidden_size)).astype(np.float32)
    jcos, jsin = jax_rope.precompute_rope(S, m.head_dim, m.rope_theta,
                                          jnp.float32)
    cos, sin = rope.precompute_rope(S, m.head_dim, m.rope_theta,
                                    torch.float32)
    jlp = jax.tree.map(lambda a: a[1], jparams["layers"])
    want_h, (want_k, want_v) = _replicated(
        lambda lp, x, c, s: jax_llama.decoder_layer(lp, x, c, s, jcfg,
                                                    return_kv=True), 4)(
        jlp, jnp.asarray(h), jcos, jsin)
    lp = llama.layer_params(params, 1)
    got_h, (got_k, got_v) = llama.decoder_layer(
        lp, torch.from_numpy(h), cos, sin, cfg, return_kv=True)
    _close(got_h, want_h)
    _close(got_k, want_k)
    _close(got_v, want_v)
    assert got_k.shape == (B, S, m.num_key_value_heads, m.head_dim)
    # the kernels' plain version of flash attention takes the same path
    flash = Config.from_dict({"model": {**cfg.to_dict()["model"],
                                        "attention_impl": "flash"}})
    _close(llama.decoder_layer(lp, torch.from_numpy(h), cos, sin, flash),
           want_h)


@pytest.mark.parametrize("attend_impl", ["dense", "flash"])
@pytest.mark.parametrize("B,S,pos", [(3, 1, (4, 0, 17)), (1, 5, (9,))])
def test_decoder_layer_cache_hook(tiny, B, S, pos, attend_impl):
    """Decode (S = 1, every slot at its own position, one free slot at 0)
    and a prefill chunk (B = 1, S > 1): the written cache rows and the
    layer output match the JAX layer's."""
    jcfg, cfg, jparams, params = tiny
    m = cfg.model
    T = 32
    rng = np.random.default_rng(2 + S)
    h = rng.standard_normal((B, S, m.hidden_size)).astype(np.float32)
    kshape = (B, T, m.num_key_value_heads, m.head_dim)
    k0 = rng.standard_normal(kshape).astype(np.float32)
    v0 = rng.standard_normal(kshape).astype(np.float32)
    pos = np.asarray(pos, np.int32)
    rows = pos[:, None] + np.arange(S, dtype=np.int32)[None, :]
    jcos, jsin = jax_rope.precompute_rope(T, m.head_dim, m.rope_theta,
                                          jnp.float32)
    jc, js = jax_rope.rope_at_positions(jcos, jsin, jnp.asarray(rows))
    jlp = jax.tree.map(lambda a: a[2], jparams["layers"])

    def jax_fn(lp, x, c, s, k, v, p):  # jcfg attends with "dense"
        out, lc = jax_llama.decoder_layer(lp, x, c, s, jcfg,
                                          cache={"k": k, "v": v}, pos=p)
        return out, lc["k"], lc["v"]

    want_h, want_k, want_v = _replicated(jax_fn, 7)(
        jlp, jnp.asarray(h), jc, js, jnp.asarray(k0), jnp.asarray(v0),
        jnp.asarray(pos))
    cos, sin = rope.precompute_rope(T, m.head_dim, m.rope_theta,
                                    torch.float32)
    c, s = rope.rope_at_positions(cos, sin, torch.from_numpy(rows))
    cfg_i = Config.from_dict({**cfg.to_dict(),
                              "inference": {"attend_impl": attend_impl}})
    lc = {"k": torch.from_numpy(k0.copy()), "v": torch.from_numpy(v0.copy())}
    got_h, got_c = llama.decoder_layer(
        llama.layer_params(params, 2), torch.from_numpy(h), c, s, cfg_i,
        cache=lc, pos=torch.from_numpy(pos))
    assert got_c is lc  # written in place
    _close(got_c["k"], want_k)
    _close(got_c["v"], want_v)
    # a slot at length 0 (free) sees only its own fresh row in both
    _close(got_h, want_h)


def test_forward_logits_from_jax_params(tiny):
    jcfg, cfg, jparams, params = tiny
    tokens = np.random.default_rng(3).integers(
        0, cfg.model.vocab_size, (2, 20)).astype(np.int32)
    want = _replicated(lambda p, t: jax_llama.forward_logits(p, t, jcfg),
                       2)(jparams, jnp.asarray(tokens))
    got = llama.forward_logits(params, torch.from_numpy(tokens), cfg)
    assert got.shape == (2, 20, cfg.model.vocab_size)
    _close(got, want)


def test_init_params_follows_the_jax_tree_and_laws():
    """Same tree, shapes and dtypes as the JAX init; linear weights inside
    U(+-sqrt(1/fan_in)) and spread over it, embedding N(0, 1), norms one;
    the seed fixes every value."""
    raw = dict(num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, hidden_size=64, intermediate_size=96,
               vocab_size=128, dtype="bfloat16")
    jtree = jax.eval_shape(
        lambda k: jax_llama.init_params(k, make_config(raw).model),
        jax.random.PRNGKey(0))
    m = Config.from_dict({"model": raw}).model
    p = llama.init_params(m, seed=5)
    flat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    assert len(flat) == len(jax.tree.leaves(convert.params_to_jax(p)))
    for path, leaf in flat:
        t = p
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).removeprefix("torch.") == str(leaf.dtype), path
    fan_in = {"wq": 64, "wk": 64, "wv": 64, "wo": 64, "w_gate": 64,
              "w_up": 64, "w_down": 96}
    for name, fan in fan_in.items():
        w = p["layers"][name].float()
        bound = math.sqrt(1.0 / fan)
        assert float(w.abs().max()) <= bound * (1 + 2 ** -8)
        assert float(w.abs().max()) > 0.9 * bound
        assert abs(float(w.mean())) < 0.05 * bound
    assert float(p["lm_head"].float().abs().max()) <= 0.125 * (1 + 2 ** -8)
    e = p["embed"].float()
    assert abs(float(e.mean())) < 0.05 and abs(float(e.std()) - 1) < 0.05
    for t in (p["final_norm"], p["layers"]["attn_norm"],
              p["layers"]["mlp_norm"]):
        assert bool((t == 1).all())
    again = llama.init_params(m, seed=5)
    assert torch.equal(again["layers"]["wq"], p["layers"]["wq"])
    assert not torch.equal(llama.init_params(m, seed=6)["layers"]["wq"],
                           p["layers"]["wq"])


# --------------------------------------------------------------------------- #
# the slice: engine + batcher
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def jax_greedy(tiny):
    """The JAX batcher's greedy streams for the three prompts."""
    jcfg, cfg, jparams, _ = tiny
    engine = JaxEngine(jcfg, slots=2, max_seq_len=MAX_LEN,
                       prefill_chunk=CHUNK, decode_block_len=BLOCK)
    reqs = [JaxRequest(f"r{i}", p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(_prompts(cfg.model.vocab_size),
                                           NEW_TOKENS))]
    res = JaxBatcher(engine, engine.shard_params(jparams)).run(reqs)
    return {u: r.tokens for u, r in res.items()}


def _port_engine(cfg, impl="sdpa"):
    attend = "flash" if impl == "flash" else "dense"
    c = Config.from_dict({"model": {**cfg.to_dict()["model"],
                                    "attention_impl": impl},
                          "inference": {**cfg.to_dict()["inference"],
                                        "attend_impl": attend}})
    return InferenceEngine(c, "cpu", slots=2, max_seq_len=MAX_LEN)


@pytest.mark.parametrize("impl", ["sdpa", "flash"])
def test_batcher_greedy_streams_match_jax(tiny, jax_greedy, impl):
    """Token-identical greedy streams. "sdpa" runs the plain ops
    (``sdpa`` + ``decode_attention``), "flash" the kernels' plain
    versions (flash prefill + flash decode), as a CPU tensor does."""
    _, cfg, _, params = tiny
    engine = _port_engine(cfg, impl)
    b = ContinuousBatcher(engine, params)
    reqs = [Request(f"r{i}", p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(_prompts(cfg.model.vocab_size),
                                           NEW_TOKENS))]
    res = b.run(reqs)
    for r in reqs:
        assert res[r.uid].tokens == jax_greedy[r.uid], r.uid
        assert res[r.uid].finish_reason == "length"
    # chunked prefill ran for the long prompt: ceil(23 / 16) = 2 chunks
    assert b.prefill_dispatches == 1 + 2 + 1
    assert b.decode_dispatches >= math.ceil(max(NEW_TOKENS) / BLOCK)


def test_batcher_eos_retires_mid_block(tiny, jax_greedy):
    """An EOS id taken from the greedy stream stops that request right at
    it (the device stop state and the host walk agree)."""
    _, cfg, _, params = tiny
    p0 = _prompts(cfg.model.vocab_size)[0]
    stream = jax_greedy["r0"]
    eos = stream[5]
    assert eos not in stream[:5]
    res = ContinuousBatcher(_port_engine(cfg), params).run(
        [Request("e", p0, max_new_tokens=20, eos_id=eos)])["e"]
    assert res.finish_reason == "eos"
    assert res.tokens == stream[:6]


def test_sampled_streams_pin_to_the_jax_filter(tiny, jax_greedy):
    """top_k = 1 at temperature 0.8 is greedy; a top-k/top-p stream draws
    every token from inside the JAX filter's support at its position (the
    JAX full-sequence logits over prompt + stream, scaled and filtered by
    ``filter_top_k_top_p``)."""
    jcfg, cfg, jparams, params = tiny
    prompts = _prompts(cfg.model.vocab_size)
    engine = _port_engine(cfg, "flash")
    res = ContinuousBatcher(engine, params, seed=11).run([
        Request("k1", prompts[0], max_new_tokens=NEW_TOKENS[0],
                temperature=0.8, top_k=1),
        Request("s", prompts[1], max_new_tokens=16, temperature=0.8,
                top_k=8, top_p=0.9)])
    assert res["k1"].tokens == jax_greedy["r0"]
    toks = res["s"].tokens
    assert len(toks) == 16
    seq = prompts[1] + toks
    logits = _replicated(lambda p, t: jax_llama.forward_logits(p, t, jcfg),
                         2)(jparams, jnp.asarray([seq], jnp.int32))[0]
    n = len(prompts[1])
    rows = logits[n - 1: len(seq) - 1] / 0.8
    kept = np.asarray(jax_sampling.filter_top_k_top_p(
        rows, jnp.full((len(toks),), 8, jnp.int32),
        jnp.full((len(toks),), 0.9, jnp.float32)))
    assert (kept[np.arange(len(toks)), toks] > -1e29).all()
    # and the draw is not greedy everywhere (the filter leaves choices)
    assert toks != list(np.argmax(np.asarray(logits[n - 1: -1]), -1))


def test_prefill_chunked_matches_one_shot(tiny):
    """A prompt prefilled in chunks parks the same K/V rows as the one-shot
    bucketed prefill and yields the same last-token logits, including the
    window slide at the end of the cache."""
    _, cfg, _, params = tiny
    engine = InferenceEngine(cfg, "cpu", slots=2, max_seq_len=40,
                             prefill_chunk=16)
    ids = np.random.default_rng(4).integers(1, 256, 37).tolist()
    kv, want = engine.prefill(params, ids)
    cache = engine.init_cache()
    cache, got = engine.prefill_chunked(params, cache, ids, 1)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    assert int(cache["lengths"][1]) == 37
    torch.testing.assert_close(cache["k"][:, 1, :37], kv["k"][:, 0, :37],
                               rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(cache["v"][:, 1, :37], kv["v"][:, 0, :37],
                               rtol=RTOL, atol=ATOL)
    assert int(cache["lengths"][0]) == 0 and not cache["k"][:, 0].any()


def test_generate_cli_runs_on_the_cpu(tmp_path, capsys):
    """The CLI end to end on a tiny config, with the JAX tool's summary
    line; the CPU only because the caller names it."""
    from picotron_tpu_torch.tools import generate

    path = tmp_path / "tiny.json"
    path.write_text(json.dumps({
        "model": {"num_hidden_layers": 2, "num_attention_heads": 4,
                  "num_key_value_heads": 2, "hidden_size": 32,
                  "intermediate_size": 64, "vocab_size": 64,
                  "max_position_embeddings": 48, "dtype": "float32"},
        "inference": {"attend_impl": "flash", "prefill_chunk": 8},
        "training": {"seq_length": 48}}))
    rc = generate.main(["--config", str(path), "--random-init", "--seed", "3",
                        "--prompt-ids", "1,2,3", "--prompt-ids",
                        ",".join(str(i % 60 + 1) for i in range(13)),
                        "--max-new-tokens", "5", "--slots", "2",
                        "--decode-block-len", "2", "--temperature", "0.7",
                        "--top-p", "0.9"], device="cpu")
    out = capsys.readouterr().out
    assert rc == 0, out
    assert re.search(r"^\[req1\] prompt=\[.*\] -> \[(\d+, ){4}\d+\] \(length\)$",
                     out, re.M), out
    assert re.search(
        r"^10 tokens in [\d.]+s \([\d.]+ tok/s, setup [\d.]+s, slots=2, "
        r"tp=1, block=2, kv=float32, weights=bf16, \d+ decode dispatches "
        r"= [\d.]+/token\)$", out, re.M), out
