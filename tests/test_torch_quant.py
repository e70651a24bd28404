"""The PyTorch port's int8 serving path against the JAX package's, on the
CPU: int8 weights (kernel G's plain version) and an int8 KV cache (the
plain version of kernel C's int8 variant).

Inputs are made from a numpy seed and go through both packages:

- quantization: ``quantize_weight``, ``quantize_weight_host`` and
  ``quantize_kv`` give the JAX int8 values exactly, and scales within
  1 ulp (the same fp32 divisions, dispatched eagerly on both sides);
- G's plain version against ``quant_matmul_pallas(..., interpret=True)``:
  rtol 1e-5 in fp32 (the two sum the same exact products in different
  orders), within 2^-7 in bf16 (one bf16 rounding step of the output);
- G on a tensor that reports a CUDA device raises without the kernel
  library and never takes the plain version; G's plan (split-K GEMV for
  M <= 16, wgmma above) from the shapes alone at the chip smoke's
  shapes; the kernel's mask-and-subtract int8 -> bf16 route, exact on
  every byte (a numpy model);
- C-int8's plain version against the Pallas ``flash_decode_attention``
  with ``k_scale``/``v_scale`` in interpret mode at decode,
  verify-shaped and chunk shapes, MHA and GQA: atol 1e-5 in fp32;
- ``convert`` carries a quantized tree across with its dtypes;
- the slice as a whole: the port's int8 engine (weights and KV), fed the
  JAX tree through ``convert``, gives greedy streams token-identical to
  the JAX int8 engine's, through one-shot and chunked prefill, on the
  dense attend and on the flash attend's plain version;
- no dequantized weight on the serving path (``dequantize_weight`` armed
  to raise), and the generate CLI with ``--weight-dtype int8
  --kv-cache-dtype int8`` and ``--check-weight-parity``.
"""

import importlib.util
import json
import os
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
from picotron_tpu.inference import kv_cache as jax_kv
from picotron_tpu.models import llama as jax_llama
from picotron_tpu.ops.pallas import quant_matmul as jax_qm
from picotron_tpu.ops.pallas.decode_attention import (
    flash_decode_attention as jax_flash_decode,
)
from picotron_tpu_torch import convert
from picotron_tpu_torch.config import Config
from picotron_tpu_torch.inference import kv_cache
from picotron_tpu_torch.inference.batcher import ContinuousBatcher, Request
from picotron_tpu_torch.inference.engine import InferenceEngine
from picotron_tpu_torch.models import llama
from picotron_tpu_torch.ops import quant_matmul as qmm
from picotron_tpu_torch.ops.kernels import decode_attention as kc
from picotron_tpu_torch.ops.kernels import quant_matmul as kg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MAX_LEN = 64
CHUNK = 16
BLOCK = 4
# three prompts: two one-shot prefills and one over CHUNK tokens (two
# chunks); with two slots the third waits for a retired slot
PROMPT_LENS = (5, 23, 11)
NEW_TOKENS = (9, 6, 12)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Six test workers share the machine with timing-sensitive serving
    tests: keep torch to one thread here, and restore the old count."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# --------------------------------------------------------------------------- #
# quantization
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("shape", [(64, 40), (3, 48, 33)])
def test_quantize_weight_matches_jax(shape):
    """Per-output-channel absmax: a dead channel (scale 0, zeros) and a
    denormal-tiny one (the clamped divisor is what is stored), plain and
    layer-stacked."""
    rng = np.random.default_rng(0)
    w = _rand(rng, *shape)
    w[..., 7] = 0.0
    w[..., 11] *= 1e-12
    want = jax_qm.quantize_weight(jnp.asarray(w))
    got = qmm.quantize_weight(torch.from_numpy(w))
    host = qmm.quantize_weight_host(w)
    for q, s in ((got["q"].numpy(), got["s"].numpy()),
                 (host["q"], host["s"])):
        assert q.dtype == np.int8 and s.dtype == np.float32
        np.testing.assert_array_equal(q, np.asarray(want["q"]))
        np.testing.assert_array_max_ulp(s, np.asarray(want["s"]), maxulp=1)
    assert not got["q"][..., 7].any() and not got["s"][..., 7].any()
    deq = qmm.dequantize_weight(got["q"], got["s"]).numpy()
    assert np.all(np.abs(deq - w) <= got["s"].numpy()[..., None, :] / 2
                  + 1e-8)


def test_quantize_kv_matches_jax():
    """One fp32 scale per row and head; a zero row stays zero."""
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 5, 3, 16)
    x[1, 2, 0] = 0.0
    qj, sj = jax_kv.quantize_kv(jnp.asarray(x))
    q, s = kv_cache.quantize_kv(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_max_ulp(s.numpy(), np.asarray(sj), maxulp=1)
    assert s[1, 2, 0] == 0 and not q[1, 2, 0].any()
    np.testing.assert_allclose(
        kv_cache.dequantize_kv(q, s, torch.float32).numpy(),
        np.asarray(jax_kv.dequantize_kv(qj, sj, jnp.float32)), rtol=1e-6)


# --------------------------------------------------------------------------- #
# kernel G
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N", [(1, 32, 48), (8, 64, 40), (5, 45, 33),
                                   (16, 128, 96)])
def test_quant_matmul_plain_matches_pallas(M, K, N, dtype):
    """G's plain version against the Pallas kernel in interpret mode. K = 45
    and N = 33 are odd: no tile divides them. fp32: rtol 1e-5 (the same
    exact products summed in another order); bf16: within 2^-7 (one
    rounding step of the bf16 output). Leading dimensions flatten through
    the entry point."""
    rng = np.random.default_rng(10 + M)
    x = _rand(rng, M, K)
    w = jax_qm.quantize_weight(jnp.asarray(_rand(rng, K, N)))
    q, s = np.array(w["q"]), np.array(w["s"])
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    want = np.asarray(jax_qm.quant_matmul_pallas(
        jnp.asarray(x).astype(jdt), jnp.asarray(q), jnp.asarray(s),
        interpret=True).astype(jnp.float32))
    tx = torch.from_numpy(x).to(tdt)
    got = kg.quant_matmul_2d(tx, torch.from_numpy(q), torch.from_numpy(s))
    assert got.dtype == tdt and got.shape == (M, N)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else \
        dict(rtol=2 ** -7, atol=2 ** -7)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)
    got3 = qmm.quant_matmul(tx.reshape(1, M, K), torch.from_numpy(q),
                            torch.from_numpy(s))
    assert got3.shape == (1, M, N)
    torch.testing.assert_close(got3[0], got, rtol=0, atol=0)


def test_quant_matmul_validates_and_never_falls_back(monkeypatch):
    """A non-int8 weight is refused; a tensor that is not on the CPU
    launches kernel G or raises, never the plain version."""
    with pytest.raises(ValueError, match="int8"):
        kg.quant_matmul_2d(torch.zeros(2, 8), torch.zeros(8, 8),
                           torch.zeros(8))

    def boom(*a, **k):
        raise AssertionError("plain version called for a non-CPU tensor")

    monkeypatch.setattr(kg, "quant_matmul_plain", boom)
    monkeypatch.setattr(kc, "flash_decode_attention_int8_plain", boom)
    with pytest.raises(ValueError, match="CUDA"):
        kg.quant_matmul_2d(
            torch.empty(4, 64, device="meta", dtype=torch.bfloat16),
            torch.empty(64, 32, device="meta", dtype=torch.int8),
            torch.empty(32, device="meta"))
    q = torch.empty(1, 4, 4, 64, device="meta", dtype=torch.bfloat16)
    kv = torch.empty(1, 16, 2, 64, device="meta", dtype=torch.int8)
    sc = torch.empty(1, 16, 2, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        kc.flash_decode_attention(q, kv, kv, torch.empty(
            1, device="meta", dtype=torch.int32), 0.125, sc, sc)


class _CudaLooking(torch.Tensor):
    """A CPU tensor that reports a CUDA device: it takes a wrapper's CUDA
    path on a machine without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)

    @property
    def is_cuda(self):
        return True


def test_quant_matmul_on_a_cuda_tensor_raises_without_the_kernel(
        monkeypatch):
    """A CUDA tensor never reaches the plain version: with the kernel
    library unavailable the call raises and counts no launch."""
    def boom(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    def no_library():
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(kg, "quant_matmul_plain", boom)
    monkeypatch.setattr(kg.build, "library", no_library)
    x = torch.zeros(8, 64, dtype=torch.bfloat16).as_subclass(_CudaLooking)
    q = torch.zeros(64, 32, dtype=torch.int8).as_subclass(_CudaLooking)
    s = torch.zeros(32).as_subclass(_CudaLooking)
    before = kg.KERNEL.launches
    # the output is allocated on the device first, which a torch without
    # CUDA refuses; either way the call raises
    with pytest.raises((RuntimeError, AssertionError)) as e:
        kg.quant_matmul_2d(x, q, s)
    assert "plain version" not in str(e.value)
    assert kg.KERNEL.launches == before


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quant_plan_is_a_function_of_the_shapes():
    """G's plan, for every projection shape of the chip smoke's G rows at
    M of 1, 8, 16, 17 and 512, and the ragged shapes: M <= 16 takes the
    split-K variant with 1 to 8 splits of K, no split without a 16-row
    slab for each of its 8 warps, and about two blocks an SM; M > 16 the
    wgmma variant on 128 x 128 tiles, unsplit. The same shapes give
    the same plan."""
    cs = _chip_smoke()
    shapes = ([(M, K, N) for K, N in cs.G_SHAPES for M in (1, 8, 16, 17, 512)]
              + [(37, 4100, 1000), (5, 4100, 1000), (3, 45, 33)])
    for M, K, N in shapes:
        p = kg.plan(M, K, N)
        assert p == kg.plan(M, K, N)
        assert p["variant"] in kg.VARIANTS
        if M <= 16:
            assert p["variant"] == "splitk"
            assert 1 <= p["splits"] <= kg.MAX_SPLITS
            assert p["tiles"] == -(-N // 128)
            assert p["splits"] == 1 or p["splits"] * 8 <= -(-K // 16)
            assert p["tiles"] * p["splits"] <= 2 * kg.SMS
        else:
            assert p["variant"] == "wgmma" and p["splits"] == 1
            assert p["tiles"] == -(-M // 128) * -(-N // 128)
    assert kg.plan(8, 4096, 11008)["splits"] == 3
    assert kg.plan(8, 4096, 4096)["splits"] == 8
    assert kg.plan(8, 4096, 32000)["splits"] == 1


def _bf16_bits(bits: np.ndarray) -> np.ndarray:
    """uint16 bf16 bit patterns -> their fp32 values."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def test_int8_to_bf16_route_of_the_kernel_is_exact():
    """The kernel's conversion without conversion units, modelled in numpy
    over every pair of bytes a 32-bit mask sees at once (bytes 0 and 2 of
    a word; bytes 1 and 3 after a shift by 8): with l a byte's low 7 bits
    and s its sign bit, the masks give the bf16 values 128 + l and
    128 * 2^s, whose difference is the byte's value, exactly in bf16."""
    v = np.arange(-128, 128, dtype=np.int32)
    lo, hi = np.meshgrid(v, v, indexing="ij")
    for shift in (0, 8):
        word = (((lo & 0xFF) << shift) | ((hi & 0xFF) << (16 + shift))
                ).astype(np.uint32)
        w = word >> np.uint32(shift)
        L = (w & np.uint32(0x007F007F)) | np.uint32(0x43004300)
        T = (w & np.uint32(0x00800080)) | np.uint32(0x43004300)
        for half, want in ((0, lo), (16, hi)):
            a = _bf16_bits((L >> np.uint32(half)) & np.uint32(0xFFFF))
            b = _bf16_bits((T >> np.uint32(half)) & np.uint32(0xFFFF))
            d = a - b  # exact in fp32, and a bf16 value: one rounding is none
            np.testing.assert_array_equal(d, want.astype(np.float32))
            bf = torch.from_numpy(d.reshape(-1)).to(torch.bfloat16).float()
            np.testing.assert_array_equal(bf.numpy(), d.reshape(-1))


# --------------------------------------------------------------------------- #
# kernel C, int8 variant
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("nkv", [8, 2])
@pytest.mark.parametrize("B,S,lens", [(4, 1, (5, 64, 33, 0)),
                                      (3, 4, (9, 64, 2)),
                                      (1, 16, (40,))])
def test_flash_decode_int8_plain_matches_pallas(B, S, lens, nkv):
    """Decode (S = 1, one slot empty), verify-shaped (B > 1, S = 4, one
    slot whose leading rows see nothing) and chunk (B = 1, S = 16) shapes,
    MHA (8/8) and GQA (8/2), over int8 K/V with per-row scales: the Pallas
    int8 path in interpret mode, fp32, atol 1e-5. Rows that see a key also
    agree with the dense attend over the dequantized cache."""
    rng = np.random.default_rng(20 + S + nkv)
    nh, D, T = 8, 16, 64
    q = _rand(rng, B, S, nh, D)
    kq, ks = jax_kv.quantize_kv(jnp.asarray(_rand(rng, B, T, nkv, D)))
    vq, vs = jax_kv.quantize_kv(jnp.asarray(_rand(rng, B, T, nkv, D)))
    lengths = np.asarray(lens, np.int32)
    scale = D ** -0.5
    want = np.asarray(jax_flash_decode(
        jnp.asarray(q), kq, vq, jnp.asarray(lengths), scale, k_scale=ks,
        v_scale=vs, block_t=16, interpret=True))
    t = [torch.from_numpy(np.array(a)) for a in (q, kq, vq, ks, vs)]
    tl = torch.from_numpy(lengths)
    got = kc.flash_decode_attention(t[0], t[1], t[2], tl, scale, t[3], t[4])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    cache = {"k": t[1], "v": t[2], "k_scale": t[3], "v_scale": t[4]}
    dense = kv_cache.attend(t[0], cache, tl, scale, impl="dense").numpy()
    visible = (lengths[:, None] - S + np.arange(S)[None, :]) >= 0
    np.testing.assert_allclose(got.numpy()[visible], dense[visible],
                               rtol=1e-5, atol=1e-5)
    assert not got.numpy()[~visible].any()
    with pytest.raises(ValueError, match="int8 cache blocks need"):
        kc.flash_decode_attention(t[0], t[1], t[2], tl, scale)


def test_int8_cache_write_and_insert_match_jax():
    """A decode write (one row per slot) and a chunk write quantize on
    write like JAX's ``cache_write``; ``insert_prefill`` copies the scale
    leaves too."""
    from picotron_tpu_torch.config import ModelConfig

    m = ModelConfig(num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=2, hidden_size=32,
                    intermediate_size=64, vocab_size=64, dtype="float32")
    cache = kv_cache.init_cache(m, slots=3, max_seq_len=16, quantized=True)
    assert kv_cache.quantized(cache) and cache["k"].dtype == torch.int8
    assert cache["k_scale"].shape == (2, 3, 16, 2)
    jcache = jax_kv.init_cache(m, 3, 16, quantized=True)
    assert kv_cache.cache_bytes(cache) == jax_kv.cache_bytes(jcache)
    rng = np.random.default_rng(3)
    k1, v1 = _rand(rng, 3, 1, 2, 8), _rand(rng, 3, 1, 2, 8)
    pos = np.array([0, 5, 9], np.int32)
    layer = {n: t[1] for n, t in cache.items() if n != "lengths"}
    kv_cache.cache_write(layer, torch.from_numpy(k1), torch.from_numpy(v1),
                         torch.from_numpy(pos))
    jl = jax_kv.cache_write({n: a[1] for n, a in jcache.items()
                             if n != "lengths"},
                            jnp.asarray(k1), jnp.asarray(v1),
                            jnp.asarray(pos))
    k4, v4 = _rand(rng, 1, 4, 2, 8), _rand(rng, 1, 4, 2, 8)
    chunk = {n: t[0, 2:3] for n, t in cache.items() if n != "lengths"}
    kv_cache.cache_write(chunk, torch.from_numpy(k4), torch.from_numpy(v4),
                         torch.tensor([6]))
    jc = jax_kv.cache_write({n: a[0, 2:3] for n, a in jcache.items()
                             if n != "lengths"},
                            jnp.asarray(k4), jnp.asarray(v4),
                            jnp.asarray([6], jnp.int32))
    for name in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(cache[name][1].numpy(),
                                      np.asarray(jl[name]))
        np.testing.assert_array_equal(cache[name][0, 2:3].numpy(),
                                      np.asarray(jc[name]))
    kq, ks = kv_cache.quantize_kv(torch.from_numpy(_rand(rng, 2, 1, 4, 2, 8)))
    kv_cache.insert_prefill(cache, {"k": kq, "v": kq, "k_scale": ks,
                                    "v_scale": ks}, 1, 3)
    assert torch.equal(cache["k_scale"][:, 1, :4], ks[:, 0])
    assert torch.equal(cache["v"][:, 1, :4], kq[:, 0])
    assert int(cache["lengths"][1]) == 3


# --------------------------------------------------------------------------- #
# the tree, convert, config
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def tiny():
    """(JAX config, port config, JAX int8 tree, port int8 tree) for the
    conftest model: 4 layers, GQA 8/4, H=64, fp32."""
    kwargs = dict(num_hidden_layers=4, num_attention_heads=8,
                  num_key_value_heads=4, hidden_size=64,
                  intermediate_size=128, vocab_size=256,
                  max_position_embeddings=128, rope_theta=10000.0,
                  dtype="float32", attention_impl="sdpa")
    jcfg = make_config(kwargs, seq=MAX_LEN)
    cfg = Config.from_dict({"model": kwargs, "inference": {
        "prefill_chunk": CHUNK, "decode_block_len": BLOCK,
        "weight_dtype": "int8", "kv_cache_dtype": "int8"}})
    dense = jax.jit(lambda k: jax_llama.init_params(k, jcfg.model))(
        jax.random.PRNGKey(0))
    jq = jax_llama.quantize_params(dense)
    params = convert.params_from_jax(jax.tree.map(np.asarray, jq))
    return jcfg, cfg, jq, params


def test_quantize_params_tree_bytes_and_convert(tiny):
    """The seven projections and lm_head become int8 pairs, embed and
    norms pass through; the port's quantize_params of the same dense
    tree gives JAX's pairs; convert keeps int8 and fp32 whatever dtype it
    is asked for, and carries the tree back; param_bytes agrees."""
    _, cfg, jq, params = tiny
    leaves = llama.QUANT_WEIGHT_LEAVES
    for name, leaf in params["layers"].items():
        assert qmm.is_quant_weight(leaf) == (name in leaves), name
    assert qmm.is_quant_weight(params["lm_head"])
    assert not qmm.is_quant_weight(params["embed"])
    assert params["layers"]["wq"]["q"].dtype == torch.int8
    assert llama.param_bytes(params) == jax_llama.param_bytes(jq)
    lp = llama.layer_params(params, 2)
    assert torch.equal(lp["w_up"]["q"], params["layers"]["w_up"]["q"][2])
    assert lp["w_up"]["s"].shape == (cfg.model.intermediate_size,)

    fq = llama.dequantize_params(params, torch.float32)
    mine = llama.quantize_params(fq)
    for name in leaves:
        torch.testing.assert_close(mine["layers"][name]["q"],
                                   params["layers"][name]["q"], rtol=0,
                                   atol=0)
    bf = convert.params_from_jax(jax.tree.map(np.asarray, jq),
                                 dtype=torch.bfloat16)
    assert bf["layers"]["wo"]["q"].dtype == torch.int8
    assert bf["layers"]["wo"]["s"].dtype == torch.float32
    assert bf["lm_head"]["s"].dtype == torch.float32
    assert bf["embed"].dtype == torch.bfloat16
    back = convert.params_to_jax(params)
    assert back["layers"]["wq"]["q"].dtype == np.int8
    for a, b in zip(jax.tree.leaves(jq), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_config_and_engine_validate_dtypes():
    with pytest.raises(ValueError, match=r"unknown inference.weight_dtype "
                                         r"'fp8' \(bf16\|int8\)"):
        Config.from_dict({"inference": {"weight_dtype": "fp8"}})
    with pytest.raises(ValueError, match=r"unknown inference.kv_cache_dtype "
                                         r"'fp8' \(auto\|int8\)"):
        Config.from_dict({"inference": {"kv_cache_dtype": "fp8"}})
    with pytest.raises(ValueError, match="not in the PyTorch port yet"):
        Config.from_dict({"inference": {"dp_size": 2}})
    with pytest.raises(ValueError, match="mutually exclusive with "
                                         "kv_cache_dtype: 'int8'"):
        Config.from_dict({"inference": {"kv_layout": "paged",
                                        "kv_page_policy": "hot_bf16",
                                        "kv_cache_dtype": "int8"}})
    cfg = Config.from_dict({"model": {
        "num_hidden_layers": 1, "num_attention_heads": 2,
        "num_key_value_heads": 2, "hidden_size": 16,
        "intermediate_size": 32, "vocab_size": 32, "dtype": "float32"},
        "inference": {"kv_cache_dtype": "int8"}})
    with pytest.raises(ValueError, match=r"unknown weight_dtype 'fp8'"):
        InferenceEngine(cfg, "cpu", weight_dtype="fp8")
    assert InferenceEngine(cfg, "cpu").quantized
    for cache_dtype, quant, dt in (("auto", False, torch.float32),
                                   (torch.bfloat16, False, torch.bfloat16),
                                   (torch.int8, True, torch.int8),
                                   ("int8", True, torch.int8)):
        eng = InferenceEngine(cfg, "cpu", cache_dtype=cache_dtype)
        assert (eng.quantized, eng.cache_dtype) == (quant, dt)
        assert eng.init_cache()["k"].dtype == dt
        assert ("k_scale" in eng.init_cache()) == quant
    eng = InferenceEngine(cfg, "cpu", weight_dtype="int8")
    assert eng.weight_dtype == "int8"


# --------------------------------------------------------------------------- #
# the slice as a whole
# --------------------------------------------------------------------------- #


def _prompts(vocab):
    rng = np.random.default_rng(7)
    return [rng.integers(1, vocab, n).tolist() for n in PROMPT_LENS]


@pytest.fixture(scope="module")
def jax_int8_greedy(tiny):
    """The JAX int8 engine's (weights and KV) greedy streams."""
    jcfg, cfg, jq, _ = tiny
    engine = JaxEngine(jcfg, slots=2, max_seq_len=MAX_LEN,
                       prefill_chunk=CHUNK, decode_block_len=BLOCK,
                       cache_dtype="int8", weight_dtype="int8")
    reqs = [JaxRequest(f"r{i}", p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(_prompts(cfg.model.vocab_size),
                                           NEW_TOKENS))]
    res = JaxBatcher(engine, engine.shard_params(jq)).run(reqs)
    return {u: r.tokens for u, r in res.items()}


def _run_port(cfg, params, attend_impl):
    engine = InferenceEngine(cfg, "cpu", slots=2, max_seq_len=MAX_LEN,
                             attend_impl=attend_impl)
    b = ContinuousBatcher(engine, params)
    reqs = [Request(f"r{i}", p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(_prompts(cfg.model.vocab_size),
                                           NEW_TOKENS))]
    return b, b.run(reqs)


@pytest.mark.parametrize("attend_impl", ["dense", "flash"])
def test_int8_engine_matches_jax_engine(tiny, jax_int8_greedy, attend_impl):
    """Token-identical greedy streams from the JAX tree: one-shot prefill
    (two prompts), chunked prefill (23 tokens in two chunks), blocked
    decode over the int8 cache; the batcher's stats report the resident
    bytes as JAX's helpers count them."""
    jcfg, cfg, jq, params = tiny
    b, res = _run_port(cfg, params, attend_impl)
    for uid, toks in jax_int8_greedy.items():
        assert res[uid].tokens == toks, uid
        assert res[uid].finish_reason == "length"
    assert b.prefill_dispatches == 1 + 2 + 1
    st = b.stats()
    assert (st["weight_dtype"], st["kv_cache_dtype"]) == ("int8", "int8")
    assert st["weight_bytes"] == jax_llama.param_bytes(jq)
    assert st["cache_bytes"] == jax_kv.cache_bytes(jax_kv.init_cache(
        jcfg.model, 2, MAX_LEN, quantized=True))


def test_serving_never_builds_a_dequantized_weight(tiny, jax_int8_greedy,
                                                   monkeypatch):
    """With ``dequantize_weight`` armed to raise, a full int8 generation
    still runs, and gives the same streams: no weight is ever
    dequantized on the serving path."""
    _, cfg, _, params = tiny

    def boom(*a, **k):
        raise AssertionError("serving path materialized a dequantized weight")

    monkeypatch.setattr(qmm, "dequantize_weight", boom)
    _, res = _run_port(cfg, params, "flash")
    assert {u: r.tokens for u, r in res.items()} == jax_int8_greedy


def test_generate_cli_int8_and_weight_parity(tmp_path, capsys):
    """The CLI with int8 weights and cache, on the CPU because the caller
    names it: the summary line says so, and ``--check-weight-parity``
    finds the fake-quant engine's greedy tokens identical. Its argument
    errors are the JAX tool's."""
    from picotron_tpu_torch.tools import generate

    path = tmp_path / "tiny.json"
    path.write_text(json.dumps({
        "model": {"num_hidden_layers": 2, "num_attention_heads": 4,
                  "num_key_value_heads": 2, "hidden_size": 32,
                  "intermediate_size": 64, "vocab_size": 64,
                  "max_position_embeddings": 48, "dtype": "float32"},
        "inference": {"attend_impl": "flash", "prefill_chunk": 8},
        "training": {"seq_length": 48}}))
    base = ["--config", str(path), "--random-init", "--seed", "3",
            "--prompt-ids", "1,2,3", "--prompt-ids",
            ",".join(str(i % 60 + 1) for i in range(13)),
            "--max-new-tokens", "5", "--slots", "2",
            "--decode-block-len", "2"]
    rc = generate.main(base + ["--weight-dtype", "int8", "--kv-cache-dtype",
                               "int8", "--check-weight-parity"],
                       device="cpu")
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "weight parity: int8 == fake-quant reference for 2 requests" \
        in out
    assert re.search(
        r"^10 tokens in [\d.]+s \([\d.]+ tok/s, setup [\d.]+s, slots=2, "
        r"tp=1, block=2, kv=int8, weights=int8, \d+ decode dispatches "
        r"= [\d.]+/token\)$", out, re.M), out
    with pytest.raises(SystemExit):
        generate.main(base + ["--check-weight-parity"], device="cpu")
    assert "pass --weight-dtype int8" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        generate.main(base + ["--weight-dtype", "int8",
                              "--check-weight-parity", "--temperature",
                              "0.7"], device="cpu")
    assert "greedy-only gate" in capsys.readouterr().err
