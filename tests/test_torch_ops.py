"""The PyTorch port's ops against the JAX package's, on the CPU.

Every kernel of the port's serving and training paths has a plain PyTorch
version, which is what a CPU tensor runs (through the same autograd
Function the card runs, for the backward kernels D, E and F). Here each plain version is held to the JAX
function it replaces, on the same inputs made with numpy from a seed: the
Pallas kernels run in interpret mode, as tests/test_pallas_kernels.py and
tests/test_decode_kernel.py run them. Also pinned: the samplers' filter,
the no-card contract (entry points default to CUDA and raise without it; a
kernel wrapper never falls back to its plain version for a non-CPU
tensor), the config loader, the parameter converter, and that the port
imports neither JAX nor the JAX package.
"""

import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

if not hasattr(pltpu, "force_tpu_interpret_mode"):
    # environment, not code: the installed jax predates the Mosaic
    # interpret-mode context manager every test here runs under — skip
    # (pass/skip signal) instead of failing on an AttributeError floor
    pytest.skip(
        f"jax {jax.__version__} lacks pltpu.force_tpu_interpret_mode "
        "(the TPU-interpreter-on-CPU API this module needs)",
        allow_module_level=True)

from picotron_tpu.config import Config as JaxConfig
from picotron_tpu.inference import kv_cache as jax_kv
from picotron_tpu.inference import sampling as jax_sampling
from picotron_tpu.ops.pallas.decode_attention import (
    flash_decode_attention as jax_flash_decode,
)
from picotron_tpu.ops.pallas.flash_attention import (
    flash_attention as jax_flash_attention,
)
from picotron_tpu.ops.pallas.flash_attention import flash_attention_with_lse
from picotron_tpu.ops.pallas.rmsnorm import rms_norm_pallas
from picotron_tpu.ops.rmsnorm import rms_norm as jax_rms_norm
from picotron_tpu_torch import convert
from picotron_tpu_torch.config import Config
from picotron_tpu_torch.inference import kv_cache, sampling
from picotron_tpu_torch.ops.kernels import decode_attention as kc
from picotron_tpu_torch.ops.kernels import flash_attention as kb
from picotron_tpu_torch.ops.kernels import lora_matmul as kh
from picotron_tpu_torch.ops.kernels import rmsnorm as ka

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _bf16(a):
    """numpy float32 -> (jax bf16 array, torch bf16 tensor), same values."""
    t = torch.from_numpy(a).to(torch.bfloat16)
    return jnp.asarray(a, jnp.bfloat16), t


# --------------------------------------------------------------------------- #
# kernel A: RMSNorm
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_matches_pallas(dtype):
    """fp32: allclose at 1e-6. bf16: within one bf16 rounding step (the
    two sides may round x * rsqrt(var + eps) on either side of a tie)."""
    rng = np.random.default_rng(0)
    x, w = _rand(rng, 3, 8, 64), 1.0 + 0.1 * _rand(rng, 64)
    if dtype == "float32":
        jx, jw, tx, tw = jnp.asarray(x), jnp.asarray(w), torch.from_numpy(x), \
            torch.from_numpy(w)
        tol = dict(rtol=1e-6, atol=1e-6)
    else:
        (jx, tx), (jw, tw) = _bf16(x), _bf16(w)
        tol = dict(rtol=2 ** -7, atol=2 ** -7)
    with pltpu.force_tpu_interpret_mode():
        want = rms_norm_pallas(jx, jw, 1e-5)
    got = ka.rms_norm(tx, tw, 1e-5)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


# --------------------------------------------------------------------------- #
# kernel D: RMSNorm backward
# --------------------------------------------------------------------------- #


def _rmsnorm_bwd_numpy(x, w, dy, eps):
    """The Pallas ``_bwd_kernel`` formula (:46-55) in float64 numpy."""
    x, w, dy = (np.asarray(a, np.float64) for a in (x, w, dy))
    r = 1.0 / np.sqrt((x * x).mean(-1, keepdims=True) + eps)
    xhat, dxhat = x * r, dy * w
    dx = r * (dxhat - xhat * (dxhat * xhat).mean(-1, keepdims=True))
    return dx, (dy * xhat).reshape(-1, x.shape[-1]).sum(0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_backward_matches_jax_vjp(dtype):
    """The plain backward and the Function's CPU backward against jax.vjp
    of the plain ``picotron_tpu.ops.rmsnorm.rms_norm`` (the Pallas
    backward does not run under this jax) and the formula in numpy. fp32:
    1e-5. bf16: within two bf16 rounding steps (2^-7 relative) -- the vjp
    of the plain function rounds at its bf16 casts, the kernel's formula
    stays in fp32 until the outputs."""
    rng = np.random.default_rng(6)
    eps = 1e-5
    x, w = _rand(rng, 3, 10, 64), 1.0 + 0.1 * _rand(rng, 64)
    dy = _rand(rng, 3, 10, 64)
    if dtype == "float32":
        (jx, tx), (jw, tw), (jdy, tdy) = ((jnp.asarray(a), torch.from_numpy(a))
                                          for a in (x, w, dy))
        tol = dict(rtol=1e-5, atol=1e-5)
    else:
        (jx, tx), (jw, tw), (jdy, tdy) = (_bf16(a) for a in (x, w, dy))
        tol = dict(rtol=2 ** -7, atol=2 ** -7)
    _, vjp = jax.vjp(lambda a, b: jax_rms_norm(a, b, eps), jx, jw)
    jdx, jdw = (np.asarray(g, np.float32) for g in vjp(jdy))
    ndx, ndw = _rmsnorm_bwd_numpy(tx.float(), tw.float(), tdy.float(), eps)
    pdx, pdw = ka.rms_norm_bwd_plain(tx, tw, tdy, eps)
    xg, wg = tx.clone().requires_grad_(True), tw.clone().requires_grad_(True)
    out = ka.rms_norm(xg, wg, eps)
    assert out.grad_fn is not None and "RMSNormFunction" in str(out.grad_fn)
    out.backward(tdy)
    for dx, dw in ((pdx, pdw), (xg.grad, wg.grad)):
        assert dx.dtype == tx.dtype and dw.dtype == tw.dtype
        np.testing.assert_allclose(dx.float().numpy(), jdx, **tol)
        np.testing.assert_allclose(dw.float().numpy(), jdw,
                                   rtol=tol["rtol"], atol=tol["atol"] * 30)
        np.testing.assert_allclose(dx.float().numpy(), ndx, **tol)
        np.testing.assert_allclose(dw.float().numpy(), ndw,
                                   rtol=tol["rtol"], atol=tol["atol"] * 30)


# --------------------------------------------------------------------------- #
# kernel B: causal flash attention
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nkv", [4, 2])
def test_flash_attention_plain_matches_pallas(nkv, dtype):
    """The port takes compact GQA K/V (query head h reads kv head
    h // g); the JAX kernel takes K/V repeated to every head, as the JAX
    model repeats them before the call. fp32: 2e-5 (the Pallas tests'
    tolerance). bf16: both round P to bf16 before P @ V; 1e-2."""
    rng = np.random.default_rng(1)
    B, S, nh, D = 2, 32, 4, 16
    q, k, v = _rand(rng, B, S, nh, D), _rand(rng, B, S, nkv, D), \
        _rand(rng, B, S, nkv, D)
    g = nh // nkv
    kr, vr = np.repeat(k, g, axis=2), np.repeat(v, g, axis=2)
    scale = D ** -0.5
    if dtype == "float32":
        jq, jk, jv = map(jnp.asarray, (q, kr, vr))
        tq, tk, tv = map(torch.from_numpy, (q, k, v))
        tol = dict(rtol=2e-5, atol=2e-5)
    else:
        (jq, tq), (jk, _), (jv, _) = _bf16(q), _bf16(kr), _bf16(vr)
        tk, tv = _bf16(k)[1], _bf16(v)[1]
        tol = dict(rtol=1e-2, atol=1e-2)
    with pltpu.force_tpu_interpret_mode():
        want = jax_flash_attention(jq, jk, jv, scale, causal=True,
                                   block_q=16, block_k=16)
    got = kb.flash_attention(tq, tk, tv, scale)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("S", [16, 130])
def test_flash_attention_lse_matches_pallas(S):
    """B's LSE output [B, H, S] against flash_attention_with_lse ([B, S, H])
    in interpret mode, and the output beside it. fp32, 2e-5."""
    rng = np.random.default_rng(7)
    B, nh, nkv, D = 2, 4, 2, 16
    q, k, v = _rand(rng, B, S, nh, D), _rand(rng, B, S, nkv, D), \
        _rand(rng, B, S, nkv, D)
    scale = D ** -0.5
    with pltpu.force_tpu_interpret_mode():
        want_o, want_lse = flash_attention_with_lse(
            *(jnp.asarray(a) for a in (q, np.repeat(k, 2, 2),
                                       np.repeat(v, 2, 2))), scale)
    got_o, got_lse = kb.flash_attention_fwd(
        *map(torch.from_numpy, (q, k, v)), scale, return_lse=True)
    assert got_lse.shape == (B, nh, S) and got_lse.dtype == torch.float32
    np.testing.assert_allclose(got_lse.numpy(),
                               np.asarray(want_lse).transpose(0, 2, 1),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o),
                               rtol=2e-5, atol=2e-5)


# --------------------------------------------------------------------------- #
# kernels E and F: flash-attention backward
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("S", [16, 48, 130])
@pytest.mark.parametrize("nkv", [4, 2])
def test_flash_attention_backward_matches_pallas_vjp(nkv, S):
    """The plain backward (and the Function's CPU backward) against jax.vjp
    of the Pallas flash_attention in interpret mode, on K/V repeated with
    jnp.repeat on the JAX side: its dK/dV come back per repeated head and
    are summed over each kv head's group, which is what the port's compact
    dk/dv hold. Also against torch autograd of flash_attention_plain. fp32:
    5e-5 (the Pallas tests' gradient tolerance)."""
    rng = np.random.default_rng(10 + S + nkv)
    B, nh, D = 2, 4, 16
    g = nh // nkv
    q, k, v = _rand(rng, B, S, nh, D), _rand(rng, B, S, nkv, D), \
        _rand(rng, B, S, nkv, D)
    do = _rand(rng, B, S, nh, D)
    scale = D ** -0.5

    def jax_loss_fn(q_, k_, v_):
        kr, vr = jnp.repeat(k_, g, axis=2), jnp.repeat(v_, g, axis=2)
        return jax_flash_attention(q_, kr, vr, scale, causal=True)

    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(jax_loss_fn, *map(jnp.asarray, (q, k, v)))
        want = [np.asarray(a) for a in vjp(jnp.asarray(do))]
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = kb.flash_attention_fwd(tq, tk, tv, scale, return_lse=True)
    plain = kb.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, scale)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    out = kb.flash_attention(*leaves, scale)
    assert "FlashAttentionFunction" in str(out.grad_fn)
    out.backward(tdo)
    ref = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    kb.flash_attention_plain(*ref, scale).backward(tdo)
    tol = dict(rtol=5e-5, atol=5e-5)
    for i, name in enumerate("qkv"):
        for got in (plain[i], leaves[i].grad, ref[i].grad):
            assert got.shape == (tq, tk, tv)[i].shape
            np.testing.assert_allclose(got.numpy(), want[i], err_msg=f"d{name}",
                                       **tol)


def test_flash_attention_backward_rounds_like_pallas_in_bf16():
    """bf16 inputs: the plain backward rounds dS and P at the Pallas
    bodies' points; against the Pallas vjp in interpret mode (same
    rounding points) within 2e-2, the bf16 tolerance of the forward."""
    rng = np.random.default_rng(21)
    B, S, nh, D = 1, 32, 2, 16
    q, k, v, do = (_rand(rng, B, S, nh, D) for _ in range(4))
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = map(_bf16, (q, k, v, do))
    scale = D ** -0.5
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda a, b, c: jax_flash_attention(
            a, b, c, scale, causal=True, block_q=16, block_k=16), jq, jk, jv)
        want = [np.asarray(a, np.float32) for a in vjp(jdo)]
    o, lse = kb.flash_attention_fwd(tq, tk, tv, scale, return_lse=True)
    got = kb.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, scale)
    for a, w, name in zip(got, want, "qkv"):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(), w, rtol=2e-2,
                                   atol=2e-2, err_msg=f"d{name}")


# --------------------------------------------------------------------------- #
# kernel C: flash decode, and the dense cache attention
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("S", [1, 4])
def test_flash_decode_plain_matches_pallas_and_dense(S):
    """GQA 8/4, mixed lengths (a full window, a short slot, one whose
    leading query rows see nothing). The flash semantics return zeros
    for rows with no visible key, on both sides; the dense references
    (JAX's and the port's) agree on every row that sees a key. fp32,
    2e-5."""
    rng = np.random.default_rng(2 + S)
    B, nh, nkv, D, T = 4, 8, 4, 16, 64
    q = _rand(rng, B, S, nh, D)
    k, v = _rand(rng, B, T, nkv, D), _rand(rng, B, T, nkv, D)
    lengths = np.array([5, T, 33, 2], np.int32)
    scale = D ** -0.5
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    tl = torch.from_numpy(lengths)
    want = np.asarray(jax_flash_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        scale, block_t=16, interpret=True))
    got = kc.flash_decode_attention(tq, tk, tv, tl, scale).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)

    visible = (lengths[:, None] - S + np.arange(S)[None, :]) >= 0  # [B, S]
    dense_jax = np.asarray(jax_kv.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        scale))
    dense = kv_cache.decode_attention(tq, tk, tv, tl, scale).numpy()
    np.testing.assert_allclose(dense, dense_jax, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got[visible], dense[visible], rtol=2e-5,
                               atol=2e-5)
    assert not got[~visible].any()


def test_attend_dispatches_on_impl():
    rng = np.random.default_rng(9)
    q = torch.from_numpy(_rand(rng, 2, 1, 4, 8))
    cache = {"k": torch.from_numpy(_rand(rng, 2, 16, 2, 8)),
             "v": torch.from_numpy(_rand(rng, 2, 16, 2, 8))}
    lengths = torch.tensor([3, 16], dtype=torch.int32)
    for impl in ("dense", "flash"):
        out = kv_cache.attend(q, cache, lengths, 0.3, impl=impl)
        assert out.shape == q.shape
    torch.testing.assert_close(
        kv_cache.attend(q, cache, lengths, 0.3, impl="dense"),
        kv_cache.attend(q, cache, lengths, 0.3, impl="flash"),
        rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError, match="unknown attend impl"):
        kv_cache.attend(q, cache, lengths, 0.3, impl="pallas")


def test_cache_write_insert_release_in_place():
    """Decode writes one row per slot at its own position, a chunk writes
    a contiguous block, insert parks a prefill; all in place."""
    from picotron_tpu_torch.config import ModelConfig

    m = ModelConfig(num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=2, hidden_size=32,
                    intermediate_size=64, vocab_size=64, dtype="float32")
    cache = kv_cache.init_cache(m, slots=3, max_seq_len=16)
    assert cache["k"].shape == (2, 3, 16, 2, 8)
    layer = {"k": cache["k"][1], "v": cache["v"][1]}
    new = torch.ones(3, 1, 2, 8)
    kv_cache.cache_write(layer, new, 2 * new, torch.tensor([0, 5, 9]))
    assert cache["k"][1, [0, 1, 2], [0, 5, 9]].eq(1).all()
    assert cache["v"][1, [0, 1, 2], [0, 5, 9]].eq(2).all()
    assert cache["k"][1].sum() == 3 * 2 * 8  # nothing else written
    chunk = {"k": cache["k"][0, 2:3], "v": cache["v"][0, 2:3]}
    kv_cache.cache_write(chunk, 3 * torch.ones(1, 4, 2, 8),
                         torch.ones(1, 4, 2, 8), torch.tensor([6]))
    assert cache["k"][0, 2, 6:10].eq(3).all()
    kv = {"k": torch.full((2, 1, 4, 2, 8), 7.0),
          "v": torch.full((2, 1, 4, 2, 8), 8.0)}
    kv_cache.insert_prefill(cache, kv, 1, 3)
    assert cache["k"][:, 1, :4].eq(7).all() and int(cache["lengths"][1]) == 3
    kv_cache.release(cache, 1)
    assert int(cache["lengths"][1]) == 0


# --------------------------------------------------------------------------- #
# sampling
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_filter_top_k_top_p_matches_jax_exactly(seed):
    """Same kept set, same values, for every mix of the two filters
    (disabled, ties at the k-th value, p <= 0 pinning the top-1)."""
    rng = np.random.default_rng(seed)
    B, V = 8, 64
    logits = _rand(rng, B, V) * 3
    logits[0, :5] = logits[0, 0]  # ties at the top-k threshold
    top_k = np.array([0, 3, 1, 10, 64, 5, 0, 2], np.int32)
    top_p = np.array([1.0, 0.9, 0.5, 0.0, 0.95, 1.0, 0.3, 0.99], np.float32)
    want = np.asarray(jax_sampling.filter_top_k_top_p(
        jnp.asarray(logits), jnp.asarray(top_k), jnp.asarray(top_p)))
    got = sampling.filter_top_k_top_p(
        torch.from_numpy(logits), torch.from_numpy(top_k),
        torch.from_numpy(top_p)).numpy()
    np.testing.assert_array_equal(got, want)
    # and the one-sort filter equals the two filters applied in sequence
    seq = sampling.apply_top_p(
        sampling.apply_top_k(torch.from_numpy(logits),
                             torch.from_numpy(top_k)),
        torch.from_numpy(top_p)).numpy()
    np.testing.assert_array_equal(got, seq)


def test_sample_greedy_rows_nonfinite_rows_and_support():
    """temperature 0 and non-finite rows are greedy; a stochastic draw
    stays inside the filtered support; the generator fixes the draw."""
    rng = np.random.default_rng(5)
    logits = torch.from_numpy(_rand(rng, 4, 32))
    logits[2, 7] = float("nan")
    temp = torch.tensor([0.0, 1.0, 1.0, 0.7])
    top_k = torch.tensor([0, 3, 0, 1], dtype=torch.int32)
    top_p = torch.tensor([1.0, 1.0, 1.0, 1.0])
    g = torch.Generator().manual_seed(0)
    for _ in range(20):
        tok = sampling.sample(logits, g, temp, top_k, top_p)
        assert tok[0] == sampling.greedy(logits[:1])[0]
        assert tok[2] == sampling.greedy(
            sampling.sanitize_logits(logits[2:3]))[0]
        assert tok[3] == sampling.greedy(logits[3:4])[0]  # top_k = 1
        assert tok[1] in torch.topk(logits[1], 3).indices
    a = sampling.sample(logits, torch.Generator().manual_seed(3), temp,
                        top_k, top_p)
    b = sampling.sample(logits, torch.Generator().manual_seed(3), temp,
                        top_k, top_p)
    assert torch.equal(a, b)


# --------------------------------------------------------------------------- #
# the no-card contract
# --------------------------------------------------------------------------- #


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from picotron_tpu_torch.inference.engine import InferenceEngine
    from picotron_tpu_torch.tools import generate

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config.from_dict({"model": {
        "num_hidden_layers": 1, "num_attention_heads": 2,
        "num_key_value_heads": 2, "hidden_size": 16,
        "intermediate_size": 32, "vocab_size": 32, "dtype": "float32"}})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(cfg)
    assert InferenceEngine(cfg, "cpu").device.type == "cpu"
    path = os.path.join(REPO, "configs", "2_smollm_dp8", "config.json")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate.main(["--config", path, "--random-init", "--prompt-ids",
                       "1,2"])


def test_kernel_wrappers_never_fall_back(monkeypatch):
    """A tensor that is not on the CPU goes to the kernel or raises; the
    plain version is never called for it."""
    def boom(*a, **k):
        raise AssertionError("plain version called for a non-CPU tensor")

    monkeypatch.setattr(ka, "rms_norm_plain", boom)
    monkeypatch.setattr(ka, "rms_norm_bwd_plain", boom)
    monkeypatch.setattr(kb, "flash_attention_plain", boom)
    monkeypatch.setattr(kb, "flash_attention_bwd_plain", boom)
    monkeypatch.setattr(kc, "flash_decode_attention_plain", boom)
    monkeypatch.setattr(kh, "lora_matmul_plain", boom)
    meta = dict(device="meta", dtype=torch.bfloat16)
    x = torch.empty(4, 64, **meta)
    with pytest.raises(ValueError, match="CUDA"):
        ka.rms_norm(x, torch.empty(64, **meta))
    with pytest.raises(ValueError, match="CUDA"):  # kernel D
        ka.rms_norm_bwd(x, torch.empty(64, **meta), x)
    with pytest.raises(ValueError, match="CUDA"):  # under autograd
        ka.rms_norm(x.requires_grad_(True), torch.empty(64, **meta))
    q = torch.empty(1, 16, 4, 64, **meta)
    with pytest.raises(ValueError, match="CUDA"):
        kb.flash_attention(q, q, q, 0.125)
    lse = torch.empty(1, 4, 16, device="meta", dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):  # kernels E and F
        kb.flash_attention_bwd(q, q, q, q, lse, q, 0.125)
    with pytest.raises(ValueError, match="CUDA"):  # B with its LSE
        kb.flash_attention(q.requires_grad_(True), q, q, 0.125)
    with pytest.raises(ValueError, match="CUDA"):
        kc.flash_decode_attention(q, q, q, torch.empty(1, device="meta",
                                                       dtype=torch.int32),
                                  0.125)
    fp32 = dict(device="meta", dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):  # kernel H
        kh.segmented_lora(torch.empty(2, 3, 64, **meta),
                          torch.empty(4, 64, 8, **fp32),
                          torch.empty(4, 8, 32, **fp32),
                          torch.empty(2, device="meta", dtype=torch.int32))
    # and a CPU tensor takes the plain path without touching the build
    monkeypatch.undo()
    monkeypatch.setattr(
        "picotron_tpu_torch.ops.kernels.build.library", boom)
    x = torch.zeros(2, 64)
    assert ka.rms_norm(x, torch.ones(64)).shape == x.shape
    xg = torch.ones(2, 64, requires_grad=True)
    ka.rms_norm(xg, torch.ones(64)).sum().backward()
    q = torch.ones(1, 16, 2, 8, requires_grad=True)
    kb.flash_attention(q, q, q).sum().backward()
    assert xg.grad.shape == xg.shape and q.grad.shape == q.shape
    ids = torch.tensor([1, 0], dtype=torch.int32)
    out = kh.segmented_lora(torch.ones(2, 3, 8), torch.ones(2, 8, 4),
                            torch.ones(2, 4, 5), ids)
    assert out.shape == (2, 3, 5) and bool((out[1] == 32.0).all())


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    """Source scan of the package and chip_smoke.py, plus a fresh
    interpreter that imports every module and finds no jax loaded."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|picotron_tpu)(\.|\s|$)",
                     re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "picotron_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for name in ("train.py", "train_step.py", "data.py",
                 os.path.join("ops", "cross_entropy.py"),
                 os.path.join("ops", "quant_matmul.py"),
                 os.path.join("ops", "kernels", "quant_matmul.py"),
                 os.path.join("inference", "paged_kv.py"),
                 os.path.join("ops", "lora_matmul.py"),
                 os.path.join("ops", "kernels", "lora_matmul.py"),
                 os.path.join("inference", "tenancy.py")):
        assert os.path.join(REPO, "picotron_tpu_torch", name) in files
    for path in files:
        with open(path) as f:
            hits = pat.findall(f.read())
        assert not hits, f"{path} imports {hits}"
    mods = [os.path.relpath(p, REPO)[:-3].replace(os.sep, ".")
            for p in files if "picotron_tpu_torch" in p]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "import chip_smoke\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'picotron_tpu' or "
            "m.startswith('picotron_tpu.')]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)


# --------------------------------------------------------------------------- #
# config and parameter carrying
# --------------------------------------------------------------------------- #


def test_configs_load_to_the_same_model_as_the_jax_package():
    for name in sorted(os.listdir(os.path.join(REPO, "configs"))):
        path = os.path.join(REPO, "configs", name, "config.json")
        with open(path) as f:
            raw = json.load(f)
        port = Config.from_dict(raw).model
        ref = JaxConfig.from_dict(raw).model
        for field in ("num_hidden_layers", "num_attention_heads",
                      "num_key_value_heads", "hidden_size",
                      "intermediate_size", "vocab_size", "rms_norm_eps",
                      "rope_theta", "max_position_embeddings", "dtype",
                      "attention_impl", "head_dim"):
            assert getattr(port, field) == getattr(ref, field), (name, field)


def test_config_validation_messages_and_unported_options():
    with pytest.raises(ValueError, match=r"unknown inference.attend_impl "
                                         r"'pallas' \(dense\|flash\)"):
        Config.from_dict({"inference": {"attend_impl": "pallas"}})
    with pytest.raises(ValueError, match="num_attention_heads must be a "
                                         "multiple of num_key_value_heads"):
        Config.from_dict({"model": {"num_attention_heads": 6,
                                    "num_key_value_heads": 4}})
    with pytest.raises(ValueError, match="inference.decode_block_len must"):
        Config.from_dict({"inference": {"decode_block_len": 0}})
    with pytest.raises(ValueError, match="not in the PyTorch port yet"):
        Config.from_dict({"inference": {"dp_size": 2}})
    cfg = Config.from_dict({"inference": {"kv_layout": "contiguous",
                                          "unknown_knob": 3},
                            "training": {"seq_length": 4}})
    assert cfg.inference.attend_impl == "dense"


def test_params_from_jax_round_trip_including_bf16():
    from picotron_tpu.models import llama as jax_llama
    from picotron_tpu.config import ModelConfig as JaxModel

    m = JaxModel(num_hidden_layers=2, num_attention_heads=4,
                 num_key_value_heads=2, hidden_size=16, intermediate_size=32,
                 vocab_size=32, dtype="bfloat16")
    tree = jax.tree.map(np.asarray,
                        jax_llama.init_params(jax.random.PRNGKey(0), m))
    params = convert.params_from_jax(tree)
    assert params["layers"]["wq"].dtype == torch.bfloat16
    assert params["layers"]["wq"].shape == (2, 16, 16)
    back = convert.params_to_jax(params)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)
