"""Kernels B, E and F's plain versions at the kernels' real head dims, and
the kernels' C interface.

On the card, ``chip_smoke.py`` holds the tensor-core kernels B
(``csrc/flash_attention.cu``), E (``csrc/flash_attention_bwd.cu``) and F
(``csrc/flash_attention_bwd_dkv.cu``) against ``flash_attention_plain``,
``flash_attention_bwd_dq_plain`` and ``flash_attention_bwd_dkv_plain``.
Here those plain versions are held to the Pallas kernels in interpret mode
at head_dim 64 and 128, GQA g = 4 (E also g = 1) and ragged S, in bf16:
the inputs the kernels take. The C interface test parses every exported
``picotron_*`` prototype in ``csrc/*.cu`` and holds it to the ctypes
argtypes in ``build.SIGNATURES``: a mismatch there is silent on the card.
"""

from __future__ import annotations

import glob
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from picotron_tpu.ops.pallas.flash_attention import (
    flash_attention as jax_flash_attention,
)
from picotron_tpu.ops.pallas.flash_attention import flash_attention_with_lse
from picotron_tpu_torch.ops.kernels import build
from picotron_tpu_torch.ops.kernels import flash_attention as kb

NH, NKV = 4, 1  # GQA g = 4
BLOCK = 16  # Pallas tiles where they divide S (80); one tile for S = 130


@pytest.fixture(autouse=True)
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _inputs(seed, S, D, n):
    """``n`` bf16 arrays [1, S, heads, D] (q-shaped first, then k/v-shaped
    for the rest but the last when ``n`` is 4: q, k, v, dO), as (jax,
    torch) pairs of the same values."""
    rng = np.random.default_rng(seed)
    heads = (NH, NKV, NKV, NH)[:n]
    out = []
    for h in heads:
        a = rng.standard_normal((1, S, h, D)).astype(np.float32)
        out.append((jnp.asarray(a, jnp.bfloat16),
                    torch.from_numpy(a).to(torch.bfloat16)))
    return out


def _blocks(S):
    return dict(block_q=BLOCK, block_k=BLOCK) if S % BLOCK == 0 else {}


@pytest.mark.parametrize("S", [80, 130])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_forward_plain_with_lse_matches_pallas(D, S):
    """B's function with its LSE (the training forward) against
    flash_attention_with_lse in interpret mode, on K/V repeated to every
    head on the JAX side. Output 2e-2 (both round P to bf16 before P @ V,
    and the output to bf16); LSE 2e-5 relative (fp32 in both)."""
    (jq, tq), (jk, tk), (jv, tv) = _inputs(D + S, S, D, 3)
    scale = D ** -0.5
    g = NH // NKV
    with pltpu.force_tpu_interpret_mode():
        want_o, want_lse = flash_attention_with_lse(
            jq, jnp.repeat(jk, g, axis=2), jnp.repeat(jv, g, axis=2), scale,
            **_blocks(S))
    got_o, got_lse = kb.flash_attention_fwd(tq, tk, tv, scale,
                                            return_lse=True)
    assert got_o.dtype == torch.bfloat16 and got_o.shape == tq.shape
    assert got_lse.shape == (1, NH, S) and got_lse.dtype == torch.float32
    np.testing.assert_allclose(got_o.float().numpy(),
                               np.asarray(want_o, np.float32),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got_lse.numpy(),
                               np.asarray(want_lse).transpose(0, 2, 1),
                               rtol=2e-5, atol=0)


@pytest.mark.parametrize("S", [80, 130])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_dkv_plain_matches_pallas_vjp(D, S):
    """F's function against the dK/dV of jax.vjp of the Pallas
    flash_attention in interpret mode, whose K/V are jnp.repeat-ed to
    every head, so its gradients come back summed over each kv head's
    group: the compact dk/dv F writes. lse and delta are the port's own (B
    and E's plain versions), as F gets them. bf16 in both, same rounding
    points (P and dS to bf16 before the products); 2e-2."""
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = _inputs(2 * D + S, S, D, 4)
    scale = D ** -0.5
    g = NH // NKV
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda a, b, c: jax_flash_attention(
            a, jnp.repeat(b, g, axis=2), jnp.repeat(c, g, axis=2), scale,
            causal=True, **_blocks(S)), jq, jk, jv)
        _, want_dk, want_dv = vjp(jdo)
    o, lse = kb.flash_attention_fwd(tq, tk, tv, scale, return_lse=True)
    _, delta = kb.flash_attention_bwd_dq_plain(tq, tk, tv, o, lse, tdo, scale)
    dk, dv = kb.flash_attention_bwd_dkv_plain(tq, tk, tv, tdo, lse, delta,
                                              scale)
    for got, want, name in ((dk, want_dk, "dk"), (dv, want_dv, "dv")):
        assert got.dtype == torch.bfloat16 and got.shape == tk.shape
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=2e-2,
                                   atol=2e-2, err_msg=name)


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("S", [80, 130])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_dq_plain_matches_pallas_vjp(D, S, g):
    """E's function against jax.vjp of the Pallas flash_attention in
    interpret mode (K/V jnp.repeat-ed to every head), at MHA (g = 1) and
    GQA (g = 4): dq against the VJP's dQ, delta against rowsum(dO * O) in
    fp32 over the Pallas forward's own output, which E is given as o. lse
    is the port's (B's plain version), as E gets it. bf16 in both, dS
    rounded to bf16 before the dQ product in both; dq 2e-2, delta 1e-5
    relative (one fp32 sum of the same bf16 products)."""
    rng = np.random.default_rng(3 * D + S + g)
    nkv = NH // g
    arrays = [rng.standard_normal((1, S, h, D)).astype(np.float32)
              for h in (NH, nkv, nkv, NH)]
    jq, jk, jv, jdo = (jnp.asarray(a, jnp.bfloat16) for a in arrays)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(torch.bfloat16)
                       for a in arrays)
    scale = D ** -0.5
    with pltpu.force_tpu_interpret_mode():
        jo, vjp = jax.vjp(lambda a, b, c: jax_flash_attention(
            a, jnp.repeat(b, g, axis=2), jnp.repeat(c, g, axis=2), scale,
            causal=True, **_blocks(S)), jq, jk, jv)
        want_dq, _, _ = vjp(jdo)
    o = torch.from_numpy(np.asarray(jo, np.float32)).to(torch.bfloat16)
    _, lse = kb.flash_attention_plain(tq, tk, tv, scale, return_lse=True)
    dq, delta = kb.flash_attention_bwd_dq_plain(tq, tk, tv, o, lse, tdo,
                                                scale)
    assert dq.dtype == torch.bfloat16 and dq.shape == tq.shape
    assert delta.dtype == torch.float32 and delta.shape == (1, NH, S)
    np.testing.assert_allclose(dq.float().numpy(),
                               np.asarray(want_dq, np.float32), rtol=2e-2,
                               atol=2e-2)
    want_delta = np.sum(np.asarray(jdo, np.float32) * np.asarray(
        jo, np.float32), axis=-1).transpose(0, 2, 1)
    np.testing.assert_allclose(delta.numpy(), want_delta, rtol=1e-5,
                               atol=1e-5)


_PROTO = re.compile(r'extern\s+"C"\s+int\s+(picotron_\w+)\s*\(([^)]*)\)')


def _exported() -> dict:
    """name -> argument list of every ``extern "C" int picotron_*``
    definition in the kernel sources."""
    found = {}
    for path in sorted(glob.glob(os.path.join(build.CSRC, "*.cu"))):
        with open(path) as f:
            for name, args in _PROTO.findall(f.read()):
                assert name not in found, f"{name} defined twice"
                found[name] = [a.strip() for a in args.split(",")]
    return found


def _ctype(arg: str):
    if "*" in arg:
        return build._P
    kind = arg.split()[0]
    return {"int": build._I, "float": build._F}[kind]


def test_exported_names_match_signatures():
    """The same set of exported names on both sides."""
    assert set(_exported()) == set(build.SIGNATURES)


@pytest.mark.parametrize("name", sorted(build.SIGNATURES))
def test_c_prototype_matches_ctypes_argtypes(name):
    """Each exported function's parameters, in order: ``_P`` for a
    pointer (``void*``, ``const void*``), ``_I`` for an int, ``_F`` for a
    float."""
    args = _exported().get(name)
    assert args is not None, f"{name} is in SIGNATURES but no csrc/*.cu " \
                             "exports it"
    assert [_ctype(a) for a in args] == build.SIGNATURES[name], \
        f"{name}({', '.join(args)})"
