"""The PyTorch port's multi-tenant serving against the JAX package's, on the
CPU.

- kernel H's plain version (``ops/lora_matmul.lora_matmul`` on CPU
  tensors) against the Pallas kernel in interpret mode and the XLA
  fallback, over ``tests/test_tenancy.py``'s shapes, fp32 and bf16 x,
  with null rows exactly 0, and the dispatcher's validation messages;
- H's fused entry (the residual added into the base output in place):
  bit for bit ``base + residual.to(base.dtype)`` in fp32 and bf16, null
  rows untouched, its refusals and messages, never a plain version for a
  tensor on another device than the CPU, and its plan from the shapes
  alone; the seam ``llama.matmul`` over an adapter leaf on a dense and an
  int8 base against JAX's ``matmul`` (fp32, 1e-5);
- the host side: ``AdapterPack`` (capacity, version, null slot,
  ``random_leaves`` bit-equal to JAX's, ``.npz`` leaves), ``Tenant``,
  ``TenantRegistry`` and manifests (same outcomes and messages),
  ``build_tenancy`` against the JAX front end's, and
  ``convert.adapter_pack_from_jax``;
- the model seam: ``bind_adapters`` and ``merge_adapter`` against JAX's;
- the slice: a batch mixing three adapters and a base row gives greedy
  streams token-identical to the JAX adapter engine's and to the port's
  own solo engines fed each tenant's merged tree, on dense and flash
  attends and contiguous and paged layouts; the chunked prefill under an
  adapter; an int8 base with adapters against JAX's int8 adapter engine;
  an engine carrying a pack serving null rows exactly as one without;
  per-tenant radix domains;
- the scheduler: ``_pick``, ``shed_lower_priority``, the tenant loads and
  ``_prefill_gate`` decide as JAX's batcher does on the same queue;
- the config repairs (serving chaos options refused, ``inference.tenancy``
  kept and refused by the generate CLI), ``generate --adapter
  --check-adapter-parity``, and the chip smoke's tenancy traffic, whose
  prefix counters it writes down as constants.

Weights and packs are made once by the JAX package and carried across.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_config
from picotron_tpu.config import Config as JaxConfig
from picotron_tpu.config import TenancyConfig as JaxTenancyConfig
from picotron_tpu.inference import ContinuousBatcher as JaxBatcher
from picotron_tpu.inference import InferenceEngine as JaxEngine
from picotron_tpu.inference import Request as JaxRequest
from picotron_tpu.inference import paged_kv as jax_paged
from picotron_tpu.inference import tenancy as jax_tenancy
from picotron_tpu.inference.batcher import _Slot as JaxSlot
from picotron_tpu.models import llama as jax_llama
from picotron_tpu.ops.pallas import lora_matmul as jax_lm
from picotron_tpu_torch import convert
from picotron_tpu_torch.config import Config
from picotron_tpu_torch.inference import paged_kv, tenancy
from picotron_tpu_torch.inference.batcher import (
    ContinuousBatcher,
    Request,
    _Slot,
)
from picotron_tpu_torch.inference.engine import InferenceEngine
from picotron_tpu_torch.models import llama
from picotron_tpu_torch.ops import lora_matmul as lm
from picotron_tpu_torch.ops.kernels import lora_matmul as kh
from picotron_tpu_torch.ops.quant_matmul import (
    quantize_weight_host as qmm_host,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_LEN = 64
SLOTS = 4
CHUNK = 8
BLOCK = 4
NEW = 8
N_TENANTS = 3
RANK = 4
SCALE = 0.5  # large enough to steer the tiny model's greedy argmax
MODEL = dict(num_hidden_layers=2, num_attention_heads=8,
             num_key_value_heads=4, hidden_size=64, intermediate_size=128,
             vocab_size=256, max_position_embeddings=128,
             rope_theta=10000.0, dtype="float32", attention_impl="sdpa")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Six test workers share the machine: keep torch to one thread here,
    and restore the old count."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _outcome(fn):
    """What ``fn()`` did: ("ok", its result) or (the exception's type
    name, its message), so the two packages' runs compare as values."""
    try:
        return "ok", fn()
    except (ValueError, KeyError) as e:
        return type(e).__name__, str(e)


# --------------------------------------------------------------------------- #
# kernel H: the plain version against Pallas (interpret) and XLA
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,K,N,r", [(4, 1, 32, 48, 8), (3, 5, 64, 40, 4),
                                       (2, 16, 48, 64, 16)])
def test_lora_plain_matches_pallas_and_xla(B, S, K, N, r, dtype):
    rng = np.random.default_rng(0)
    T = 4
    x = rng.normal(size=(B, S, K)).astype(np.float32)
    a = rng.normal(size=(T, K, r)).astype(np.float32)
    b = rng.normal(size=(T, r, N)).astype(np.float32)
    a[0] = 0.0  # slot 0 = the null adapter
    b[0] = 0.0
    ids = np.array([0, 2, 1, 2][:B], np.int32)
    xj = jnp.asarray(x).astype(jnp.dtype(dtype))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = lm.lora_matmul(xt, torch.from_numpy(a), torch.from_numpy(b), ids)
    assert got.dtype == torch.float32 and got.shape == (B, S, N)
    got = got.numpy()
    want_p = np.asarray(jax_lm.lora_matmul(xj, a, b, ids, interpret=True))
    want_x = np.asarray(jax_lm.lora_matmul(xj, a, b, ids, impl="xla"))
    np.testing.assert_allclose(got, want_p, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want_x, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[0], 0.0)  # the null row, exactly
    # ids as a device tensor (the engine's form) give the same rows
    got_t = lm.lora_matmul(xt, torch.from_numpy(a), torch.from_numpy(b),
                           torch.from_numpy(ids))
    np.testing.assert_array_equal(got_t.numpy(), got)


def test_lora_matmul_validation_messages_match_jax():
    cases = [((2, 8), (3, 8, 4), (3, 4, 8)), ((2, 1, 8), (3, 8, 4),
                                               (3, 5, 8)),
             ((2, 1, 8), (3, 8, 4), (2, 4, 8)), ((2, 1, 8), (3, 8), (3, 4))]
    for xs, as_, bs in cases:
        want = _outcome(lambda: jax_lm.lora_matmul(
            jnp.zeros(xs), jnp.zeros(as_), jnp.zeros(bs), [0, 0]))
        got = _outcome(lambda: lm.lora_matmul(
            torch.zeros(xs), torch.zeros(as_), torch.zeros(bs), [0, 0]))
        assert want[0] == "ValueError" and got == want


# --------------------------------------------------------------------------- #
# kernel H's fused entry (the residual added into the base output) and the
# model seam that takes it
# --------------------------------------------------------------------------- #


def _lora_operands(rng, B, S, K, N, r, T=4):
    x = rng.normal(size=(B, S, K)).astype(np.float32)
    a = rng.normal(size=(T, K, r)).astype(np.float32)
    b = rng.normal(size=(T, r, N)).astype(np.float32)
    a[0] = 0.0  # slot 0 = the null adapter
    b[0] = 0.0
    return x, a, b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,K,N,r,ids", [(4, 1, 32, 48, 8, (0, 2, 1, 0)),
                                           (3, 5, 64, 40, 4, (3, 0, 2)),
                                           (1, 16, 48, 64, 16, (1,))])
def test_fused_lora_add_is_base_plus_cast_residual(B, S, K, N, r, ids,
                                                   dtype):
    """The fused entry (on the CPU: its plain version, written into base)
    equals ``base + lora_matmul_plain(...).to(base.dtype)`` bit for bit,
    in fp32 and bf16, returns base itself, and leaves null rows equal to
    the base under ``torch.equal``."""
    rng = np.random.default_rng(B + S)
    x, a, b = _lora_operands(rng, B, S, K, N, r)
    dt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(dt)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    it = torch.tensor(ids, dtype=torch.int32)
    base = torch.from_numpy(rng.normal(size=(B, S, N)).astype(
        np.float32)).to(dt)
    want = base + kh.lora_matmul_plain(xt, at, bt, it).to(dt)
    assert torch.equal(kh.lora_add_plain(base, xt, at, bt, it), want)
    work = base.clone()
    got = lm.lora_matmul_add_(work, xt, at, bt, list(ids))
    assert got is work and got.dtype == dt
    assert torch.equal(got, want)
    null = it == 0
    if bool(null.any()):
        assert torch.equal(got[null], base[null])
    work = base.clone()
    assert torch.equal(kh.segmented_lora_add_(work, xt, at, bt, it), want)


@pytest.mark.parametrize("weights", ["dense", "int8"])
@pytest.mark.parametrize("S", [1, 5])
def test_seam_matmul_over_an_adapter_leaf_matches_jax(weights, S):
    """``llama.matmul`` over an adapter leaf (a dense base, and the int8
    pair of kernel G's plain version) against the JAX ``matmul`` on the
    same numpy inputs, fp32: rtol and atol 1e-5 (the same products
    summed in other orders), null rows equal to the base product alone."""
    rng = np.random.default_rng(7 + S)
    B, K, N, r = 3, 64, 48, 4
    x, a, b = _lora_operands(rng, B, S, K, N, r)
    ids = np.array([2, 0, 3], np.int32)
    w = (rng.normal(size=(K, N)) * 0.1).astype(np.float32)
    if weights == "int8":
        qw = qmm_host(w)
        base_w, jbase_w = ({k: torch.from_numpy(v) for k, v in qw.items()},
                           {k: jnp.asarray(v) for k, v in qw.items()})
    else:
        base_w, jbase_w = torch.from_numpy(w), jnp.asarray(w)
    leaf = {"w": base_w, "a": torch.from_numpy(a), "b": torch.from_numpy(b),
            "ids": torch.from_numpy(ids)}
    jleaf = {"w": jbase_w, "a": jnp.asarray(a), "b": jnp.asarray(b),
             "ids": jnp.asarray(ids)}
    got = llama.matmul(torch.from_numpy(x), leaf)
    want = np.asarray(jax_llama.matmul(jnp.asarray(x), jleaf))
    assert got.shape == (B, S, N) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    base = llama.matmul(torch.from_numpy(x), base_w)
    assert torch.equal(got[1], base[1])


def test_fused_lora_add_refuses_a_bad_base():
    """The fused entry's own messages: a base of another shape than
    [B, S, N], of a dtype other than bf16 and fp32, or on another device
    than x; x, a, b and ids keep the residual entry's checks."""
    x, a, b = (torch.zeros(2, 3, 8), torch.zeros(4, 8, 2),
               torch.zeros(4, 2, 6))
    ids = torch.zeros(2, dtype=torch.int32)
    cases = [
        (torch.zeros(2, 3, 5), "lora_matmul base (2, 3, 5) is not the "
                               "[B, S, N] (2, 3, 6) of x and b"),
        (torch.zeros(2, 3, 6, dtype=torch.int32),
         "lora_matmul base must be bf16 or fp32; got torch.int32"),
        (torch.zeros(2, 3, 6, dtype=torch.float16),
         "lora_matmul base must be bf16 or fp32; got torch.float16"),
        (torch.zeros(2, 3, 6, device="meta"),
         "lora_matmul base lies on meta, x on cpu"),
    ]
    for base, msg in cases:
        with pytest.raises(ValueError) as e:
            kh.segmented_lora_add_(base, x, a, b, ids)
        assert str(e.value) == msg
    with pytest.raises(ValueError, match="lora_matmul shapes"):
        kh.segmented_lora_add_(torch.zeros(2, 3, 6), x, a[:, :4], b, ids)
    want = _outcome(lambda: lm.lora_matmul(torch.zeros(2, 8), a, b, [0, 0]))
    assert want[0] == "ValueError"
    assert _outcome(lambda: lm.lora_matmul_add_(
        torch.zeros(2, 3, 6), torch.zeros(2, 8), a, b, [0, 0])) == want


class _CudaLooking(torch.Tensor):
    """A CPU tensor that reports a CUDA device: it takes a wrapper's CUDA
    path on a machine without a card, up to the kernel library."""

    @property
    def device(self):
        return torch.device("cuda", 0)

    @property
    def is_cuda(self):
        return True


def test_lora_entries_launch_or_raise_and_never_fall_back(monkeypatch):
    """A tensor that is not on the CPU launches kernel H or raises: with
    the library unavailable both entries raise, neither plain version is
    called and no launch is counted. On the CUDA path the fused entry
    also refuses a base of another dtype than x or a strided one."""
    def boom(*args, **kwargs):
        raise AssertionError("plain version called for a CUDA tensor")

    def no_library():
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(kh, "lora_matmul_plain", boom)
    monkeypatch.setattr(kh, "lora_add_plain", boom)
    monkeypatch.setattr(kh.build, "library", no_library)

    def cuda(t):
        return t.as_subclass(_CudaLooking)

    x = cuda(torch.zeros(2, 1, 8, dtype=torch.bfloat16))
    a, b = cuda(torch.zeros(4, 8, 2)), cuda(torch.zeros(4, 2, 6))
    ids = cuda(torch.zeros(2, dtype=torch.int32))
    before = kh.KERNEL.launches
    # the residual entry allocates its output on the device first, which
    # a torch without CUDA refuses; either way it raises
    with pytest.raises((RuntimeError, AssertionError)) as e:
        kh.segmented_lora(x, a, b, ids)
    assert "plain version" not in str(e.value)
    with pytest.raises(RuntimeError, match="kernel library unavailable"):
        kh.segmented_lora_add_(cuda(torch.zeros(2, 1, 6,
                                                dtype=torch.bfloat16)),
                               x, a, b, ids)
    with pytest.raises(ValueError) as e:
        kh.segmented_lora_add_(cuda(torch.zeros(2, 1, 6)), x, a, b, ids)
    assert str(e.value) == ("lora_matmul kernel adds into a contiguous base "
                            "of x's dtype torch.bfloat16; got torch.float32")
    strided = cuda(torch.zeros(2, 1, 12, dtype=torch.bfloat16)[..., ::2])
    with pytest.raises(ValueError) as e:
        kh.segmented_lora_add_(strided, x, a, b, ids)
    assert str(e.value).endswith("got torch.bfloat16, strided")
    assert kh.KERNEL.launches == before


def test_lora_plan_is_a_function_of_the_shapes():
    """H's plan gives a variant, a row tile and a split count (the blocks
    of one cluster: 8 at decode, 4 at a 512-row chunk, whose 32 row tiles
    fill the card with 4 each) for every shape the chip smoke times and the
    ragged ones, from the shapes alone: the same answer for the same
    shapes, whatever the call before it."""
    cs = _chip_smoke()
    shapes = ([(8, 1, K, N) for K, N in cs.H_SMOL_SHAPES + cs.H_7B_SHAPES]
              + [(1, 512, K, N) for K, N in cs.H_SMOL_SHAPES]
              + [(3, 37, 1000, 1500), (4, 1, 32, 48), (3, 5, 64, 40),
                 (2, 16, 48, 64)])
    for B, S, K, N in shapes:
        p = kh.plan(B, S, K, N, cs.H_RANK)
        assert p == kh.plan(B, S, K, N, cs.H_RANK)
        assert p["variant"] == ("decode" if S == 1 else "rows16")
        assert p["rows"] == (1 if S == 1 else 16)
        assert p["cluster"] in (1, 2, 4, 8)
        if max(K, N) >= 2048:
            assert p["cluster"] == (4 if S == 512 else kh.MAX_CLUSTER)
    assert kh.plan(3, 37, 1000, 1500, 16)["cluster"] == 4
    assert kh.plan(4, 1, 32, 48, 8)["cluster"] == 1


# --------------------------------------------------------------------------- #
# the host side: AdapterPack, Tenant, TenantRegistry, build_tenancy
# --------------------------------------------------------------------------- #


def _cfgs(**tenancy_section):
    """(JAX config, port config) of the tiny model with the same
    ``inference.tenancy`` section."""
    jcfg = make_config(MODEL, seq=MAX_LEN)
    jcfg.inference.tenancy = JaxTenancyConfig(**tenancy_section)
    return jcfg, Config.from_dict({"model": MODEL, "inference": {
        "tenancy": tenancy_section}})


def test_adapter_pack_matches_jax(tmp_path):
    jcfg, cfg = _cfgs()
    jp = jax_tenancy.AdapterPack(jcfg.model, slots=4, rank=8)
    pp = tenancy.AdapterPack(cfg.model, slots=4, rank=8)
    assert (pp.slots, pp.rank, pp.rows, pp.dims) == (
        jp.slots, jp.rank, jp.rows, jp.dims)
    assert pp.bytes_per_token() == jp.bytes_per_token()
    d0 = pp.device_leaves()
    assert pp.device_leaves() is d0  # cached until a mutation
    # seed-derived leaves: the same numpy draws, bit for bit
    jl, pl = jp.random_leaves(4, seed=1), pp.random_leaves(4, seed=1)
    assert list(pl) == list(jl)
    for name in jl:
        for want, got in zip(jl[name], pl[name]):
            np.testing.assert_array_equal(got, want)
    jp.set_slot(1, jl)
    pp.set_slot(1, pl)
    assert pp.version == jp.version == 1
    d1 = pp.device_leaves()
    assert d1 is not d0
    for name, side in ((n, s) for n in pl for s in ("a", "b")):
        want = np.asarray(jp.device_leaves()[name][side])
        got = d1[name][side]
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    a = d1["wq"]["a"].numpy()
    np.testing.assert_array_equal(a[:, 1, :, 4:], 0.0)  # rank 4 of 8
    np.testing.assert_array_equal(a[:, 0], 0.0)  # the null slot
    # the device copy is not a view of the host master
    pp.clear_slot(1)
    assert np.any(a[:, 1, :, :4])
    np.testing.assert_array_equal(pp.device_leaves()["wq"]["a"][:, 1], 0.0)
    # .npz leaves from an archive written here
    good = tmp_path / "adapter.npz"
    np.savez(good, **{"wq.a": pl["wq"][0], "wq.b": pl["wq"][1],
                      "w_down.a": pl["w_down"][0],
                      "w_down.b": pl["w_down"][1]})
    empty = tmp_path / "empty.npz"
    np.savez(empty, other=np.zeros(3))
    for path in (good, empty):
        want = _outcome(lambda: jp.npz_leaves(str(path)))
        got = _outcome(lambda: pp.npz_leaves(str(path)))
        assert got[0] == want[0]
        if got[0] == "ok":
            assert sorted(got[1]) == sorted(want[1]) == ["w_down", "wq"]
            for name in got[1]:
                for g, w in zip(got[1][name], want[1][name]):
                    np.testing.assert_array_equal(g, w)
        else:
            assert got[1] == want[1]
    # the same refusals, word for word
    too_wide = {"wq": (np.zeros((2, 64, 9)), np.zeros((2, 9, 64)))}
    for fn in (lambda mod, p, m: p.set_slot(0, {}),
               lambda mod, p, m: p.random_leaves(9, seed=0),
               lambda mod, p, m: p.set_slot(4, {}),
               lambda mod, p, m: p.set_slot(1, too_wide),
               lambda mod, p, m: mod.AdapterPack(m, slots=1),
               lambda mod, p, m: mod.AdapterPack(m, rank=0)):
        want = _outcome(lambda: fn(jax_tenancy, jp, jcfg.model))
        assert want[0] == "ValueError"
        assert _outcome(lambda: fn(tenancy, pp, cfg.model)) == want


def _registry_script(mod, m, tmp_path):
    """One sequence through ``mod``'s Tenant and TenantRegistry; every
    outcome in order."""
    out = []
    for d in ({"name": "a/b"}, {"name": ""}, {"name": "x", "priority": -1},
              {"name": "x", "adapter_rank": -1}, {"name": "x",
                                                  "max_pages": 0},
              {"name": "x", "ttft_slo_ms": 0.0},
              {"name": "x", "color": "red"}):
        out.append(_outcome(lambda: mod.Tenant.from_dict(d).to_dict()))
    pack = mod.AdapterPack(m, slots=3, rank=4)
    reg = mod.TenantRegistry(pack)

    def res(name):
        t, slot = reg.resolve(name)
        return t.name, t.priority, slot

    out += [_outcome(lambda: res(None)), _outcome(lambda: res("")),
            _outcome(lambda: res("nope"))]
    for t in (mod.Tenant(name="acme", adapter_rank=2, priority=2),
              mod.Tenant(name="bulk", priority=0), mod.Tenant(name="acme"),
              mod.Tenant(name="beta", adapter_rank=4),
              mod.Tenant(name="gamma", adapter_rank=1)):
        out.append(_outcome(lambda: reg.add(t)))
    out.append(_outcome(lambda: reg.remove("beta")))
    out.append(np.asarray(pack.device_leaves()["wq"]["a"][:, 2]).any())
    out.append(_outcome(lambda: reg.add(mod.Tenant(name="gamma",
                                                   adapter_rank=1))))
    out += [_outcome(lambda: reg.remove("never-was")), reg.names(),
            reg.snapshot(), _outcome(lambda: res("acme"))]
    out.append(_outcome(lambda: mod.TenantRegistry(None).add(
        mod.Tenant(name="x", adapter_rank=2))))
    mf = tmp_path / "tenants.json"
    mf.write_text(json.dumps({"tenants": [
        {"name": "base", "priority": 0, "max_tokens": 7},
        {"name": "acme", "priority": 2, "adapter_rank": 2,
         "adapter_seed": 7, "ttft_slo_ms": 300.0}]}))
    reg2 = mod.TenantRegistry.from_manifest(
        str(mf), mod.AdapterPack(m, slots=3, rank=4))
    t, slot = reg2.resolve(None)
    out.append((t.max_tokens, slot, reg2.resolve("acme")[0].ttft_slo_ms))
    out.append(np.asarray(reg2.pack.device_leaves()["w_up"]["b"]))
    bad = tmp_path / "bad.json"
    bad.write_text("[]")
    out.append(_outcome(lambda: mod.TenantRegistry.from_manifest(str(bad))))
    return out


def test_tenant_registry_and_manifest_match_jax(tmp_path):
    jcfg, cfg = _cfgs()
    want = _registry_script(jax_tenancy, jcfg.model, tmp_path)
    got = _registry_script(tenancy, cfg.model, tmp_path)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w
    assert got[7] == ("ok", ("base", 1, 0))  # the implicit base tenant


def test_build_tenancy_matches_jax_and_packs_carry_across(tmp_path):
    from picotron_tpu.tools.serve import _build_tenancy

    class Args:
        tenant_manifest = ""

    assert tenancy.build_tenancy(
        Config.from_dict({"model": MODEL})) == (None, None)
    mf = tmp_path / "fleet.json"
    mf.write_text(json.dumps({"tenants": [{"name": "fleet",
                                           "adapter_rank": 3,
                                           "adapter_seed": 9}]}))
    tdict = dict(tenants=[{"name": "acme", "adapter_rank": 4,
                           "adapter_seed": 1, "priority": 2},
                          {"name": "bulk", "priority": 0}],
                 manifest=str(mf), adapter_slots=4, adapter_rank=4)
    jcfg, cfg = _cfgs(**tdict)
    assert cfg.inference.tenancy.adapter_slots == 4
    jpack, jreg = _build_tenancy(jcfg, Args())
    pack, reg = tenancy.build_tenancy(cfg)
    assert reg.snapshot() == jreg.snapshot()
    assert (pack.slots, pack.rank, pack.version) == (
        jpack.slots, jpack.rank, jpack.version)
    carried = convert.adapter_pack_from_jax(jpack._host)
    for name in pack.dims:
        for side in (0, 1):
            np.testing.assert_array_equal(pack._host[name][side],
                                          jpack._host[name][side])
            np.testing.assert_array_equal(carried._host[name][side],
                                          jpack._host[name][side])
    assert (carried.slots, carried.rank, carried.rows, carried.dims) == (
        pack.slots, pack.rank, pack.rows, pack.dims)
    # a manifest path given to build_tenancy overrides the config's
    other = tmp_path / "other.json"
    other.write_text(json.dumps({"tenants": [{"name": "solo"}]}))
    _, reg2 = tenancy.build_tenancy(cfg, manifest=str(other))
    assert reg2.names() == ["acme", "bulk", "solo"]


# --------------------------------------------------------------------------- #
# the model seam: bind_adapters, merge_adapter
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def tiny():
    """(JAX config, JAX params, port params, JAX pack, port pack, the
    adapters' leaves by slot) for the tiny model."""
    jcfg = make_config(MODEL, seq=MAX_LEN)
    jparams = jax.jit(lambda k: jax_llama.init_params(k, jcfg.model))(
        jax.random.PRNGKey(0))
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams))
    jpack = jax_tenancy.AdapterPack(jcfg.model, slots=N_TENANTS + 1,
                                    rank=RANK)
    leaves = {}
    for t in range(1, N_TENANTS + 1):
        leaves[t] = jpack.random_leaves(RANK, seed=t, scale=SCALE)
        jpack.set_slot(t, leaves[t])
    pack = convert.adapter_pack_from_jax(jpack._host)
    return jcfg, jparams, params, jpack, pack, leaves


def test_bind_and_merge_adapter_match_jax(tiny):
    jcfg, jparams, params, jpack, pack, leaves = tiny
    ids = np.array([2, 0, 3], np.int32)
    bound = llama.bind_adapters(params, pack.device_leaves(),
                                torch.from_numpy(ids))
    jbound = jax_llama.bind_adapters(jparams, jpack.device_leaves(), ids)
    for name in llama.QUANT_WEIGHT_LEAVES:
        leaf, jleaf = bound["layers"][name], jbound["layers"][name]
        assert lm.is_lora_weight(leaf)
        for key in ("a", "b", "ids"):
            np.testing.assert_array_equal(leaf[key].numpy(),
                                          np.asarray(jleaf[key]))
    lp = llama.layer_params(bound, 1)
    assert lp["wq"]["ids"].tolist() == ids.tolist()
    assert lp["wq"]["a"].shape == (N_TENANTS + 1, 64, RANK)
    np.testing.assert_array_equal(lp["wq"]["w"].numpy(),
                                  params["layers"]["wq"][1].numpy())
    want = _outcome(lambda: jax_llama.bind_adapters(
        jbound, jpack.device_leaves(), ids))
    assert want[0] == "ValueError"
    assert _outcome(lambda: llama.bind_adapters(
        bound, pack.device_leaves(), torch.from_numpy(ids))) == want
    # an int8 base binds under its pair and slices both of its tensors
    qbound = llama.bind_adapters(llama.quantize_params(params),
                                 pack.device_leaves(), torch.from_numpy(ids))
    qlp = llama.layer_params(qbound, 0)["w_up"]
    assert set(qlp["w"]) == {"q", "s"} and qlp["w"]["q"].dim() == 2
    # the merged reference tree
    merged = llama.merge_adapter(params, leaves[2])
    jmerged = jax_llama.merge_adapter(jparams, leaves[2])
    for name in llama.QUANT_WEIGHT_LEAVES:
        np.testing.assert_allclose(merged["layers"][name].numpy(),
                                   np.asarray(jmerged["layers"][name]),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(merged["embed"].numpy(),
                                  params["embed"].numpy())
    want = _outcome(lambda: jax_llama.merge_adapter(
        jax_llama.quantize_params(jparams), leaves[2]))
    assert want[0] == "ValueError"
    assert _outcome(lambda: llama.merge_adapter(
        llama.quantize_params(params), leaves[2])) == want


# --------------------------------------------------------------------------- #
# the slice: engine + batcher against the JAX adapter engine
# --------------------------------------------------------------------------- #


def _prompts():
    return {slot: [(7 * slot + 3 * i) % 199 + 1 for i in range(12)]
            for slot in range(N_TENANTS + 1)}


def _requests(mod_request, prompts, **kw):
    return [mod_request(uid=f"t{slot}", prompt=list(p), max_new_tokens=NEW,
                        adapter_slot=slot,
                        tenant=f"tenant{slot}" if slot else "", **kw)
            for slot, p in prompts.items()]


def _port_engine(pack=None, weight_dtype="bf16", slots=SLOTS, **inf):
    cfg = Config.from_dict({"model": MODEL, "inference": {
        "prefill_chunk": CHUNK, "decode_block_len": BLOCK,
        "kv_page_len": 8, **inf}})
    return InferenceEngine(cfg, "cpu", slots=slots, max_seq_len=MAX_LEN,
                           weight_dtype=weight_dtype, adapters=pack)


@pytest.fixture(scope="module")
def jax_mixed(tiny):
    """The JAX adapter engine's greedy streams on the mixed batch, per
    KV layout and base weights ("dense" attend: the jitted reference)."""
    jcfg, jparams, _, jpack, _, _ = tiny
    out = {}
    for layout, wd in (("contiguous", "bf16"), ("paged", "bf16"),
                       ("contiguous", "int8")):
        eng = JaxEngine(jcfg, adapters=jpack, slots=SLOTS,
                        max_seq_len=MAX_LEN, prefill_chunk=CHUNK,
                        decode_block_len=BLOCK, attend_impl="dense",
                        kv_layout=layout, kv_page_len=8, weight_dtype=wd)
        tree = (jax_llama.quantize_params(jparams) if wd == "int8"
                else jparams)
        res = JaxBatcher(eng, eng.shard_params(tree)).run(
            _requests(JaxRequest, _prompts()))
        out[layout, wd] = {u: r.tokens for u, r in res.items()}
    return out


@pytest.mark.parametrize("attend", ["dense", "flash"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_mixed_batch_matches_jax_and_merged_refs(tiny, jax_mixed, layout,
                                                 attend):
    """Three adapters and a base row in one continuous batch: the greedy
    streams equal the JAX adapter engine's, and each row's equals a solo
    pack-less engine's fed that tenant's merged tree. "flash" runs C's
    plain versions, as a CPU tensor does."""
    _, _, params, _, pack, leaves = tiny
    prompts = _prompts()
    eng = _port_engine(pack, kv_layout=layout, attend_impl=attend)
    res = ContinuousBatcher(eng, params).run(_requests(Request, prompts))
    got = {u: r.tokens for u, r in res.items()}
    assert got == jax_mixed[layout, "bf16"]
    ref_eng = _port_engine(kv_layout=layout, attend_impl=attend)
    for slot, p in prompts.items():
        tree = (params if slot == 0
                else llama.merge_adapter(params, leaves[slot]))
        ref = ContinuousBatcher(ref_eng, tree).run(
            [Request("solo", list(p), max_new_tokens=NEW)])
        assert got[f"t{slot}"] == ref["solo"].tokens, slot
    # the adapters bite: tenants leave the base row's stream
    assert any(got[f"t{t}"] != got["t0"] for t in range(1, N_TENANTS + 1))
    if layout == "paged":
        # each tenant's prompt registered under its own salt, never the
        # anonymous domain
        radix = eng.paged.radix
        for slot in range(1, N_TENANTS + 1):
            assert radix.match(prompts[slot], salt=f"tenant{slot}")[1] > 0
            assert radix.match(prompts[slot], salt="")[1] == 0


def test_chunked_prefill_adapter_matches_jax_and_merged(tiny):
    """The chunked prefill under adapter 2: its last-token logits agree
    with the one-shot prefill's, with JAX's chunked prefill and with a
    pack-less engine's over the merged tree (1e-4)."""
    jcfg, jparams, params, jpack, pack, leaves = tiny
    prompt = [(5 * i + 2) % 199 + 1 for i in range(20)]
    eng = _port_engine(pack, slots=2)
    _, last = eng.prefill_chunked(params, eng.init_cache(), prompt, slot=1,
                                  adapter_id=2)
    oneshot = eng.prefill(params, prompt, adapter_id=2)[1]
    np.testing.assert_allclose(last.numpy(), oneshot.numpy(), rtol=1e-4,
                               atol=1e-4)
    jeng = JaxEngine(jcfg, adapters=jpack, slots=2, max_seq_len=MAX_LEN,
                     prefill_chunk=CHUNK)
    _, jlast = jeng.prefill_chunked(jeng.shard_params(jparams),
                                    jeng.init_cache(), prompt, slot=1,
                                    adapter_id=2)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), rtol=1e-4,
                               atol=1e-4)
    ref_eng = _port_engine(slots=2)
    _, ref = ref_eng.prefill_chunked(llama.merge_adapter(params, leaves[2]),
                                     ref_eng.init_cache(), prompt, slot=1)
    np.testing.assert_allclose(last.numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-4)
    assert int(last.argmax()) == int(ref.argmax())


def test_int8_base_with_adapters_matches_jax(tiny, jax_mixed):
    """Adapters over int8 weights (kernel G's plain version under each
    residual): streams equal JAX's int8 adapter engine's and each row's
    equals a pack-less engine's over fake-quant(W) + A @ B."""
    _, _, params, _, pack, leaves = tiny
    qp = llama.quantize_params(params)
    prompts = _prompts()
    res = ContinuousBatcher(_port_engine(pack, weight_dtype="int8"),
                            qp).run(_requests(Request, prompts))
    got = {u: r.tokens for u, r in res.items()}
    assert got == jax_mixed["contiguous", "int8"]
    fq = llama.dequantize_params(qp, torch.float32)
    ref_eng = _port_engine()
    for slot, p in prompts.items():
        tree = fq if slot == 0 else llama.merge_adapter(fq, leaves[slot])
        ref = ContinuousBatcher(ref_eng, tree).run(
            [Request("solo", list(p), max_new_tokens=NEW)])
        assert got[f"t{slot}"] == ref["solo"].tokens, slot


def test_null_pack_engine_identical_to_packless(tiny):
    """An engine carrying live adapters but serving null rows gives the
    logits and tokens of an engine without a pack, bit for bit; ids on
    an engine without a pack, or outside the pack, are refused with the
    JAX package's messages."""
    jcfg, jparams, params, _, pack, _ = tiny
    prompt = list(range(1, 9))
    outs = []
    for adapters in (pack, None):
        for layout in ("contiguous", "paged"):
            eng = _port_engine(adapters, slots=2, kv_layout=layout)
            _, logits = eng.prefill(params, prompt)
            res = ContinuousBatcher(eng, params).run(
                [Request("r", list(prompt), max_new_tokens=NEW)])
            outs.append((logits.numpy(), res["r"].tokens))
    for logits, tokens in outs[1:]:
        np.testing.assert_array_equal(logits, outs[0][0])
        assert tokens == outs[0][1]
    jeng = JaxEngine(jcfg, slots=2, max_seq_len=MAX_LEN)
    for ids, n in (([1, 0], 2),):
        want = _outcome(lambda: jeng.bind_adapter_ids(jparams, ids, n))
        assert want[0] == "ValueError"
        assert _outcome(lambda: _port_engine(slots=2).bind_adapter_ids(
            params, ids, n)) == want
    jeng = JaxEngine(jcfg, slots=2, max_seq_len=MAX_LEN,
                     adapters=tiny[3])
    eng = _port_engine(pack, slots=2)
    for ids, n in (([1, 9], 2), ([1], 2), ([-1, 0], 2)):
        want = _outcome(lambda: jeng.bind_adapter_ids(jparams, ids, n))
        assert want[0] == "ValueError"
        assert _outcome(lambda: eng.bind_adapter_ids(params, ids, n)) == want
    # a pack for another model shape or depth is refused at construction
    other = Config.from_dict({"model": {**MODEL, "num_hidden_layers": 3}})
    with pytest.raises(ValueError, match="layer rows"):
        _port_engine(tenancy.AdapterPack(other.model, slots=2, rank=2))
    wide = Config.from_dict({"model": {**MODEL, "intermediate_size": 64}})
    with pytest.raises(ValueError, match="model-shape specific"):
        _port_engine(tenancy.AdapterPack(wide.model, slots=2, rank=2))


def test_radix_salt_isolation_matches_jax(tiny):
    """Identical chunks under different salts take their own nodes and
    pages in both packages; in the batcher, a tenant's repeated prompt
    hits only its own domain."""
    def script(mod):
        pool = mod.PagePool(num_pages=16)
        r = mod.RadixCache(page_len=4, pool=pool)
        ids = list(range(1, 13))
        pa = [pool.alloc() for _ in range(3)]
        out = [r.insert(ids, lambda i: pa[i], salt="acme"),
               r.match(ids, salt="acme"), r.match(ids, salt=""),
               r.match(ids, salt="bulk")]
        pb = [pool.alloc() for _ in range(3)]
        out += [r.insert(ids, lambda i: pb[i], salt="bulk"),
                r.match(ids, salt="bulk"), r.match(ids, salt="acme"),
                sorted(set(pa) & set(pb))]
        return out

    assert script(paged_kv) == script(jax_paged)
    _, _, params, _, pack, _ = tiny
    p = [(3 * i) % 97 + 1 for i in range(20)]
    b = ContinuousBatcher(_port_engine(pack, kv_layout="paged"), params)
    b.run([Request("a", p, max_new_tokens=2, tenant="acme", adapter_slot=1),
           Request("b", p, max_new_tokens=2, tenant="bulk", adapter_slot=2)])
    assert b.stats()["prefix_hits"] == 0
    b.run([Request("c", p, max_new_tokens=2, tenant="acme",
                   adapter_slot=1)])
    assert b.stats()["prefix_hits"] == 1


# --------------------------------------------------------------------------- #
# the scheduler: priorities, shedding, tenant loads, the prefill gate
# --------------------------------------------------------------------------- #


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _scheduler_script(batcher, req_cls, slot_cls, clock):
    """One scripted queue through a bare batcher (no dispatch); every
    decision in order."""
    b = batcher
    out = []
    for r in (req_cls("lo", [1], priority=0),
              req_cls("a", [1], priority=1),
              req_cls("b", [1], priority=1),
              req_cls("hi", [1], priority=2),
              req_cls("slo", [1], priority=1, ttft_slo_ms=100.0)):
        b._pending.append(r)
    while b._pending:
        j = b._pick()
        out.append(b._pending[j].uid)
        del b._pending[j]
    reqs = [req_cls("lo1", [1, 2], max_new_tokens=10, priority=0,
                    tenant="bulk"),
            req_cls("lo2", [1, 2], max_new_tokens=10, priority=0,
                    tenant="bulk"),
            req_cls("mid", [1, 2], max_new_tokens=10, priority=1,
                    tenant="acme")]
    for r in reqs:
        b._pending.append(r)
        b._submit_t[r.uid] = clock()
    per = b.commitment(reqs[0])
    out.append(b.shed_lower_priority(2, tokens=per))
    out.append([r.uid for r in b._pending])
    out.append(b.shed_lower_priority(1, tokens=10 * per))
    out.append(sorted((u, r.finish_reason) for u, r in
                      b.take_results().items()))
    b._pending.append(req_cls("t1", [1, 2, 3], max_new_tokens=10,
                              tenant="acme"))
    b._slots[0] = slot_cls(req_cls("live", [4, 5], max_new_tokens=6,
                                   tenant="acme"))
    out.append((b.tenant_token_load("acme"), b.tenant_token_load("bulk"),
                b.tenant_page_load("acme")))
    # the prefill gate: nothing admitted yet, no TPOT slot, then a live
    # TPOT-SLO slot with a round budget spent
    long = req_cls("long", list(range(1, 12)), tenant="acme")
    slo = req_cls("slo2", list(range(1, 12)), tenant="acme",
                  ttft_slo_ms=100.0)
    b._submit_t["slo2"] = clock()
    b._round_prefill_tokens = 0
    out.append(b._prefill_gate(long))
    b._round_prefill_tokens = 5
    out.append(b._prefill_gate(long))
    b._slots[1] = slot_cls(req_cls("tpot", [1], tenant="bulk",
                                   tpot_slo_ms=20.0))
    out.append(b._prefill_gate(req_cls("short", [1, 2], tenant="bulk")))
    out.append(b._prefill_gate(long))
    out.append(b._prefill_gate(slo))  # 0 ms of its 100 ms spent
    clock.t += 0.06  # 60 ms: past half its TTFT budget
    out.append(b._prefill_gate(slo))
    out.append({name: {k: st[k] for k in ("shed", "prefill_deferred",
                                          "prefill_preempts")}
                for name, st in b._tenant_stats.items()})
    return out


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_scheduling_decisions_match_jax(layout):
    jcfg = make_config(MODEL, seq=MAX_LEN)
    jclock, clock = _Clock(), _Clock()
    jeng = JaxEngine(jcfg, slots=2, max_seq_len=MAX_LEN, prefill_chunk=CHUNK,
                     kv_layout=layout, kv_page_len=8)
    want = _scheduler_script(JaxBatcher(jeng, params=None, clock=jclock),
                             JaxRequest, JaxSlot, jclock)
    eng = _port_engine(slots=2, kv_layout=layout)
    got = _scheduler_script(ContinuousBatcher(eng, params=None, clock=clock),
                            Request, _Slot, clock)
    assert got == want
    assert got[:5] == ["hi", "slo", "a", "b", "lo"]
    assert got[-7:-1] == [True, True, True, False, False, True]


def test_admission_seats_higher_classes_first(tiny):
    """A priority-0 request submitted first waits while higher classes
    take the slots; the tally counts each tenant's requests and
    tokens."""
    _, _, params, _, pack, _ = tiny
    b = ContinuousBatcher(_port_engine(pack, slots=2), params)
    for first, (uid, tenant, prio, slot) in enumerate(
            (("low", "bulk", 0, 3), ("x", "acme", 2, 1), ("y", "", 1, 0))):
        b.submit(Request(uid, [first + 1, 2, 3], max_new_tokens=12,
                         tenant=tenant, priority=prio, adapter_slot=slot))
    b.step()
    assert sorted(s.req.uid for s in b._slots if s is not None) == ["x", "y"]
    assert list(b._adapter) == [1, 0]
    while b.busy:
        b.step()
    assert list(b._adapter) == [0, 0]  # zeroed on release
    tenants = b.stats()["tenants"]
    assert {n: (t["requests"], t["tokens"]) for n, t in tenants.items()} \
        == {"acme": (1, 12), "base": (1, 12), "bulk": (1, 12)}


# --------------------------------------------------------------------------- #
# the config repairs, the CLI, the chip smoke's traffic
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name,value", [
    ("chaos_dispatch_raise_round", 3), ("chaos_dispatch_fail_slot", 0),
    ("chaos_latency_round", 2), ("chaos_poison_logits_round", 1)])
def test_serving_chaos_options_are_refused(name, value):
    """The serving chaos options, once refused at load, load now: the JAX
    value builds a ``ServingChaos`` that is active, with the JAX hook's
    attribute; the option's "off" value builds an inactive one."""
    from picotron_tpu.resilience.chaos import ServingChaos as JaxChaos
    from picotron_tpu_torch.resilience.chaos import ServingChaos

    attr = {"chaos_dispatch_raise_round": "dispatch_raise_round",
            "chaos_dispatch_fail_slot": "fail_slot",
            "chaos_latency_round": "latency_round",
            "chaos_poison_logits_round": "poison_round"}[name]
    raw = {"resilience": {name: value}}
    theirs = JaxChaos(JaxConfig.from_dict(raw).resilience)
    ours = ServingChaos(Config.from_dict(raw).resilience)
    assert ours.active and theirs.active
    assert getattr(ours, attr) == getattr(theirs, attr) == value
    off = {"chaos_dispatch_fail_slot": -1}.get(name, 0)
    r = Config.from_dict({"resilience": {name: off,
                                         "chaos_latency_s": 0.5}}).resilience
    assert not ServingChaos(r).active and r.chaos_latency_s == 0.5


def _tiny_config_file(tmp_path, **inference) -> str:
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps({
        "model": {"num_hidden_layers": 2, "num_attention_heads": 4,
                  "num_key_value_heads": 2, "hidden_size": 32,
                  "intermediate_size": 64, "vocab_size": 64,
                  "max_position_embeddings": 64, "dtype": "float32"},
        "inference": {"attend_impl": "flash", "prefill_chunk": 8,
                      **inference},
        "training": {"seq_length": 64}}))
    return str(path)


def test_tenancy_section_is_kept_and_refused_by_generate(tmp_path, capsys):
    from picotron_tpu_torch.tools import generate

    raw = {"inference": {"tenancy": {
        "tenants": [{"name": "acme", "adapter_rank": 8}],
        "adapter_slots": 4, "unknown": 1}}}
    got = Config.from_dict(raw).inference.tenancy
    want = JaxConfig.from_dict(raw).inference.tenancy
    assert (got.tenants, got.manifest, got.adapter_slots,
            got.adapter_rank) == (want.tenants, want.manifest,
                                  want.adapter_slots, want.adapter_rank)
    assert Config.from_dict(Config.from_dict(raw).to_dict()).inference \
        .tenancy == got
    for tenancy_raw in ({"tenants": [{"name": "acme"}]},
                        {"manifest": "fleet.json"}):
        path = _tiny_config_file(tmp_path, tenancy=tenancy_raw)
        with pytest.raises(SystemExit):
            generate.main(["--config", path, "--random-init",
                           "--prompt-ids", "1,2"], device="cpu")
        assert ("served by the HTTP server: python -m "
                "picotron_tpu_torch.tools.serve") in capsys.readouterr().err


@pytest.mark.parametrize("weights", ["bf16", "int8"])
def test_generate_adapter_parity_on_the_cpu(tmp_path, capsys, weights):
    from picotron_tpu_torch.tools import generate

    path = _tiny_config_file(tmp_path, kv_page_len=8)
    rc = generate.main(["--config", path, "--random-init", "--prompt-ids",
                        "1,2,3,4,5,6,7,8,9,10", "--prompt-ids", "7,8",
                        "--max-new-tokens", "6", "--slots", "2",
                        "--weight-dtype", weights, "--adapter", "4:1",
                        "--check-adapter-parity"], device="cpu")
    out = capsys.readouterr().out
    assert rc == 0, out
    assert (f"adapter parity: segmented adapter == merged-weight "
            f"reference for 2 requests (rank=4, weights={weights})") in out


@pytest.mark.parametrize("extra,message", [
    (["--adapter", "x:1"], "bad --adapter spec 'x:1' (want "
                           "RANK[:SEED[:SCALE]])"),
    (["--adapter", "0"], "--adapter rank must be >= 1"),
    (["--check-adapter-parity"], "--check-adapter-parity compares the "
                                 "segmented adapter dispatch"),
    (["--adapter", "4", "--check-adapter-parity", "--temperature", "0.5"],
     "--check-adapter-parity is a greedy-only gate"),
    (["--adapter", "4", "--weight-dtype", "int8", "--check-weight-parity"],
     "--check-weight-parity's reference engine is adapter-less"),
])
def test_generate_adapter_errors_match_jax(tmp_path, capsys, extra,
                                           message):
    from picotron_tpu.tools import generate as jax_generate
    from picotron_tpu_torch.tools import generate

    path = _tiny_config_file(tmp_path)
    argv = ["--config", path, "--random-init", "--prompt-ids", "1,2", *extra]
    errs = []
    for main in (jax_generate.main,
                 lambda a: generate.main(a, device="cpu")):
        with pytest.raises(SystemExit):
            main(argv)
        errs.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert message in errs[0]
    assert errs[1].split("error: ", 1)[1] == errs[0].split("error: ", 1)[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_tenant_traffic_counters_on_the_cpu():
    """The chip smoke's tenancy traffic, at its real lengths and layout
    (8 slots, window 2048, 16-row pages, chunks of 512, blocks of 8) on a
    one-layer model of its vocabulary: the first round seats the eight
    higher-class requests and the prefix counters are its constants."""
    cs = _chip_smoke()
    cfg = cs._tenancy_config()
    raw = cfg.to_dict()
    raw["model"].update(num_hidden_layers=1, num_attention_heads=2,
                        num_key_value_heads=2, hidden_size=16,
                        intermediate_size=32, dtype="float32")
    cfg = Config.from_dict(raw)
    pack, registry = tenancy.build_tenancy(cfg)
    eng = InferenceEngine(cfg, "cpu", slots=8, adapters=pack)
    params = llama.init_params(cfg.model, seed=0)
    b = ContinuousBatcher(eng, params)
    reqs = cs._tenant_requests(np, cfg.model.vocab_size, "", registry)
    assert [r.adapter_slot for r in reqs] == [3, 3, 1, 1, 2, 0, 1, 2, 0, 1]
    for r in reqs:
        b.submit(r)
    b.step()
    assert sorted(s.req.uid for s in b._slots if s is not None) == [
        f"r{i}" for i in range(8)]
    while b.busy:
        b.step()
    res = b.take_results()
    assert all(len(r.tokens) == cs.NEW_TOKENS for r in res.values())
    st = b.stats()
    assert (st["prefix_queries"], st["prefix_hits"],
            st["prefix_cached_tokens"], st["cow_copies"]) == (
        cs.TENANT_PREFIX_QUERIES, cs.TENANT_PREFIX_HITS,
        cs.TENANT_PREFIX_CACHED, cs.TENANT_COW)
    system = reqs[2].prompt[:cs.SYSTEM_LEN]
    assert [eng.paged.radix.match(system, salt=s)[1]
            for s in ("acme", "globex", "", "initech")] == [300, 300, 300, 0]
