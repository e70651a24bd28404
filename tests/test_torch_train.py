"""The PyTorch port's training path against the JAX package's, on the CPU.

Inputs are made with numpy from a seed (or drawn by the JAX package and
carried across with ``convert``), so both sides compute with the same
numbers:

- the loader's batches are bit-identical to ``MicroBatchDataLoader``'s;
- ``lr_schedule`` matches optax's schedules step by step, every mode;
- one ``adamw_update`` matches ``optax.adamw`` on one tree (fp32 and bf16);
- the fused and gathered CE match the JAX ones (value, dx, dw, a ragged
  tail of rows);
- the slice as a whole: six-step fp32 loss trajectories of the port's
  train step against ``picotron_tpu.train_step.build_train_step`` on a
  one-device CPU mesh, from JAX's ``init_state`` carried across, at
  rtol 2e-4;
- the non-finite gate, the trainer CLI on the CPU, the config's training
  sections and refusals, and the optimizer-state converter.
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from conftest import make_config
from picotron_tpu import train_step as jax_ts
from picotron_tpu.data import MicroBatchDataLoader as JaxLoader
from picotron_tpu.ops import cross_entropy as jax_ce
from picotron_tpu.topology import topology_from_config
from picotron_tpu.utils import shard_map as shard_map_compat
from picotron_tpu_torch import convert
from picotron_tpu_torch import train as port_train
from picotron_tpu_torch import train_step as ts
from picotron_tpu_torch.config import Config
from picotron_tpu_torch.data import MicroBatchDataLoader
from picotron_tpu_torch.ops import cross_entropy as ce

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAJ_RTOL = 2e-4  # fp32 on both sides; sums reassociate between XLA and torch
TINY = dict(num_hidden_layers=4, num_attention_heads=8, num_key_value_heads=4,
            hidden_size=64, intermediate_size=128, vocab_size=256,
            max_position_embeddings=128, rope_theta=10000.0,
            dtype="float32", attention_impl="sdpa")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Six test workers share the machine with timing-sensitive serving
    tests: keep torch to one thread here, and restore the old count."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _port_cfg(jcfg, **model):
    """The port's Config for a JAX Config, with model overrides."""
    raw = jcfg.to_dict()
    raw["model"].update(model)
    return Config.from_dict(raw)


# --------------------------------------------------------------------------- #
# data
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("case", ["config1", "acc2"])
def test_loader_batches_bit_identical_to_jax(case):
    if case == "config1":
        with open(os.path.join(REPO, "configs", "1_smollm_single_cpu",
                               "config.json")) as f:
            raw = json.load(f)
    else:
        raw = make_config(TINY, seq=16, mbs=3, acc=2).to_dict()
        raw["training"]["num_samples"] = 7  # wraps an epoch within 3 steps
    from picotron_tpu.config import Config as JaxConfig

    jl, pl_ = JaxLoader(JaxConfig.from_dict(raw)), \
        MicroBatchDataLoader(Config.from_dict(raw))
    for _ in range(3):
        a, b = next(jl), next(pl_)
        for key in ("input_ids", "target_ids"):
            assert a[key].dtype == b[key].dtype == np.int32
            np.testing.assert_array_equal(a[key], b[key])


# --------------------------------------------------------------------------- #
# optimizer: schedule and AdamW
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("sched,warmup", [("constant", 0), ("constant", 3),
                                          ("cosine", 0), ("cosine", 4),
                                          ("linear", 4)])
def test_lr_schedule_matches_optax_step_by_step(sched, warmup):
    """Both evaluate in float32; 1e-6 relative covers one ulp of cos."""
    cfg = make_config(TINY, lr_schedule=sched, lr_warmup_steps=warmup,
                      lr_min_ratio=0.1, total_train_steps=12)
    want = jax_ts.lr_schedule(cfg.training)
    got = ts.lr_schedule(_port_cfg(cfg).training)
    for count in range(16):
        w = want(jnp.int32(count)) if callable(want) else want
        g = got(count) if callable(got) else got
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6,
                                   err_msg=f"count {count}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_optax(dtype):
    """Three updates of one tree, from the same grads. fp32: 1e-6. bf16:
    both sides round every operation to bf16 with scalars in bf16, but
    XLA may fuse a few ops into one rounding; within two bf16 steps
    (2^-7 relative) of the parameter."""
    rng = np.random.default_rng(3)
    shapes = {"a": (5, 7), "b": {"c": (11,), "d": (3, 4)}}

    def tree(fn):
        return {k: (tree_like(v, fn) if isinstance(v, dict) else fn(v))
                for k, v in shapes.items()}

    def tree_like(sub, fn):
        return {k: fn(v) for k, v in sub.items()}

    params_np = tree(lambda s: rng.standard_normal(s).astype(np.float32))
    grads_np = [tree(lambda s: rng.standard_normal(s).astype(np.float32))
                for _ in range(3)]
    jdt = jnp.dtype(dtype)
    cfg = make_config(TINY, weight_decay=0.1, learning_rate=0.05,
                      lr_schedule="cosine", lr_warmup_steps=1,
                      total_train_steps=5)
    opt = jax_ts.build_optimizer(cfg)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), params_np)
    js = opt.init(jp)
    port = convert.params_from_jax(params_np, dtype=getattr(torch, dtype))
    leaves = ts.param_leaves(port)
    state = ts.init_opt_state(port)
    sched = ts.lr_schedule(_port_cfg(cfg).training)
    for g in grads_np:
        jg = jax.tree.map(lambda a: jnp.asarray(a, jdt), g)
        upd, js = opt.update(jg, js, jp)
        jp = optax.apply_updates(jp, upd)
        tg = ts.param_leaves(convert.params_from_jax(
            g, dtype=getattr(torch, dtype)))
        ts.adamw_update(leaves, tg, state, cfg.training,
                        float(sched(state["count"])))
    tol = (dict(rtol=1e-6, atol=1e-6) if dtype == "float32"
           else dict(rtol=2 ** -7, atol=1e-3))
    for w, g in zip(jax.tree.leaves(jp), leaves):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), **tol)
    back = convert.opt_state_from_jax(jax.tree.map(np.asarray, js))
    assert back["count"] == state["count"] == 3
    for w, g in zip(back["mu"] + back["nu"], state["mu"] + state["nu"]):
        np.testing.assert_allclose(g.float().numpy(), w.float().numpy(),
                                   **tol)


def test_opt_state_round_trips_through_optax_tree():
    cfg = make_config(TINY, lr_schedule="linear", lr_warmup_steps=1,
                      total_train_steps=4)
    topo = topology_from_config(cfg)
    params, state = jax_ts.init_state(cfg, topo)
    state_np = jax.tree.map(np.asarray, state)
    port = convert.opt_state_from_jax(state_np)
    port["count"] = 5
    port["mu"] = [t + 1.0 for t in port["mu"]]
    back = convert.opt_state_to_jax(port, state_np)
    assert jax.tree.structure(back) == jax.tree.structure(state_np)
    again = convert.opt_state_from_jax(back)
    assert again["count"] == 5
    for a, b in zip(again["mu"], port["mu"]):
        torch.testing.assert_close(a, b)
    counts = [leaf for path, leaf in jax.tree_util.tree_leaves_with_path(back)
              if "count" in jax.tree_util.keystr(path)]
    assert len(counts) == 2 and all(int(c) == 5 for c in counts)


# --------------------------------------------------------------------------- #
# cross-entropy
# --------------------------------------------------------------------------- #


def _jax_tp1(fn, *args):
    mesh = Mesh(np.array(jax.devices()[:1]), ("tp",))
    return shard_map_compat(fn, mesh=mesh, in_specs=(P(),) * len(args),
                            out_specs=P(), check_vma=False)(*args)


@pytest.mark.parametrize("impl", ["fused", "gathered"])
def test_cross_entropy_matches_jax_with_ragged_tail(impl):
    """T = 2 x 23 = 46 rows in chunks of 16: a padded tail of 2 rows,
    which must add neither loss nor gradient. fp32, 2e-5."""
    rng = np.random.default_rng(4)
    B, S, H, V = 2, 23, 16, 64
    x = rng.standard_normal((B, S, H)).astype(np.float32)
    w = (0.2 * rng.standard_normal((H, V))).astype(np.float32)
    t = rng.integers(0, V, (B, S)).astype(np.int32)

    def jfn(x, w, t):
        def loss(x, w):
            if impl == "fused":
                return jax_ce.cross_entropy_fused(x, w, t, "tp", 16)
            return jax_ce.cross_entropy_gathered(x @ w, t)
        return jax.value_and_grad(loss, argnums=(0, 1))(x, w)

    jl, (jdx, jdw) = _jax_tp1(jfn, jnp.asarray(x), jnp.asarray(w),
                              jnp.asarray(t))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    tt = torch.from_numpy(t)
    loss = (ce.cross_entropy_fused(tx, tw, tt, 16) if impl == "fused"
            else ce.cross_entropy_gathered(tx @ tw, tt))
    loss.backward()
    tol = dict(rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(loss.item(), float(jl), **tol)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), **tol)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), **tol)


# --------------------------------------------------------------------------- #
# the slice as a whole
# --------------------------------------------------------------------------- #


def _trajectories(jcfg, pcfg, steps=6):
    """Per-step losses of both train steps from JAX's init_state, over the
    same loader batches."""
    topo = topology_from_config(jcfg)
    jparams, jstate = jax_ts.init_state(jcfg, topo)
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams))
    for p in ts.param_leaves(params):
        p.requires_grad_(True)
    state = convert.opt_state_from_jax(jax.tree.map(np.asarray, jstate))
    jstep = jax_ts.build_train_step(jcfg, topo)
    step = ts.build_train_step(pcfg)
    loader = JaxLoader(jcfg)
    want, got = [], []
    for _ in range(steps):
        batch = next(loader)
        jparams, jstate, jl = jstep(
            jparams, jstate, *jax_ts.shard_batch(batch, topo))
        want.append(float(jl))
        params, state, loss = step(params, state, batch["input_ids"],
                                   batch["target_ids"])
        got.append(float(loss))
    return np.array(want), np.array(got)


@pytest.mark.parametrize("case", ["a_full_remat_flash_mha",
                                  "b_no_remat_sdpa_gqa_clip_cosine"])
def test_train_trajectory_matches_jax(case):
    """(a) remat "full", M = 1, MHA, attention_impl "flash" on the port
    side with use_pallas_rmsnorm True: the port runs the RMSNorm and
    flash-attention Functions, with their plain backward, under
    torch.utils.checkpoint. The JAX side runs the same function through
    its sdpa and plain RMSNorm: the Pallas interpreter's callbacks cannot
    be rematerialised by jax.checkpoint, and the Pallas RMSNorm backward
    does not run under this jax (the kernels' backward against Pallas is
    pinned in test_torch_ops.py). (b) remat "none", M = 2, GQA
    nkv = H / 2, grad_clip 1.0, cosine with warm-up, sdpa on both sides.
    fp32, rtol 2e-4, and the loss must fall."""
    if case.startswith("a"):
        kw = dict(TINY, num_key_value_heads=8)
        jcfg = make_config(kw, seq=32, mbs=2, acc=1, remat="full",
                           learning_rate=3e-3)
        pcfg = _port_cfg(jcfg, attention_impl="flash",
                         use_pallas_rmsnorm=True)
        want, got = _trajectories(jcfg, pcfg)
    else:
        jcfg = make_config(TINY, seq=32, mbs=2, acc=2, remat="none",
                           grad_clip=1.0, lr_schedule="cosine",
                           lr_warmup_steps=2, total_train_steps=8,
                           learning_rate=3e-3)
        want, got = _trajectories(jcfg, _port_cfg(jcfg))
    np.testing.assert_allclose(got, want, rtol=TRAJ_RTOL)
    assert got[-1] < got[0]


def test_nonfinite_gate_leaves_params_and_state_unchanged():
    cfg = Config.from_dict({"model": TINY, "training": {
        "seq_length": 16, "micro_batch_size": 2, "remat": "none"}})
    params, state = ts.init_state(cfg, device="cpu", seed=1)
    tokens = np.random.default_rng(0).integers(0, 256, (1, 2, 16))
    step = ts.build_train_step(cfg)
    params, state, _ = step(params, state, tokens, tokens)  # moments != 0
    before = [p.detach().clone() for p in ts.param_leaves(params)]
    mu = [m.clone() for m in state["mu"]]
    nu = [n.clone() for n in state["nu"]]
    poisoned = ts.build_train_step(cfg, poison_nonfinite=True)
    params, state, loss = poisoned(params, state, tokens, tokens)
    assert not math.isfinite(float(loss))
    assert state["count"] == 1
    for a, b in zip(before + mu + nu,
                    ts.param_leaves(params) + state["mu"] + state["nu"]):
        assert torch.equal(a, b)
    # and a finite step after it moves them again
    params, state, loss = step(params, state, tokens, tokens)
    assert math.isfinite(float(loss)) and state["count"] == 2
    assert not torch.equal(before[0], ts.param_leaves(params)[0])


def test_trainer_cli_on_cpu_logs_and_learns(tmp_path, capsys):
    raw = {"model": dict(TINY, num_hidden_layers=2, vocab_size=64),
           "training": {"seq_length": 32, "micro_batch_size": 4,
                        "learning_rate": 1e-2, "total_train_steps": 100,
                        "remat": "full"},
           "distributed": {"use_cpu": True}, "dataset": {"name": "synthetic"}}
    path = tmp_path / "config.json"
    path.write_text(json.dumps(raw))
    history = []
    step, tokens, loss = port_train.train(
        Config.from_json(str(path)), max_steps_override=12,
        loss_history=history, device="cpu")
    assert (step, tokens) == (12, 12 * 4 * 32)
    assert len(history) == 12 and loss < math.log(64) - 1.0
    assert port_train.main(["--config", str(path), "--max-steps", "3"],
                           device="cpu") == 0
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("Step:")]
    assert len(lines) == 12 + 3
    assert all(f in lines[-1] for f in ("Loss:", "Global batch size:",
                                        "Tokens/s:", "Tokens/s/chip:",
                                        "Tokens:"))
    assert "MFU" not in lines[-1]  # no peak on the CPU
    assert "done: 3 steps" in out


def test_trainer_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = os.path.join(REPO, "configs", "1_smollm_single_cpu", "config.json")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_train.main(["--config", path, "--max-steps", "1"])


# --------------------------------------------------------------------------- #
# config
# --------------------------------------------------------------------------- #


def test_training_config_loads_validates_and_refuses_unported():
    path = os.path.join(REPO, "configs", "1_smollm_single_cpu", "config.json")
    cfg = Config.from_json(path)
    cfg.check_trainable()
    assert (cfg.training.seq_length, cfg.training.micro_batch_size,
            cfg.global_batch_size, cfg.tokens_per_step) == (128, 4, 4, 512)
    assert cfg.training.remat == "full" and cfg.model.loss_impl == "auto"
    dp8 = Config.from_json(os.path.join(REPO, "configs", "2_smollm_dp8",
                                        "config.json"))  # loads for serving
    with pytest.raises(ValueError, match=r"distributed.dp_size=8: the "
                                         r"PyTorch port trains on one device"):
        dp8.check_trainable()
    refused = [({"training": {"remat": "save_attn"}}, "training.remat"),
               ({"dataset": {"name": "roneneldan/TinyStories"}},
                "HF datasets"),
               ({"distributed": {"zero1": True}}, "distributed.zero1"),
               ({"resilience": {"ckpt_mirror_dir": "/mnt/mirror"}},
                "resilience.ckpt_mirror_dir"),
               ({"logging": {"use_wandb": True}}, "logging.use_wandb"),
               ({"resilience": {"chaos_nan_step": 3}},
                "resilience.chaos_nan_step")]
    for raw, msg in refused:
        with pytest.raises(ValueError, match=msg):
            Config.from_dict(raw).check_trainable()
    for raw, msg in [({"training": {"remat": "some"}}, "unknown remat"),
                     ({"training": {"grad_accum_dtype": "f16"}},
                      "unknown grad_accum_dtype"),
                     ({"model": {"loss_impl": "x"}}, "unknown loss_impl"),
                     ({"training": {"lr_schedule": "cosine",
                                    "lr_warmup_steps": 200}},
                      r"total_train_steps \(100\) must exceed"),
]:
        with pytest.raises(ValueError, match=msg):
            Config.from_dict(raw)
    long_seq = Config.from_dict({"training": {"seq_length": 4096}})
    with pytest.raises(ValueError,
                       match="seq_length 4096 > max_position_embeddings"):
        long_seq.check_trainable()
