"""The PyTorch port's checkpoints against the safetensors library and the
JAX package, on the CPU.

- the format: the port's reader reads what ``safetensors.numpy`` and
  ``safetensors.torch`` write (F32, F16, BF16, I8; one file, and a sharded
  set with an index), the library reads the port's files to the same bits,
  and a truncated or malformed file is refused;
- HF interop, bit for bit: the JAX package's export loads in the port as
  ``convert.params_from_jax`` of the same tree, the port's export loads in
  the JAX package as ``convert.params_to_jax``, in fp32 and bf16, tied and
  sharded; an int8 load gives the JAX package's ``q`` and ``s`` (an fp16
  file under a bf16 model too); templates and HF configs are checked as
  the JAX package checks them;
- the training checkpoint: two steps, a save, and a resumed run to step 6
  equal an uninterrupted run bit for bit and the JAX trainer's trajectory
  at ``test_torch_train.py``'s tolerance; the fallback from a corrupt
  latest step, a geometry change refused, ``max_to_keep``, HF bootstrap;
- SIGTERM: a child trainer exits 75 with a checkpoint, and resumes;
- ``generate --load-path`` / ``--hf-path`` serve a saved random tree's
  tokens, int8 included, and refuse an orbax directory;
- the port and ``chip_smoke.py`` import no file library the card's
  machine lacks.
"""

import json
import os
import re
import signal
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.numpy import save_file as np_save_file
from safetensors.torch import save_file as pt_save_file

from conftest import make_config
from picotron_tpu import checkpoint as jax_ckpt
from picotron_tpu.models import llama as jax_llama
from picotron_tpu.train import train as jax_train
from picotron_tpu_torch import checkpoint as ckpt
from picotron_tpu_torch import convert
from picotron_tpu_torch import train as port_train
from picotron_tpu_torch import train_step as ts
from picotron_tpu_torch.config import Config
from picotron_tpu_torch.data import MicroBatchDataLoader
from picotron_tpu_torch.models import llama
from picotron_tpu_torch.resilience import retry
from picotron_tpu_torch.resilience.preemption import (
    EXIT_PREEMPTED,
    PreemptionGuard,
)
from picotron_tpu_torch.tools import generate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAJ_RTOL = 2e-4  # test_torch_train.py's: fp32, sums reassociate
TINY = dict(num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=4,
            hidden_size=64, intermediate_size=128, vocab_size=256,
            max_position_embeddings=128, rope_theta=10000.0,
            dtype="float32", attention_impl="sdpa")
FILE_LIBRARIES = ("safetensors", "orbax", "transformers", "datasets",
                  "huggingface_hub")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _model(dtype="float32", **kw):
    return Config.from_dict({"model": dict(TINY, dtype=dtype, **kw)}).model


def _jax_cfg(dtype="float32", model=None, **kw):
    return make_config(dict(TINY, dtype=dtype, **(model or {})), **kw)


def _leaves_equal(a: dict, b: dict) -> None:
    assert ckpt.leaf_names(a) == ckpt.leaf_names(b)
    for name, x, y in zip(ckpt.leaf_names(a), ts.param_leaves(a),
                          ts.param_leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y), name


def _np_equal(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], dict):
            _np_equal(a[k], b[k])
        else:
            x = np.asarray(a[k])
            y = np.asarray(b[k])
            if x.dtype == ml_dtypes.bfloat16:
                x = x.astype(np.float32)
            if y.dtype == ml_dtypes.bfloat16:
                y = y.astype(np.float32)
            np.testing.assert_array_equal(x, y, err_msg=k)


# --------------------------------------------------------------------------- #
# the format
# --------------------------------------------------------------------------- #


def _library_tensors():
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    return {"f32": f32, "f16": rng.standard_normal((4, 2)).astype(np.float16),
            "bf16": rng.standard_normal((2, 3, 4)).astype(ml_dtypes.bfloat16),
            "i8": rng.integers(-128, 128, (7,)).astype(np.int8),
            "empty": np.zeros((0, 3), np.float32)}


def _as_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


@pytest.mark.parametrize("writer", ["numpy", "torch"])
@pytest.mark.parametrize("layout", ["single", "sharded"])
def test_reader_reads_library_files(tmp_path, writer, layout):
    want = {k: _as_torch(v) for k, v in _library_tensors().items()}

    def save(tensors, path):
        if writer == "numpy":
            np_save_file({k: _library_tensors()[k] for k in tensors}, path)
        else:
            pt_save_file(tensors, path)

    if layout == "single":
        save(want, str(tmp_path / "model.safetensors"))
    else:
        names = sorted(want)
        shards = {"a.safetensors": names[:2], "b.safetensors": names[2:]}
        for fname, ks in shards.items():
            save({k: want[k] for k in ks}, str(tmp_path / fname))
        (tmp_path / "model.safetensors.index.json").write_text(json.dumps(
            {"weight_map": {k: f for f, ks in shards.items() for k in ks}}))
    with ckpt.SafetensorsReader(str(tmp_path)) as reader:
        assert reader.names == set(want)
        for k, t in want.items():
            assert reader.get_shape(k) == tuple(t.shape)
            got = reader.get(k)
            assert got.dtype == t.dtype and torch.equal(got, t), k


def test_library_reads_port_files(tmp_path):
    """The port's writer -> ``safe_open`` in both frameworks, same bits;
    the header is padded to 8 bytes; F64 and ``__metadata__`` read."""
    want = {k: _as_torch(v) for k, v in _library_tensors().items()}
    path = str(tmp_path / "x.safetensors")
    n = ckpt.write_safetensors(path, want)
    assert n == os.path.getsize(path)
    with open(path, "rb") as f:
        assert int.from_bytes(f.read(8), "little") % 8 == 0
    with safe_open(path, framework="pt") as f:
        for k, t in want.items():
            assert torch.equal(f.get_tensor(k), t), k
    with safe_open(path, framework="np") as f:
        for k, a in _library_tensors().items():
            np.testing.assert_array_equal(f.get_tensor(k).view(np.uint8),
                                          a.view(np.uint8), err_msg=k)
    f64 = np.arange(6, dtype=np.float64).reshape(2, 3)
    np_save_file({"f64": f64}, str(tmp_path / "f64.safetensors"),
                 metadata={"format": "np"})
    with ckpt.SafetensorsFile(str(tmp_path / "f64.safetensors")) as f:
        assert f.metadata == {"format": "np"} and f.keys() == ["f64"]
        assert torch.equal(f.get("f64"), torch.from_numpy(f64))
    with pytest.raises(ValueError, match="not written"):
        ckpt.write_safetensors(path, {"x": torch.zeros(2, dtype=torch.int64)})


def test_reader_refuses_truncated_and_malformed_files(tmp_path):
    path = tmp_path / "x.safetensors"
    ckpt.write_safetensors(str(path), {"a": torch.ones(64, 64)})
    raw = path.read_bytes()
    (tmp_path / "cut.safetensors").write_bytes(raw[:-100])
    with pytest.raises(ValueError, match="truncated"):
        ckpt.SafetensorsFile(str(tmp_path / "cut.safetensors"))
    (tmp_path / "head.safetensors").write_bytes(raw[:12])
    with pytest.raises(ValueError, match="header length"):
        ckpt.SafetensorsFile(str(tmp_path / "head.safetensors"))
    bad = raw.replace(b'"F32"', b'"U7X"')
    (tmp_path / "dtype.safetensors").write_bytes(bad)
    with pytest.raises(ValueError, match="dtype 'U7X'"):
        ckpt.SafetensorsFile(str(tmp_path / "dtype.safetensors"))
    with pytest.raises(FileNotFoundError, match="no model.safetensors"):
        ckpt.SafetensorsReader(str(tmp_path / "nowhere"))


# --------------------------------------------------------------------------- #
# HF interop against the JAX package
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_export_loads_in_port_bit_for_bit(tmp_path, dtype):
    jcfg = _jax_cfg(dtype)
    jparams = jax_llama.init_params(jax.random.PRNGKey(1), jcfg.model)
    path = str(tmp_path / "model.safetensors")
    jax_ckpt.save_hf_safetensors(jparams, path, jcfg)
    got = ckpt.load_hf_safetensors(path, _model(dtype))
    want = convert.params_from_jax(jax.tree.map(np.asarray, jparams))
    _leaves_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_export_loads_in_jax_bit_for_bit(tmp_path, dtype):
    params = llama.init_params(_model(dtype), seed=2)
    path = str(tmp_path / "out" / "model.safetensors")
    n = ckpt.save_hf_safetensors(params, path)
    assert n == os.path.getsize(path) and not os.path.exists(path + ".tmp")
    got = jax_ckpt.load_hf_safetensors(path, _jax_cfg(dtype).model)
    assert all(x.dtype == jnp.dtype(dtype) for x in jax.tree.leaves(got))
    _np_equal(jax.tree.map(np.asarray, got), convert.params_to_jax(params))


def test_tied_and_sharded_load_like_jax(tmp_path):
    """The port's export split over two files with an index and without
    ``lm_head.weight``: the head is the embedding's transpose, and the
    port's tree is the JAX package's load of the same directory."""
    params = llama.init_params(_model(), seed=3)
    ckpt.save_hf_safetensors(params, str(tmp_path / "full.safetensors"))
    with safe_open(str(tmp_path / "full.safetensors"), framework="np") as f:
        full = {k: f.get_tensor(k) for k in f.keys()}
    del full["lm_head.weight"]
    names = sorted(full)
    shards = {"model-00001.safetensors": names[: len(names) // 2],
              "model-00002.safetensors": names[len(names) // 2:]}
    d = tmp_path / "sharded"
    d.mkdir()
    for fname, ks in shards.items():
        np_save_file({k: full[k] for k in ks}, str(d / fname))
    (d / "model.safetensors.index.json").write_text(json.dumps(
        {"weight_map": {k: f for f, ks in shards.items() for k in ks}}))
    got = ckpt.load_hf_safetensors(str(d), _model())
    assert torch.equal(got["lm_head"], params["embed"].T)
    assert got["lm_head"].is_contiguous()
    assert torch.equal(got["layers"]["wq"], params["layers"]["wq"])
    want = jax_ckpt.load_hf_safetensors(str(d), _jax_cfg().model)
    _np_equal(convert.params_to_jax(got), jax.tree.map(np.asarray, want))
    ckpt.validate_hf_template(str(d), _model())  # no lm_head: allowed


@pytest.mark.parametrize("source", ["bf16", "fp16_under_bf16", "tied_fp32"])
def test_int8_load_matches_jax_bit_for_bit(tmp_path, source):
    """``weight_dtype="int8"``: the port's ``q`` and ``s`` are the JAX
    package's, and the port's own quantization of its dense load; a file
    whose dtype is not the model's is cast before it is quantized
    (``tests/test_checkpoint.py:396``)."""
    file_dtype, model_dtype = {"bf16": ("bfloat16", "bfloat16"),
                               "fp16_under_bf16": ("float16", "bfloat16"),
                               "tied_fp32": ("float32", "float32")}[source]
    params = llama.init_params(_model(file_dtype), seed=4)
    path = str(tmp_path / "model.safetensors")
    ckpt.save_hf_safetensors(params, path)
    if source == "tied_fp32":
        with safe_open(path, framework="np") as f:
            full = {k: f.get_tensor(k) for k in f.keys() if k != "lm_head.weight"}
        np_save_file(full, path)
    m = _model(model_dtype)
    quant = ckpt.load_hf_safetensors(path, m, weight_dtype="int8")
    dense = ckpt.load_hf_safetensors(path, m)
    assert dense["embed"].dtype == getattr(torch, model_dtype)
    want = llama.quantize_params(dense)
    jq = jax_ckpt.load_hf_safetensors(path, _jax_cfg(model_dtype).model,
                                      weight_dtype="int8")
    for k in (*llama.QUANT_WEIGHT_LEAVES, "lm_head"):
        got = quant[k] if k == "lm_head" else quant["layers"][k]
        ref = want[k] if k == "lm_head" else want["layers"][k]
        jref = jq[k] if k == "lm_head" else jq["layers"][k]
        assert got["q"].dtype == torch.int8 and got["s"].dtype == torch.float32
        # kernel G takes contiguous operands on the card
        assert got["q"].is_contiguous() and got["s"].is_contiguous(), k
        for part in ("q", "s"):
            assert torch.equal(got[part], ref[part]), (k, part)
            np.testing.assert_array_equal(got[part].numpy(),
                                          np.asarray(jref[part]),
                                          err_msg=f"{k}.{part}")
    for k in ("attn_norm", "mlp_norm"):
        assert torch.equal(quant["layers"][k], dense["layers"][k])
    assert torch.equal(quant["embed"], dense["embed"])
    with pytest.raises(ValueError, match="cannot be exported"):
        ckpt.save_hf_safetensors(quant, str(tmp_path / "no.safetensors"))
    with pytest.raises(ValueError, match="unknown weight_dtype"):
        ckpt.load_hf_safetensors(path, m, weight_dtype="fp8")


def test_validate_hf_template_and_save_refusals(tmp_path):
    params = llama.init_params(_model(), seed=5)
    path = str(tmp_path / "model.safetensors")
    ckpt.save_hf_safetensors(params, path)
    ckpt.validate_hf_template(path, _model())
    for m, msg in ((_model(hidden_size=128),
                    r"lm_head.weight has shape \(256, 64\), "
                    r"expected \(256, 128\)"),
                   (_model(num_hidden_layers=3),
                    r"missing tensors \['model.layers.2")):
        with pytest.raises(ValueError, match="does not match the model "
                                             "config: " + msg):
            ckpt.validate_hf_template(path, m)
        with pytest.raises(ValueError, match="does not match the model"):
            jax_ckpt.validate_hf_template(path, _jax_cfg(model=dict(
                hidden_size=m.hidden_size,
                num_hidden_layers=m.num_hidden_layers)).model)
    # headers only: no tensor byte is read
    orig = ckpt.SafetensorsFile.get
    ckpt.SafetensorsFile.get = None
    try:
        ckpt.validate_hf_template(path, _model())
    finally:
        ckpt.SafetensorsFile.get = orig
    params["layers"]["attn_norm"][1] = 0
    with pytest.raises(ValueError, match="all-zero"):
        ckpt.save_hf_safetensors(params, str(tmp_path / "pad.safetensors"))


def test_model_config_from_hf_matches_jax(tmp_path):
    hf = dict(num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, hidden_size=32, intermediate_size=64,
              vocab_size=128, rms_norm_eps=1e-6, rope_theta=5000.0,
              max_position_embeddings=64, architectures=["LlamaForCausalLM"])
    (tmp_path / "config.json").write_text(json.dumps(hf))
    for path in (str(tmp_path), str(tmp_path / "config.json")):
        got = ckpt.model_config_from_hf(path)
        assert got == jax_ckpt.model_config_from_hf(path)
        assert "architectures" not in got and got["rope_theta"] == 5000.0
    with pytest.raises(FileNotFoundError, match="never|does not make"):
        ckpt.model_config_from_hf("HuggingFaceTB/SmolLM-1.7B")


# --------------------------------------------------------------------------- #
# the training checkpoint
# --------------------------------------------------------------------------- #


def _train_raw(tmp_path, **ckpt_kw) -> dict:
    """A tiny fp32 training config as JSON-ready sections, checkpoints
    under ``tmp_path / "ckpt"``."""
    raw = _jax_cfg(seq=32, mbs=2).to_dict()
    raw["checkpoint"].update(save_dir=str(tmp_path / "ckpt"), **ckpt_kw)
    return raw


def _port_run(raw, steps=None, **overrides):
    raw = json.loads(json.dumps(raw))
    for section, kv in overrides.items():
        raw[section].update(kv)
    history = []
    port_train.train(Config.from_dict(raw), max_steps_override=steps,
                     loss_history=history, device="cpu")
    return [loss for _, loss in history]


def test_resume_is_bitwise_and_matches_jax_trajectory(tmp_path):
    """Both trainers start from one HF file (JAX's init, exported): two
    port steps with a save, then a fresh ``train`` with ``load_path:
    "auto"`` to step 6, equal an uninterrupted six-step port run bit for
    bit and the JAX trainer's six losses at rtol 2e-4."""
    jcfg = _jax_cfg(seq=32, mbs=2)
    boot = str(tmp_path / "boot.safetensors")
    jax_ckpt.save_hf_safetensors(
        jax_llama.init_params(jax.random.PRNGKey(7), jcfg.model), boot, jcfg)
    raw = _train_raw(tmp_path, hf_bootstrap_path=boot)
    raw["training"]["total_train_steps"] = 6
    first = _port_run(raw, checkpoint={"save_frequency": 2}, training={
        "total_train_steps": 2})
    mgr = ckpt.CheckpointManager(raw["checkpoint"]["save_dir"])
    assert mgr.all_steps() == [2]
    with open(os.path.join(mgr.step_dir(2), "meta.json")) as f:
        meta = json.load(f)
    assert (meta["step"], meta["count"], meta["num_hidden_layers"],
            meta["trained_tokens"], meta["data"]["consumed_rows"]) == (
        2, 2, 2, 2 * 64, 4)
    resumed = _port_run(raw, checkpoint={"load_path": "auto"})
    whole = _port_run(raw, checkpoint={"save_dir": str(tmp_path / "other")})
    assert len(resumed) == 4 and first + resumed == whole  # bit for bit

    jcfg.checkpoint.hf_bootstrap_path = boot
    jcfg.checkpoint.save_dir = str(tmp_path / "jax")
    jcfg.training.total_train_steps = 6
    jhist = []
    jax_train(jcfg, loss_history=jhist)
    np.testing.assert_allclose(whole, [loss for _, loss in jhist],
                               rtol=TRAJ_RTOL)
    assert whole[-1] < whole[0]


def test_corrupt_latest_falls_back_and_a_missing_explicit_path_raises(
        tmp_path, capsys):
    raw = _train_raw(tmp_path, save_frequency=2)
    raw["resilience"]["io_attempts"] = 1
    losses = _port_run(raw, steps=4)
    mgr = ckpt.CheckpointManager(raw["checkpoint"]["save_dir"], io_attempts=1)
    assert mgr.all_steps() == [2, 4]
    p4 = os.path.join(mgr.step_dir(4), "params.safetensors")
    with open(p4, "r+b") as f:
        f.truncate(os.path.getsize(p4) // 2)
    cfg = Config.from_dict(raw)
    params, state = ts.init_state(cfg, device="cpu", seed=9)
    with pytest.warns(RuntimeWarning, match="step 4 .* corrupt or partially "
                                            "written"):
        _, state, step, tokens = mgr.load(params, state)
    assert (step, tokens, mgr.last_restored_step, state["count"]) == (
        2, 2 * 64, 2, 2)
    with pytest.raises(FileNotFoundError, match=r"tried steps \[4\]"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            mgr.load(params, state, step=4)
    # the trainer resumes from step 2 and runs steps 3 and 4 again
    with pytest.warns(RuntimeWarning, match="falling back"):
        again = _port_run(raw, steps=4)
    assert again == losses[2:]
    assert "resumed from" in capsys.readouterr().out
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="no checkpoint found"):
        _port_run(raw, steps=1, checkpoint={"load_path": str(empty)})


def test_resume_refuses_a_changed_batch_geometry(tmp_path):
    raw = _train_raw(tmp_path, save_frequency=1)
    _port_run(raw, steps=1)
    with pytest.raises(ValueError, match="rows_per_step: saved=2 now=4.*"
                                         "batch geometry changed"):
        _port_run(raw, steps=2, training={"micro_batch_size": 4})
    loader = MicroBatchDataLoader(Config.from_dict(raw))
    loader.verify_resume(None, 5)  # no record: passes
    loader.skip_steps(3)
    a = next(loader)
    loader.seek_steps(3)
    assert np.array_equal(next(loader)["input_ids"], a["input_ids"])


def test_max_to_keep_and_atomic_steps(tmp_path):
    cfg = Config.from_dict({"model": TINY})
    params, state = ts.init_state(cfg, device="cpu", seed=0)
    mgr = ckpt.CheckpointManager(str(tmp_path / "c"), max_to_keep=3)
    for s in range(1, 6):
        n = mgr.save(s, params, state, trained_tokens=10 * s)
    assert mgr.all_steps() == [3, 4, 5]
    assert sorted(os.listdir(mgr.directory)) == ["step_3", "step_4",
                                                 "step_5"]
    files = sorted(os.listdir(mgr.step_dir(5)))
    assert files == ["meta.json", "opt_state.safetensors",
                     "params.safetensors"]
    assert n == sum(os.path.getsize(os.path.join(mgr.step_dir(5), f))
                    for f in files)
    with safe_open(os.path.join(mgr.step_dir(5), "opt_state.safetensors"),
                   framework="pt") as f:
        names = ckpt.leaf_names(params)
        assert sorted(f.keys()) == sorted([f"mu.{k}" for k in names]
                                          + [f"nu.{k}" for k in names])
    loaded, step, tokens = mgr.load_params(cfg.model, step=4)
    assert (step, tokens) == (4, 40)
    _leaves_equal(loaded, params)
    q, _, _ = mgr.load_params(cfg.model, weight_dtype="int8")
    want = llama.quantize_params(params)
    for k in (*llama.QUANT_WEIGHT_LEAVES, "lm_head"):
        got, ref = ((q[k], want[k]) if k == "lm_head"
                    else (q["layers"][k], want["layers"][k]))
        assert all(torch.equal(got[x], ref[x]) for x in ("q", "s")), k
    with pytest.raises(ckpt.CheckpointMismatch, match="config wants 3"):
        mgr.load_params(Config.from_dict(
            {"model": dict(TINY, num_hidden_layers=3)}).model)
    with pytest.raises(ckpt.CheckpointMismatch, match="do not fit"):
        mgr.load_params(Config.from_dict(
            {"model": dict(TINY, intermediate_size=256)}).model)


@pytest.mark.parametrize("mode", ["load", "reinit"])
def test_hf_bootstrap_keeps_the_file_or_the_seed(tmp_path, mode):
    """``hf_bootstrap_path``: the first loss is a manual step's from the
    file's weights; with ``hf_bootstrap_reinit`` it is the plain run's
    (``tests/test_checkpoint.py:507``, :544)."""
    params = llama.init_params(_model(), seed=11)
    boot = str(tmp_path / "boot.safetensors")
    ckpt.save_hf_safetensors(params, boot)
    raw = _train_raw(tmp_path, hf_bootstrap_path=boot,
                     hf_bootstrap_reinit=mode == "reinit")
    got = _port_run(raw, steps=1)[0]
    if mode == "reinit":
        plain = _port_run(raw, steps=1, checkpoint={"hf_bootstrap_path": ""})
        assert got == plain[0]
    else:
        cfg = Config.from_dict(raw)
        for p in ts.param_leaves(params):
            p.requires_grad_(True)
        batch = next(MicroBatchDataLoader(cfg))
        _, _, loss = ts.build_train_step(cfg)(
            params, ts.init_opt_state(params), batch["input_ids"],
            batch["target_ids"])
        assert got == float(loss)
    raw["model"]["hidden_size"] = 128
    raw["model"]["num_attention_heads"] = 8
    with pytest.raises(ValueError, match="does not match the model config"):
        _port_run(raw, steps=1)


# --------------------------------------------------------------------------- #
# SIGTERM
# --------------------------------------------------------------------------- #


def _child(config: str, *extra) -> subprocess.Popen:
    code = ("import sys, torch\ntorch.set_num_threads(1)\n"
            "from picotron_tpu_torch.train import main\n"
            f"sys.exit(main(['--config', {config!r}, *{list(extra)!r}], "
            "device='cpu'))\n")
    env = dict(os.environ, PYTHONPATH=REPO, PYTHONUNBUFFERED="1")
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def test_sigterm_flushes_exits_75_and_resumes(tmp_path):
    raw = _train_raw(tmp_path, save_frequency=100_000)
    raw["training"]["total_train_steps"] = 100_000
    path = tmp_path / "config.json"
    path.write_text(json.dumps(raw))
    proc = _child(str(path))
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("Step:"):
                proc.send_signal(signal.SIGTERM)
                break
        out, _ = proc.communicate(timeout=120)
    finally:
        proc.kill()
    out = "".join(lines) + out
    assert proc.returncode == EXIT_PREEMPTED, out
    m = re.search(r"flushed emergency checkpoint at step (\d+)", out)
    assert m and "preemption: SIGTERM received" in out, out
    step = int(m.group(1))
    mgr = ckpt.CheckpointManager(raw["checkpoint"]["save_dir"])
    assert mgr.latest_step() == step >= 1
    proc = _child(str(path), "--max-steps", str(step + 2))
    out, _ = proc.communicate(timeout=120)
    assert proc.returncode == 0, out
    assert f"at step {step} " in out and f"done: {step + 2} steps" in out
    assert len(re.findall(r"^Step: ", out, re.M)) == 2
    assert mgr.latest_step() == step + 2  # the flush at the end


def test_retry_and_preemption_guard():
    calls, sleeps = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("flake")
        return "ok"

    assert retry(flaky, attempts=3, backoff=0.5, jitter=0.0,
                 sleep=sleeps.append) == "ok"
    assert sleeps == [0.5, 1.0]
    with pytest.raises(OSError):
        retry(lambda: (_ for _ in ()).throw(OSError("x")), attempts=2,
              sleep=lambda s: None)
    before = signal.getsignal(signal.SIGTERM)
    guard = PreemptionGuard().install()
    try:
        assert signal.getsignal(signal.SIGTERM) == guard._handle
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.triggered and guard.signame == "SIGTERM"
    finally:
        guard.uninstall()
    assert signal.getsignal(signal.SIGTERM) == before
    import threading
    assert guard.emergency_save(lambda: None) is True
    done = threading.Event()
    assert guard.emergency_save(done.wait, timeout_s=0.05) is False
    done.set()


# --------------------------------------------------------------------------- #
# generate
# --------------------------------------------------------------------------- #

_GEN_CFG = {"model": dict(TINY, vocab_size=64, max_position_embeddings=48),
            "inference": {"prefill_chunk": 8},
            "training": {"seq_length": 48}}
_PROMPTS = ["--prompt-ids", "1,2,3", "--prompt-ids",
            ",".join(str(i % 60 + 1) for i in range(13))]


def _streams(capsys, *args) -> tuple:
    rc = generate.main([*args, *_PROMPTS, "--max-new-tokens", "6",
                        "--slots", "2"], device="cpu")
    out = capsys.readouterr().out
    assert rc == 0, out
    return dict(re.findall(r"^\[(req\d)\] prompt=\[.*\] -> (\[.*\])", out,
                           re.M)), out


def test_generate_serves_saved_weights_like_random_init(tmp_path, capsys):
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(_GEN_CFG))
    cfg = Config.from_json(str(path))
    params = llama.init_params(cfg.model, seed=3)  # what --random-init draws
    ckpt.save_hf_safetensors(params, str(tmp_path / "hf" /
                                         "model.safetensors"))
    ckpt.CheckpointManager(str(tmp_path / "run")).save(
        7, params, ts.init_opt_state(params), trained_tokens=21)
    want, _ = _streams(capsys, "--config", str(path), "--random-init",
                       "--seed", "3")
    assert len(want) == 2
    got, _ = _streams(capsys, "--config", str(path), "--hf-path",
                      str(tmp_path / "hf"))
    assert got == want
    got, out = _streams(capsys, "--config", str(path), "--load-path",
                        str(tmp_path / "run"))
    assert got == want and "loaded step 7 (21 trained tokens)" in out
    _, out = _streams(capsys, "--config", str(path), "--hf-path",
                      str(tmp_path / "hf"), "--weight-dtype", "int8",
                      "--check-weight-parity")
    assert "weight parity: int8 == fake-quant reference for 2 requests" in out
    assert "weights=int8" in out


def test_generate_refuses_orbax_and_two_sources(tmp_path, capsys):
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(_GEN_CFG))
    mgr = jax_ckpt.CheckpointManager(str(tmp_path / "orbax"),
                                     async_save=False)
    mgr.save(3, {"w": jnp.zeros(4)}, {"m": jnp.zeros(4)}, trained_tokens=0)
    mgr.close()
    with pytest.raises(ValueError, match="holds an orbax checkpoint of the "
                                         "JAX package"):
        generate.main(["--config", str(path), "--load-path",
                       str(tmp_path / "orbax"), *_PROMPTS], device="cpu")
    with pytest.raises(SystemExit):
        generate.main(["--config", str(path), "--random-init", "--hf-path",
                       "x", *_PROMPTS], device="cpu")
    assert "exactly one of" in capsys.readouterr().err


# --------------------------------------------------------------------------- #
# imports
# --------------------------------------------------------------------------- #


def test_port_imports_no_file_library():
    """The card's machine has none of these: a fresh interpreter imports
    every port module and ``chip_smoke`` and finds none loaded, and no
    source line imports one."""
    pat = re.compile(r"^\s*(import|from)\s+(" + "|".join(FILE_LIBRARIES)
                     + r")(\.|\s|$)", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "picotron_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for name in ("checkpoint.py", os.path.join("resilience", "retry.py"),
                 os.path.join("resilience", "preemption.py")):
        assert os.path.join(REPO, "picotron_tpu_torch", name) in files
    for path in files:
        with open(path) as f:
            assert not pat.findall(f.read()), path
    mods = [os.path.relpath(p, REPO)[:-3].replace(os.sep, ".")
            for p in files if "picotron_tpu_torch" in p]
    mods = [m.removesuffix(".__init__") for m in mods]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "import chip_smoke\n"
            + f"bad = [m for m in sys.modules if m.split('.')[0] in "
              f"{FILE_LIBRARIES!r} or m.split('.')[0] in ('jax', "
              f"'picotron_tpu')]\n"
            + "print('BAD', bad)\nsys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode == 0, res.stdout + res.stderr
    assert len(mods) > 20
