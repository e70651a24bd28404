"""Checkpoints of the PyTorch port: the safetensors format, read and written
here in plain Python, numpy and torch; HF-format interop; and the
trainer's own training checkpoint.

Port of ``picotron_tpu/checkpoint.py``, with no file library: the card's
machine has neither ``safetensors`` nor ``orbax``.

- **Safetensors** (``SafetensorsFile``, ``SafetensorsReader``,
  ``write_safetensors``): an 8-byte little-endian header length, a JSON
  header mapping each name to ``dtype``, ``shape`` and ``data_offsets``
  (relative to the start of the data) with an optional ``__metadata__``
  map, padded with spaces to a multiple of 8 bytes, then the tensors'
  bytes. BF16, F16, F32 and I8 are read and written, F64 is read too.
  Reads go by offset, one tensor at a time (the header is read at open),
  so the host holds about one layer; writes stream tensor by tensor.
- **HF interop** (after :585-935): ``load_hf_safetensors`` maps HF's
  per-layer ``(out, in)`` tensors onto the port's stacked ``(in, out)``
  tree (a tied model's missing ``lm_head`` becomes the embedding's
  transpose) and, for ``weight_dtype="int8"``, quantizes each matmul
  weight per output channel as it comes off the file;
  ``validate_hf_template`` checks names and shapes from the headers;
  ``save_hf_safetensors`` exports; ``model_config_from_hf`` reads a local
  ``config.json`` (the port never downloads).
- **Training checkpoints** (``CheckpointManager``, the counterpart of
  :120-575 in a format of its own): one directory per step,
  ``step_<n>/`` holding ``params.safetensors``, ``opt_state.safetensors``
  (``mu.<leaf>`` and ``nu.<leaf>``) and ``meta.json`` (step, trained
  tokens, the optimizer's count, the layer count, the loader's position
  and the format's version). A step is written under ``step_<n>.tmp/``,
  synced and renamed into place; the newest ``max_to_keep`` stay. A load
  falls back from a corrupt or partly written latest step to the one
  before it. Saves are synchronous, and there is no mirror tier
  (``Config.check_trainable`` refuses ``resilience.ckpt_mirror_dir``).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import struct
import warnings
from functools import partial
from typing import Optional

import numpy as np
import torch

from picotron_tpu_torch.config import ModelConfig
from picotron_tpu_torch.models import llama
from picotron_tpu_torch.ops import quant_matmul as qmm
from picotron_tpu_torch.resilience.retry import retry
from picotron_tpu_torch.train_step import param_leaves
from picotron_tpu_torch.utils import torch_dtype

# --------------------------------------------------------------------------- #
# the safetensors format
# --------------------------------------------------------------------------- #

DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16,
          "F32": torch.float32, "I8": torch.int8, "F64": torch.float64}
_WRITTEN = {torch.bfloat16: "BF16", torch.float16: "F16",
            torch.float32: "F32", torch.int8: "I8"}
# the safetensors library's own bound on the header
_MAX_HEADER = 100_000_000


def _read_header(f, file_size: int) -> tuple:
    """(tensors, metadata, data start) of an open safetensors file, with
    every entry checked against the file's size."""
    head = f.read(8)
    if len(head) != 8:
        raise ValueError(f"{f.name}: shorter than a safetensors header")
    (n,) = struct.unpack("<Q", head)
    if n > _MAX_HEADER or 8 + n > file_size:
        raise ValueError(f"{f.name}: header length {n} past the file's "
                         f"{file_size} bytes")
    header = json.loads(f.read(n).decode("utf-8"))
    if not isinstance(header, dict):
        raise ValueError(f"{f.name}: the header is not a JSON object")
    metadata = header.pop("__metadata__", None)
    data_len = file_size - 8 - n
    for name, info in header.items():
        dt = DTYPES.get(info.get("dtype"))
        if dt is None:
            raise ValueError(f"{f.name}: {name} has dtype "
                             f"{info.get('dtype')!r}, not one of "
                             f"{sorted(DTYPES)}")
        start, end = info["data_offsets"]
        numel = int(np.prod(info["shape"], dtype=np.int64))
        itemsize = torch.empty((), dtype=dt).element_size()
        if end - start != numel * itemsize or not 0 <= start <= end:
            raise ValueError(f"{f.name}: {name}'s offsets {start}..{end} "
                             f"do not hold shape {info['shape']} of "
                             f"{info['dtype']}")
        if end > data_len:
            raise ValueError(f"{f.name}: {name} ends at byte {end} of the "
                             f"data, which holds {data_len} (truncated)")
    return header, metadata, 8 + n


class SafetensorsFile:
    """One ``.safetensors`` file: the header is read at open, each tensor
    by its offset when asked for (a CPU tensor of the file's dtype)."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        try:
            self.tensors, self.metadata, self._start = _read_header(
                self._f, os.fstat(self._f.fileno()).st_size)
        except BaseException:
            self._f.close()
            raise

    def keys(self) -> list:
        return list(self.tensors)

    def get_shape(self, name: str) -> tuple:
        return tuple(self.tensors[name]["shape"])

    def get(self, name: str) -> torch.Tensor:
        info = self.tensors[name]
        start, end = info["data_offsets"]
        dt, shape = DTYPES[info["dtype"]], info["shape"]
        if end == start:
            return torch.empty(shape, dtype=dt)
        buf = bytearray(end - start)
        self._f.seek(self._start + start)
        if self._f.readinto(buf) != len(buf):
            raise ValueError(f"{self.path}: {name} is truncated")
        # numpy has no bf16: the bytes become a torch tensor directly
        return torch.frombuffer(buf, dtype=dt).reshape(shape)

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_safetensors(path: str, tensors: dict) -> int:
    """Write ``tensors`` (name -> tensor on any device) to ``path`` in the
    safetensors format, one tensor at a time (each is copied to the host
    alone), and sync the file. Returns the bytes written."""
    header, offset = {}, 0
    for name, t in tensors.items():
        if t.dtype not in _WRITTEN:
            raise ValueError(f"{name}: dtype {t.dtype} is not written "
                             f"(BF16, F16, F32 or I8)")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _WRITTEN[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in tensors.values():
            host = t.detach().contiguous().cpu().reshape(-1)
            f.write(host.view(torch.uint8).numpy().data)
        f.flush()
        os.fsync(f.fileno())
    return 8 + len(raw) + offset


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class SafetensorsReader:
    """One reader over a ``.safetensors`` file, a directory holding
    ``model.safetensors``, or a sharded directory with
    ``model.safetensors.index.json`` (its ``weight_map``), as
    ``picotron_tpu/checkpoint.py:603`` reads them. File opens are retried;
    open files are kept until ``close``."""

    def __init__(self, path: str, io_attempts: int = 3,
                 io_backoff: float = 0.5, io_jitter: float = 0.25):
        self._retry = partial(retry, attempts=io_attempts,
                              backoff=io_backoff, jitter=io_jitter)
        self._files: dict = {}
        self.index = None
        if os.path.isfile(path):
            self._single = path
        else:
            index_file = os.path.join(path, "model.safetensors.index.json")
            single = os.path.join(path, "model.safetensors")
            if os.path.exists(index_file):
                with open(index_file) as f:
                    self.index = json.load(f)["weight_map"]
                self._dir = path
            elif os.path.exists(single):
                self._single = single
            else:
                raise FileNotFoundError(
                    f"no model.safetensors[.index.json] under {path}")
        self.names = (set(self.index) if self.index is not None
                      else set(self._file(self._single).keys()))

    def _file(self, fpath: str) -> SafetensorsFile:
        if fpath not in self._files:
            self._files[fpath] = self._retry(
                lambda: SafetensorsFile(fpath),
                desc=f"open {os.path.basename(fpath)}")
        return self._files[fpath]

    def _file_for(self, name: str) -> SafetensorsFile:
        if self.index is None:
            return self._file(self._single)
        return self._file(os.path.join(self._dir, self.index[name]))

    def get(self, name: str) -> torch.Tensor:
        return self._file_for(name).get(name)

    def get_shape(self, name: str) -> tuple:
        """From the header alone: no tensor byte is read."""
        return self._file_for(name).get_shape(name)

    def close(self) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# --------------------------------------------------------------------------- #
# HF interop
# --------------------------------------------------------------------------- #

# the port's stacked leaf -> (HF per-layer name, transposed?): HF linear
# weights are (out, in), the port's (in, out). The JAX package's map.
_LAYER_MAP = {
    "attn_norm": ("model.layers.{i}.input_layernorm.weight", False),
    "wq": ("model.layers.{i}.self_attn.q_proj.weight", True),
    "wk": ("model.layers.{i}.self_attn.k_proj.weight", True),
    "wv": ("model.layers.{i}.self_attn.v_proj.weight", True),
    "wo": ("model.layers.{i}.self_attn.o_proj.weight", True),
    "mlp_norm": ("model.layers.{i}.post_attention_layernorm.weight", False),
    "w_gate": ("model.layers.{i}.mlp.gate_proj.weight", True),
    "w_up": ("model.layers.{i}.mlp.up_proj.weight", True),
    "w_down": ("model.layers.{i}.mlp.down_proj.weight", True),
}
_TOP_MAP = {
    "embed": ("model.embed_tokens.weight", False),
    "final_norm": ("model.norm.weight", False),
    "lm_head": ("lm_head.weight", True),
}


def param_shapes(m: ModelConfig) -> dict:
    """The port's parameter tree for ``m`` with each leaf's shape in place
    of its tensor (``llama.init_params``'s layout)."""
    H, I_, V, L = (m.hidden_size, m.intermediate_size, m.vocab_size,
                   m.num_hidden_layers)
    Hq = m.num_attention_heads * m.head_dim
    Hkv = m.num_key_value_heads * m.head_dim
    layer = {"attn_norm": (H,), "wq": (H, Hq), "wk": (H, Hkv),
             "wv": (H, Hkv), "wo": (Hq, H), "mlp_norm": (H,),
             "w_gate": (H, I_), "w_up": (H, I_), "w_down": (I_, H)}
    return {"embed": (V, H), "layers": {k: (L, *s) for k, s in layer.items()},
            "final_norm": (H,), "lm_head": (H, V)}


def leaf_names(tree: dict, prefix: str = "") -> list:
    """Dotted leaf names (``"layers.wq"``) in ``param_leaves`` order."""
    out = []
    for key in sorted(tree):
        v = tree[key]
        out.extend(leaf_names(v, f"{prefix}{key}.") if isinstance(v, dict)
                   else [prefix + key])
    return out


def load_hf_safetensors(path: str, m: ModelConfig,
                        dtype: Optional[str] = None,
                        weight_dtype: Optional[str] = None, device=None,
                        io_attempts: int = 3, io_backoff: float = 0.5,
                        io_jitter: float = 0.25) -> dict:
    """The port's parameter tree from an HF-format Llama checkpoint (a
    ``.safetensors`` file, or a directory holding one or a sharded set),
    on ``device`` (default the CPU) in ``dtype`` (default the model's).

    Each HF tensor is read alone, transposed to ``(in, out)`` where HF
    keeps ``(out, in)``, cast and copied into its row of the stacked
    ``[L, ...]`` leaf on the device. A file without ``lm_head.weight``
    (tied embeddings) gets the embedding's transpose as its head.
    ``weight_dtype="int8"`` quantizes each matmul weight per output
    channel as it comes off the file, after the cast to the model dtype
    (``quant_matmul.quantize_weight_host``), so the host holds one
    layer's copy; the embedding and the norms stay full precision."""
    if weight_dtype not in (None, "bf16", "int8"):
        raise ValueError(
            f"unknown weight_dtype {weight_dtype!r} (bf16|int8)")
    quant = weight_dtype == "int8"
    dt = torch_dtype(dtype or m.dtype)
    device = torch.device(device if device is not None else "cpu")
    L = m.num_hidden_layers

    with SafetensorsReader(path, io_attempts, io_backoff,
                           io_jitter) as reader:

        def grab(name: str, transpose: bool) -> torch.Tensor:
            t = reader.get(name).to(device=device, dtype=dt)
            return t.T if transpose else t

        def host_quant(w: torch.Tensor) -> dict:
            # w in the model dtype; numpy has no bf16, fp32 holds it
            # exactly. Row-major, so q and s come out row-major too (the
            # card's kernel G takes contiguous operands)
            return qmm.quantize_weight_host(
                w.float().cpu().contiguous().numpy())

        def layers(k: str, tmpl: str, tr: bool):
            out = None
            for i in range(L):
                name = tmpl.format(i=i)
                if quant and k in llama.QUANT_WEIGHT_LEAVES:
                    w = reader.get(name).to(dt)
                    qs = host_quant(w.T if tr else w)
                    if out is None:
                        out = {"q": torch.empty((L, *qs["q"].shape),
                                                dtype=torch.int8,
                                                device=device),
                               "s": torch.empty((L, *qs["s"].shape),
                                                dtype=qmm.SCALE_DTYPE,
                                                device=device)}
                    out["q"][i].copy_(torch.from_numpy(qs["q"]))
                    out["s"][i].copy_(torch.from_numpy(qs["s"]))
                    continue
                t = grab(name, tr)
                if out is None:
                    out = torch.empty((L, *t.shape), dtype=dt, device=device)
                out[i].copy_(t)
            return out

        params = {
            "embed": grab(*_TOP_MAP["embed"]),
            "layers": {k: layers(k, tmpl, tr)
                       for k, (tmpl, tr) in _LAYER_MAP.items()},
            "final_norm": grab(*_TOP_MAP["final_norm"]),
        }
        tied = _TOP_MAP["lm_head"][0] not in reader.names
        if quant:
            head = (params["embed"].T if tied
                    else reader.get(_TOP_MAP["lm_head"][0]).to(dt).T)
            qs = host_quant(head)
            params["lm_head"] = {k: torch.from_numpy(v).to(device)
                                 for k, v in qs.items()}
        elif tied:
            # tied embeddings: untie by the embedding's transpose, which
            # keeps the tied model's function
            params["lm_head"] = params["embed"].T.contiguous()
        else:
            params["lm_head"] = grab(*_TOP_MAP["lm_head"]).contiguous()
    return params


def validate_hf_template(path: str, m: ModelConfig) -> None:
    """Check an HF safetensors checkpoint against the model config from
    the headers alone (names and shapes; no tensor byte is read). A
    missing ``lm_head.weight`` is allowed (tied embeddings)."""
    ours = param_shapes(m)

    def hf_shape(shape, transpose):
        return tuple(reversed(shape)) if transpose else tuple(shape)

    want = {tmpl: hf_shape(ours[k], tr) for k, (tmpl, tr) in _TOP_MAP.items()}
    for k, (tmpl, tr) in _LAYER_MAP.items():
        for i in range(m.num_hidden_layers):
            want[tmpl.format(i=i)] = hf_shape(ours["layers"][k][1:], tr)
    optional = {_TOP_MAP["lm_head"][0]}

    with SafetensorsReader(path) as reader:
        missing = sorted(set(want) - reader.names - optional)
        if missing:
            raise ValueError(
                f"{path} does not match the model config: missing tensors "
                f"{missing[:5]}{'...' if len(missing) > 5 else ''}")
        for name in sorted(set(want) & reader.names):
            got = reader.get_shape(name)
            if got != want[name]:
                raise ValueError(
                    f"{path} does not match the model config: {name} has "
                    f"shape {got}, expected {want[name]}")


def save_hf_safetensors(params: dict, path: str, io_attempts: int = 3,
                        io_backoff: float = 0.5,
                        io_jitter: float = 0.25) -> int:
    """Export the port's tree to one HF-format safetensors file, in the
    leaves' dtype, streamed tensor by tensor (each HF tensor is a
    transposed view of one stacked row, copied to the host alone) under a
    temporary name that is renamed into place. Returns the bytes written.

    The port trains at pp = 1, so its stack is the plain ``[L, ...]``
    layout; a stack with an all-zero ``attn_norm`` row (a pipeline pad
    row) is refused, and so are int8 leaves (a lossy serving format)."""
    if qmm.is_quant_weight(params.get("lm_head")) or any(
            qmm.is_quant_weight(v) for v in params.get("layers", {}).values()):
        raise ValueError(
            "int8-quantized params cannot be exported to HF safetensors "
            "(quantization is a lossy serving format); export from the "
            "full-precision source checkpoint instead")
    norms = params["layers"]["attn_norm"]
    if not bool((norms != 0).any(dim=-1).all()):
        raise ValueError(
            "layer stack contains all-zero (pad) rows: this is not a plain "
            "[num_layers, ...] stack of the port's single-device trainer")
    out = {}
    for k, (tmpl, tr) in _TOP_MAP.items():
        out[tmpl] = params[k].T if tr else params[k]
    for k, (tmpl, tr) in _LAYER_MAP.items():
        for i in range(norms.shape[0]):
            row = params["layers"][k][i]
            out[tmpl.format(i=i)] = row.T if tr else row
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"

    def write():
        n = write_safetensors(tmp, out)
        os.replace(tmp, path)
        return n

    return retry(write, attempts=io_attempts, backoff=io_backoff,
                 jitter=io_jitter, desc=f"export {os.path.basename(path)}")


_HF_CONFIG_KEYS = (
    "num_hidden_layers", "num_attention_heads", "num_key_value_heads",
    "hidden_size", "intermediate_size", "vocab_size", "rms_norm_eps",
    "rope_theta", "max_position_embeddings",
)


def model_config_from_hf(path: str) -> dict:
    """An HF ``config.json`` (the file, or a directory holding it) in the
    ``ModelConfig`` field names. Local files only: a hub name would need a
    download, which the port never makes."""
    cfg_path = path if path.endswith(".json") else os.path.join(
        path, "config.json")
    if not os.path.exists(cfg_path):
        raise FileNotFoundError(
            f"no config.json at {cfg_path}: the PyTorch port reads a local "
            f"HF config only (a hub model name would need a download, "
            f"which it does not make); pass the config.json or its "
            f"directory")
    with open(cfg_path) as f:
        hf = json.load(f)
    return {k: hf[k] for k in _HF_CONFIG_KEYS if k in hf}


# --------------------------------------------------------------------------- #
# training checkpoints
# --------------------------------------------------------------------------- #

FORMAT = "picotron_tpu_torch.checkpoint"
FORMAT_VERSION = 1
_STEP_DIR = re.compile(r"^step_(\d+)$")


class CheckpointMismatch(ValueError):
    """A readable checkpoint that does not fit this run's model: a config
    error, which no older step can fix."""


class CheckpointManager:
    """Save and resume of (params, opt_state, step, trained tokens) under
    ``save_dir``: ``save`` every ``save_frequency`` steps, ``load`` the
    newest readable step (see the module docstring for the layout)."""

    def __init__(self, save_dir: str, max_to_keep: int = 3,
                 io_attempts: int = 3, io_backoff: float = 0.5,
                 io_jitter: float = 0.25):
        self.directory = os.path.abspath(save_dir)
        self._max_to_keep = max_to_keep
        self._retry = partial(retry, attempts=io_attempts, backoff=io_backoff,
                              jitter=io_jitter)
        # (step, meta) of the checkpoint the last load restored: after a
        # fallback from a corrupt latest step, not the latest
        self.last_restored_step: Optional[int] = None
        self.last_restored_meta: Optional[dict] = None

    def step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}")

    def all_steps(self) -> list:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(m.group(1)) for m in map(_STEP_DIR.match,
                                                   os.listdir(self.directory))
                      if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, params: dict, opt_state: dict,
             trained_tokens: int, data_meta: Optional[dict] = None) -> int:
        """Write step ``step`` (synchronously) and prune to the newest
        ``max_to_keep``. ``data_meta`` is the loader's position and
        geometry (``MicroBatchDataLoader.state_meta``), which a resume
        verifies. Returns the bytes written."""
        names = leaf_names(params)
        leaves = param_leaves(params)
        meta = {"format": FORMAT, "version": FORMAT_VERSION,
                "step": int(step), "trained_tokens": int(trained_tokens),
                "count": int(opt_state["count"]),
                "num_hidden_layers": int(params["layers"]["attn_norm"]
                                         .shape[0])}
        if data_meta is not None:
            meta["data"] = dict(data_meta)
        moments = {f"{which}.{name}": t
                   for which in ("mu", "nu")
                   for name, t in zip(names, opt_state[which])}
        final = self.step_dir(step)
        tmp = final + ".tmp"

        def write() -> int:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            n = write_safetensors(os.path.join(tmp, "params.safetensors"),
                                  dict(zip(names, leaves)))
            n += write_safetensors(os.path.join(tmp, "opt_state.safetensors"),
                                   moments)
            raw = json.dumps(meta, indent=1).encode()
            with open(os.path.join(tmp, "meta.json"), "wb") as f:
                f.write(raw)
                f.flush()
                os.fsync(f.fileno())
            _fsync_dir(tmp)
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
            _fsync_dir(self.directory)
            return n + len(raw)

        os.makedirs(self.directory, exist_ok=True)
        nbytes = self._retry(write, desc=f"save step {step}")
        for old in self.all_steps()[:-self._max_to_keep]:
            shutil.rmtree(self.step_dir(old), ignore_errors=True)
        return nbytes

    def _read_meta(self, step: int) -> dict:
        with open(os.path.join(self.step_dir(step), "meta.json")) as f:
            meta = json.load(f)
        if meta.get("format") != FORMAT or meta.get("version") != \
                FORMAT_VERSION:
            raise ValueError(f"step {step}: not a {FORMAT} version "
                             f"{FORMAT_VERSION} checkpoint")
        return meta

    def _candidate_steps(self, step: Optional[int]) -> list:
        """Steps to try, newest first; an explicit ``step`` alone (the
        caller asked for exactly that state)."""
        steps = self.all_steps()
        if not steps and os.path.isdir(self.directory):
            orbax = sorted(d for d in os.listdir(self.directory)
                           if d.isdigit())
            if orbax:
                raise ValueError(
                    f"{self.directory} holds an orbax checkpoint of the JAX "
                    f"package (steps {orbax}), which the PyTorch port "
                    f"cannot read without jax; export its weights with "
                    f"picotron_tpu.checkpoint.save_hf_safetensors and load "
                    f"that file (generate --hf-path, or "
                    f"checkpoint.hf_bootstrap_path)")
        if step is not None:
            return [step]
        return steps[::-1]

    def _fallback_restore(self, step: Optional[int], guards, restore):
        """Try each candidate step, newest first: read its meta (retried),
        run ``guards(meta)`` (a config error propagates), then
        ``restore(step, meta)`` (retried; a failure means a corrupt or
        partial step: warn and fall back). Returns the meta restored."""
        last_err = None
        tried = []
        for s in self._candidate_steps(step):
            tried.append(s)
            where = self.step_dir(s)
            try:
                meta = self._retry(partial(self._read_meta, s),
                                   desc=f"read meta step {s}")
            except Exception as e:
                last_err = e
                warnings.warn(
                    f"checkpoint step {s} in {self.directory} has "
                    f"unreadable metadata ({type(e).__name__}: {e}); "
                    f"falling back to the previous step", RuntimeWarning)
                continue
            guards(meta)
            try:
                self._retry(partial(restore, where, meta),
                            desc=f"restore step {s}")
            except CheckpointMismatch:
                raise
            except Exception as e:
                last_err = e
                warnings.warn(
                    f"checkpoint step {s} in {self.directory} is corrupt or "
                    f"partially written ({type(e).__name__}: {e}); falling "
                    f"back to the previous step", RuntimeWarning)
                continue
            self.last_restored_step, self.last_restored_meta = s, meta
            return meta
        if not tried:
            raise FileNotFoundError(
                f"no checkpoint found in {self.directory}") from last_err
        raise FileNotFoundError(
            f"no readable checkpoint in {self.directory} (tried steps "
            f"{tried})") from last_err

    @staticmethod
    def _check(f: SafetensorsFile, want: dict, what: str) -> None:
        """Names and shapes of a step's file against this run's."""
        got = {k: f.get_shape(k) for k in f.keys()}
        want = {k: tuple(s) for k, s in want.items()}
        if got != want:
            diff = sorted(k for k in set(got) | set(want)
                          if got.get(k) != want.get(k))
            raise CheckpointMismatch(
                f"{f.path}: the {what} do not fit this model: "
                + ", ".join(f"{k} saved {got.get(k)} here {want.get(k)}"
                            for k in diff[:5]))

    def load(self, params: dict, opt_state: dict,
             step: Optional[int] = None) -> tuple:
        """Restore the newest readable step (or exactly ``step``) into
        ``params`` and ``opt_state`` in place, on their devices and in
        their dtypes. Returns ``(params, opt_state, step,
        trained_tokens)``; the step restored is also ``last_restored_step``
        (with its meta in ``last_restored_meta``). Raises
        ``FileNotFoundError`` when no step is readable."""
        names = leaf_names(params)
        leaves = param_leaves(params)
        L = params["layers"]["attn_norm"].shape[0]

        def guards(meta):
            if int(meta["num_hidden_layers"]) != L:
                raise CheckpointMismatch(
                    f"checkpoint has {meta['num_hidden_layers']} layers, "
                    f"config wants {L}")

        def restore(where, meta):
            with SafetensorsFile(os.path.join(
                    where, "params.safetensors")) as fp, SafetensorsFile(
                    os.path.join(where, "opt_state.safetensors")) as fo:
                self._check(fp, {n: p.shape for n, p in zip(names, leaves)},
                            "parameters")
                self._check(fo, {f"{w}.{n}": p.shape for w in ("mu", "nu")
                                 for n, p in zip(names, leaves)},
                            "optimizer moments")
                with torch.no_grad():
                    for i, (n, p) in enumerate(zip(names, leaves)):
                        p.copy_(fp.get(n))
                        opt_state["mu"][i].copy_(fo.get(f"mu.{n}"))
                        opt_state["nu"][i].copy_(fo.get(f"nu.{n}"))
            opt_state["count"] = int(meta["count"])

        meta = self._fallback_restore(step, guards, restore)
        return (params, opt_state, int(meta["step"]),
                int(meta["trained_tokens"]))

    def load_params(self, m: ModelConfig, step: Optional[int] = None,
                    device=None, weight_dtype: str = "bf16") -> tuple:
        """The parameters alone (the serving path: no optimizer moment is
        read), cast to the model dtype on ``device`` (default the CPU).
        ``weight_dtype="int8"`` quantizes every matmul weight per output
        channel after the restore (``llama.quantize_params``, a layer at a
        time), as the JAX package's ``load_params`` does. Returns
        ``(params, step, trained_tokens)``, with the corrupt-latest
        fallback of ``load``."""
        if weight_dtype not in ("bf16", "int8"):
            raise ValueError(
                f"unknown weight_dtype {weight_dtype!r} (bf16|int8)")
        shapes = param_shapes(m)
        names = leaf_names(shapes)
        dt = torch_dtype(m.dtype)
        device = torch.device(device if device is not None else "cpu")
        out: dict = {}

        def guards(meta):
            if int(meta["num_hidden_layers"]) != m.num_hidden_layers:
                raise CheckpointMismatch(
                    f"checkpoint has {meta['num_hidden_layers']} layers, "
                    f"config wants {m.num_hidden_layers}")

        def restore(where, meta):
            out.clear()
            with SafetensorsFile(os.path.join(where,
                                              "params.safetensors")) as fp:
                self._check(fp, dict(zip(names, param_leaves(shapes))),
                            "parameters")
                for n in names:
                    w = fp.get(n).to(device=device, dtype=dt)
                    node = out
                    *path, leaf = n.split(".")
                    for key in path:
                        node = node.setdefault(key, {})
                    node[leaf] = w

        meta = self._fallback_restore(step, guards, restore)
        params = dict(out)
        if weight_dtype == "int8":
            params = llama.quantize_params(params)
        return params, int(meta["step"]), int(meta["trained_tokens"])
