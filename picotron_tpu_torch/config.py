"""Experiment configuration for the PyTorch port.

The same JSON files the JAX package reads (``configs/*/config.json``) load
here, with the JAX package's field names, defaults and validation
messages for what the port reads: ``distributed``, ``model``,
``training``, ``dataset``, ``checkpoint``, ``logging``, ``resilience``,
``obs`` and ``inference``. Every unknown key is ignored, as
``picotron_tpu.config.Config.from_dict`` ignores unknown keys.

``distributed.use_cpu`` asks the JAX package for a CPU mesh; the port
ignores it. The port's entry points run on the CUDA card unless their
caller passes ``device="cpu"``.

Options that select a path this port does not have yet are refused, so a
config never runs silently without the behaviour it asks for:

- inference options (paged KV and its ``hot_bf16`` page policy,
  speculation, overlap, mixed dispatch, dp sharding) when set to anything
  but their default, at load;
- for training, ``Config.check_trainable`` (called by the trainer): any
  parallelism (dp, tp, pp or cp above 1, zero1, fsdp), ``remat``
  ``"save_attn"`` and ``"offload"``, HF datasets, checkpoint saving,
  loading and HF bootstrap, ``steps_per_call`` above 1, and the
  resilience, observability, wandb and profiling features of the JAX
  trainer. A serving run of a multi-device config still loads.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass
class DistributedConfig:
    """Topology sizes. The port trains and serves on one device
    (``check_trainable`` refuses any size above 1)."""

    tp_size: int = 1
    cp_size: int = 1
    pp_size: int = 1
    dp_size: int = 1
    zero1: bool = False
    fsdp: bool = False


@dataclass
class ModelConfig:
    name: str = "HuggingFaceTB/SmolLM-1.7B"
    num_hidden_layers: int = 24
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    hidden_size: int = 2048
    intermediate_size: int = 8192
    vocab_size: int = 49152
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    max_position_embeddings: int = 2048
    dtype: str = "bfloat16"  # compute/param dtype
    # "auto": the flash-attention kernel for CUDA tensors, the plain sdpa
    # for CPU tensors; "flash" / "sdpa" force one (on the CPU "flash" runs
    # the kernel's plain version)
    attention_impl: str = "auto"
    # the RMSNorm kernels (A forward, D backward): None = for CUDA tensors,
    # the plain version for CPU tensors; True = always (on the CPU the
    # kernels' plain versions, through the same autograd Function); False
    # = the plain version with torch autograd
    use_pallas_rmsnorm: Optional[bool] = None
    # training loss: "auto" (= fused), "fused" (row-chunked linear + CE),
    # "gathered" (materialised logits + plain CE); "vocab_parallel" is the
    # gathered path, since the two are the same at tp = 1
    loss_impl: str = "auto"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


@dataclass
class TrainingConfig:
    seed: int = 42
    learning_rate: float = 3e-4
    # "constant" | "cosine" | "linear", with optional linear warmup from 0
    # over lr_warmup_steps; decay runs to learning_rate * lr_min_ratio over
    # lr_decay_steps (default total_train_steps)
    lr_schedule: str = "constant"
    lr_warmup_steps: int = 0
    lr_min_ratio: float = 0.0
    lr_decay_steps: Optional[int] = None
    weight_decay: float = 0.01
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_eps: float = 1e-8
    grad_clip: float = 0.0  # 0 = off
    total_train_steps: int = 100
    seq_length: int = 1024
    micro_batch_size: int = 1
    gradient_accumulation_steps: int = 1
    max_tokens: Optional[int] = None
    num_samples: Optional[int] = None  # first N packed synthetic samples
    steps_per_call: int = 1  # the port runs one step per call
    # "full": recompute every decoder layer in the backward
    # (torch.utils.checkpoint); "none": keep every intermediate
    remat: str = "full"
    # gradients accumulate over micro-batches in "float32" or "param" dtype
    grad_accum_dtype: str = "float32"


@dataclass
class DatasetConfig:
    name: str = "synthetic"  # the port has the synthetic source only


@dataclass
class CheckpointConfig:
    """Read only so that ``check_trainable`` can refuse checkpointing,
    which the port does not have yet."""

    save_frequency: int = 0  # 0 = disabled
    load_path: str = ""
    hf_bootstrap_path: str = ""


@dataclass
class LoggingConfig:
    log_frequency: int = 1
    # read only so that ``check_trainable`` can refuse them
    use_wandb: bool = False
    profile_start: int = 0


@dataclass
class ResilienceConfig:
    """The one resilience feature the port has: the non-finite gate (a
    step with a non-finite loss or gradient norm changes neither the
    parameters nor the optimizer state). The other fields are read only
    so that ``check_trainable`` can refuse a config that turns them on."""

    nonfinite_guard: bool = True
    anomaly_policy: str = "skip"
    heartbeat_path: str = ""
    chaos_raise_step: int = 0
    chaos_nan_step: int = 0
    chaos_sigterm_step: int = 0
    chaos_truncate_step: int = 0


@dataclass
class ObsConfig:
    """Read only so that ``check_trainable`` can refuse the JAX trainer's
    telemetry outputs, which the port does not write."""

    metrics_jsonl: str = ""
    trace_path: str = ""


@dataclass
class InferenceConfig:
    """Serving knobs of the ported slice (picotron_tpu_torch/inference/)."""

    # Autoregressive steps run per decode_block call: per-slot EOS/budget
    # stop state lives on the device, so the host syncs once per block.
    decode_block_len: int = 8
    # Prompts longer than this prefill as fixed-width chunks written
    # straight into the slot (engine.prefill_chunked).
    prefill_chunk: int = 512
    # KV-cache attention on the decode / chunked-prefill path: "dense" =
    # the masked whole-window reference (kv_cache.decode_attention);
    # "flash" = the length-aware flash-decode kernel.
    attend_impl: str = "dense"
    # Weight storage: "bf16" = the dense tree; "int8" = per-output-channel
    # int8 matmul weights (llama.quantize_params) served through kernel G.
    weight_dtype: str = "bf16"
    # KV-cache storage: "auto" = the model dtype; "int8" = absmax int8 rows
    # with fp32 per-row scales (kv_cache.py), read by C's int8 variant.
    kv_cache_dtype: str = "auto"


# Inference options of the JAX package that this port does not implement
# yet, with the only value it accepts.
_UNPORTED_INFERENCE = {
    "kv_layout": "contiguous",
    "kv_page_policy": "uniform",
    "role": "both",
    "spec_len": 0,
    "dp_size": 1,
    "overlap": False,
    "mixed_dispatch": False,
    "sample_on_device": False,
}


# (section, field, the only value the port's trainer takes): options of
# the JAX trainer that select a path this port does not have yet
_UNPORTED_TRAINING = (
    ("distributed", "zero1", False),
    ("distributed", "fsdp", False),
    ("training", "steps_per_call", 1),
    ("checkpoint", "save_frequency", 0),
    ("checkpoint", "load_path", ""),
    ("checkpoint", "hf_bootstrap_path", ""),
    ("logging", "use_wandb", False),
    ("logging", "profile_start", 0),
    ("resilience", "anomaly_policy", "skip"),
    ("resilience", "heartbeat_path", ""),
    ("resilience", "chaos_raise_step", 0),
    ("resilience", "chaos_nan_step", 0),
    ("resilience", "chaos_sigterm_step", 0),
    ("resilience", "chaos_truncate_step", 0),
    ("obs", "metrics_jsonl", ""),
    ("obs", "trace_path", ""),
)


@dataclass
class Config:
    distributed: DistributedConfig = field(default_factory=DistributedConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)
    logging: LoggingConfig = field(default_factory=LoggingConfig)
    resilience: ResilienceConfig = field(default_factory=ResilienceConfig)
    obs: ObsConfig = field(default_factory=ObsConfig)
    inference: InferenceConfig = field(default_factory=InferenceConfig)

    @property
    def global_batch_size(self) -> int:
        """micro_batch * grad_acc * dp."""
        t = self.training
        return (t.micro_batch_size * t.gradient_accumulation_steps
                * self.distributed.dp_size)

    @property
    def tokens_per_step(self) -> int:
        return self.global_batch_size * self.training.seq_length

    def check_trainable(self) -> None:
        """Refuse, with a clear message, a config whose training asks for
        something the port does not have yet (see the module docstring),
        or a sequence longer than the model's positions (a JAX load-time
        check; here a training-time one, since a serving config may leave
        ``training`` at its defaults)."""
        t, m = self.training, self.model
        if t.seq_length > m.max_position_embeddings:
            raise ValueError(
                f"seq_length {t.seq_length} > max_position_embeddings "
                f"{m.max_position_embeddings}")
        d = self.distributed
        sizes = {"dp_size": d.dp_size, "tp_size": d.tp_size,
                 "pp_size": d.pp_size, "cp_size": d.cp_size}
        for name, n in sizes.items():
            if n != 1:
                raise ValueError(
                    f"distributed.{name}={n}: the PyTorch port trains on one "
                    f"device only (dp = tp = pp = cp = 1); parallel training "
                    f"is not ported yet")
        if self.training.remat not in ("none", "full"):
            raise ValueError(
                f"training.remat={self.training.remat!r} is not in the "
                f"PyTorch port yet (it trains with remat 'none' or 'full')")
        if self.dataset.name != "synthetic":
            raise ValueError(
                f"dataset.name={self.dataset.name!r}: HF datasets are not in "
                f"the PyTorch port yet (it trains on 'synthetic' only)")
        for section, name, only in _UNPORTED_TRAINING:
            value = getattr(getattr(self, section), name)
            if value != only:
                raise ValueError(
                    f"{section}.{name}={value!r} is not in the PyTorch port "
                    f"yet (its trainer takes {name}={only!r} only)")

    def validate(self) -> None:
        """The JAX package's checks, with its messages, for the fields the
        port reads."""
        m, inf, t = self.model, self.inference, self.training
        if m.num_attention_heads % m.num_key_value_heads != 0:
            raise ValueError("num_attention_heads must be a multiple of num_key_value_heads")
        if m.hidden_size % m.num_attention_heads != 0:
            raise ValueError("hidden_size must be divisible by num_attention_heads")
        if m.attention_impl not in ("auto", "sdpa", "flash"):
            raise ValueError(
                f"unknown attention_impl {m.attention_impl!r} (auto|sdpa|flash)")
        if m.loss_impl not in ("auto", "fused", "gathered", "vocab_parallel"):
            raise ValueError(
                f"unknown loss_impl {m.loss_impl!r} "
                "(auto|fused|gathered|vocab_parallel)")
        if t.steps_per_call < 1:
            raise ValueError("steps_per_call must be >= 1")
        if t.num_samples is not None and t.num_samples < 1:
            raise ValueError("num_samples must be >= 1 when set")
        if t.lr_schedule not in ("constant", "cosine", "linear"):
            raise ValueError(
                f"unknown lr_schedule {t.lr_schedule!r} (constant|cosine|linear)")
        if t.lr_warmup_steps < 0:
            raise ValueError("lr_warmup_steps must be >= 0")
        if not 0.0 <= t.lr_min_ratio <= 1.0:
            raise ValueError("lr_min_ratio must be in [0, 1]")
        if t.lr_decay_steps is not None and t.lr_decay_steps <= 0:
            raise ValueError("lr_decay_steps must be > 0 when set")
        if t.lr_schedule in ("cosine", "linear"):
            horizon = (t.lr_decay_steps if t.lr_decay_steps is not None
                       else t.total_train_steps)
            if horizon <= t.lr_warmup_steps:
                which = ("lr_decay_steps" if t.lr_decay_steps is not None
                         else "total_train_steps")
                raise ValueError(
                    f"{which} ({horizon}) must exceed lr_warmup_steps "
                    f"({t.lr_warmup_steps}) for a decaying schedule")
        if t.remat not in ("none", "full", "save_attn", "offload"):
            raise ValueError(
                f"unknown remat {t.remat!r} (none|full|save_attn|offload)")
        if t.grad_accum_dtype not in ("float32", "param"):
            raise ValueError(
                f"unknown grad_accum_dtype {t.grad_accum_dtype!r} (float32|param)")
        if self.resilience.anomaly_policy not in ("skip", "rollback", "abort"):
            raise ValueError(
                f"unknown anomaly_policy {self.resilience.anomaly_policy!r} "
                "(skip|rollback|abort)")
        if inf.decode_block_len < 1:
            raise ValueError("inference.decode_block_len must be >= 1")
        if inf.prefill_chunk < 1:
            raise ValueError("inference.prefill_chunk must be >= 1")
        if inf.attend_impl not in ("dense", "flash"):
            raise ValueError(
                f"unknown inference.attend_impl {inf.attend_impl!r} "
                "(dense|flash)")
        if inf.weight_dtype not in ("bf16", "int8"):
            raise ValueError(
                f"unknown inference.weight_dtype {inf.weight_dtype!r} "
                "(bf16|int8) — set 'int8' for per-channel quantized "
                "weights served through the fused dequant matmul, or "
                "keep the 'bf16' full-precision default")
        if inf.kv_cache_dtype not in ("auto", "int8"):
            raise ValueError(
                f"unknown inference.kv_cache_dtype {inf.kv_cache_dtype!r} "
                "(auto|int8)")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, raw: dict[str, Any]) -> "Config":
        def build(dc, section: dict):
            known = {f.name for f in dataclasses.fields(dc)}
            return dc(**{k: v for k, v in section.items() if k in known})

        inf_raw = raw.get("inference") or {}
        for name, only in _UNPORTED_INFERENCE.items():
            if name in inf_raw and inf_raw[name] != only:
                raise ValueError(
                    f"inference.{name}={inf_raw[name]!r} is not in the "
                    f"PyTorch port yet (it serves {name}={only!r} only)")
        sections = {f.name: f.default_factory for f in dataclasses.fields(cls)}
        cfg = cls(**{name: build(dc, raw.get(name) or {})
                     for name, dc in sections.items()})
        cfg.validate()
        return cfg

    @classmethod
    def from_json(cls, path: str) -> "Config":
        with open(path) as f:
            return cls.from_dict(json.load(f))
