"""Experiment configuration for the PyTorch port.

The same JSON files the JAX package reads (``configs/*/config.json``) load
here. Only the ``model`` and ``inference`` sections are read; every other
section, and every unknown key inside a section, is ignored, as
``picotron_tpu.config.Config.from_dict`` ignores unknown keys. Inference
options that select a path this port does not have yet (int8 weights or
cache, paged KV, speculation, overlap, mixed dispatch, dp sharding) are
refused when set to anything but their default, so a config never runs
silently without the behaviour it asks for.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any


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

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


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


# Inference options of the JAX package that this port does not implement
# yet, with the only value it accepts.
_UNPORTED_INFERENCE = {
    "weight_dtype": "bf16",
    "kv_cache_dtype": "auto",
    "kv_layout": "contiguous",
    "kv_page_policy": "uniform",
    "role": "both",
    "spec_len": 0,
    "dp_size": 1,
    "overlap": False,
    "mixed_dispatch": False,
    "sample_on_device": False,
}


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    inference: InferenceConfig = field(default_factory=InferenceConfig)

    def validate(self) -> None:
        m, inf = self.model, self.inference
        if m.num_attention_heads % m.num_key_value_heads != 0:
            raise ValueError("num_attention_heads must be a multiple of num_key_value_heads")
        if m.hidden_size % m.num_attention_heads != 0:
            raise ValueError("hidden_size must be divisible by num_attention_heads")
        if m.attention_impl not in ("auto", "sdpa", "flash"):
            raise ValueError(
                f"unknown attention_impl {m.attention_impl!r} (auto|sdpa|flash)")
        if inf.decode_block_len < 1:
            raise ValueError("inference.decode_block_len must be >= 1")
        if inf.prefill_chunk < 1:
            raise ValueError("inference.prefill_chunk must be >= 1")
        if inf.attend_impl not in ("dense", "flash"):
            raise ValueError(
                f"unknown inference.attend_impl {inf.attend_impl!r} "
                "(dense|flash)")

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
        cfg = cls(model=build(ModelConfig, raw.get("model", {})),
                  inference=build(InferenceConfig, inf_raw))
        cfg.validate()
        return cfg

    @classmethod
    def from_json(cls, path: str) -> "Config":
        with open(path) as f:
            return cls.from_dict(json.load(f))
