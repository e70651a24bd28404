"""Experiment configuration for the PyTorch port.

The same JSON files the JAX package reads (``configs/*/config.json``) load
here, with the JAX package's field names, defaults and validation
messages for what the port reads: ``distributed``, ``model``,
``training``, ``dataset``, ``checkpoint``, ``logging``, ``resilience``,
``obs`` and ``inference``. A key that is no field of the JAX package's
``Config`` either is ignored, as ``picotron_tpu.config.Config.from_dict``
ignores unknown keys.

Every field of the JAX package's ``Config`` is one of three things here,
and ``tests/test_torch_config.py`` holds the port to it:

- declared by a section below and read;
- refused at load when set to a value the port does not behave as
  (``REFUSED_AT_LOAD``): dp sharding;
- inert (``INERT_FIELDS``, each with its reason): the field changes
  nothing while the port runs as it does, for example
  ``distributed.use_cpu`` (the port runs on the card unless its caller
  passes ``device="cpu"``), ``pp_engine`` (pp = 1) or ``dataset.split``
  (the synthetic dataset).

One serving field is declared and refused where serving starts
(``Config.check_servable``, called by ``InferenceEngine``), not at load:
``inference.attend_fallback: true`` (a kernel failure in the port
raises). A training run does not read it, and the JAX package's own
``to_dict`` writes it at its default (true), so a dump of a JAX config
loads here for training.

Besides, tenants or a tenant manifest (``inference.tenancy``) are served
by ``tools/serve.py`` (``python -m picotron_tpu_torch.tools.serve``) and
refused by the generate CLI, which serves one adapter with ``--adapter``;
and ``Config.check_trainable`` (called
by the trainer) refuses what the port's trainer lacks: any parallelism
(dp, tp, pp or cp above 1, zero1, fsdp), ``remat`` ``"save_attn"`` and
``"offload"``, HF datasets, a checkpoint mirror tier
(``resilience.ckpt_mirror_dir``), ``steps_per_call`` above 1, and the
resilience (apart from signals, retried checkpoint I/O and the
non-finite gate), observability, wandb and profiling features of the JAX
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
    """The trainer's checkpoints (``checkpoint.py``): saved under
    ``save_dir`` every ``save_frequency`` steps, resumed from
    ``load_path`` ("auto": the latest step under ``save_dir``), or
    weights taken from an HF safetensors file before training."""

    save_dir: str = "checkpoints"
    save_frequency: int = 0  # 0 = disabled
    # a checkpoint directory to resume from (it must hold one), or "auto"
    load_path: str = ""
    # an HF-format safetensors file or directory to start from
    hf_bootstrap_path: str = ""
    # True: validate the HF file's names and shapes, keep the seed's init
    hf_bootstrap_reinit: bool = False


@dataclass
class LoggingConfig:
    log_frequency: int = 1
    # read only so that ``check_trainable`` can refuse them
    use_wandb: bool = False
    profile_start: int = 0


@dataclass
class ResilienceConfig:
    """The resilience the port has: the non-finite gate (a step with a
    non-finite loss or gradient norm changes neither the parameters nor
    the optimizer state), the SIGTERM/SIGINT flush, the final save on
    exit, auto-resume and retried checkpoint I/O; in serving, retried
    dispatches with per-slot isolation and the serving chaos hooks. The
    training chaos and anomaly fields are read only so that
    ``check_trainable`` can refuse a config that turns them on."""

    nonfinite_guard: bool = True
    # SIGTERM/SIGINT -> finish the step, save, exit 75 (EXIT_PREEMPTED)
    handle_signals: bool = True
    # the final save in the trainer's finally (needs save_frequency > 0)
    save_on_exit: bool = True
    # with save_frequency > 0 and no load_path, resume from the latest
    # step under save_dir when there is one
    auto_resume: bool = True
    # checkpoint and safetensors I/O: attempts, backoff seconds (doubling
    # per attempt) and jitter (a uniform [1, 1 + jitter] scale)
    io_attempts: int = 3
    io_backoff: float = 0.5
    io_jitter: float = 0.25
    # a second storage tier for checkpoints: refused by check_trainable
    ckpt_mirror_dir: str = ""
    # the flush on a signal runs on a thread joined with this deadline
    # (0 = wait for it)
    emergency_save_timeout_s: float = 600.0
    # serving: attempts per batcher dispatch (prefill, decode block,
    # verify) before the batcher isolates the failure to the slots that
    # fail alone (finish reason "error"), and the backoff before the
    # second attempt in seconds (doubling per attempt)
    dispatch_attempts: int = 2
    dispatch_backoff: float = 0.05
    anomaly_policy: str = "skip"
    heartbeat_path: str = ""
    chaos_raise_step: int = 0
    chaos_nan_step: int = 0
    chaos_sigterm_step: int = 0
    chaos_truncate_step: int = 0
    chaos_preempt_rank_at_step: str = ""
    chaos_kill_rank_at_step: str = ""
    chaos_stall_rank_at_step: str = ""
    # serving chaos (resilience/chaos.py::ServingChaos, the engine's
    # dispatch hooks; rounds are 1-indexed decode or verify dispatches, 0 =
    # off): raise once before round N; raise at every dispatch with this
    # slot active (-1 = off); sleep chaos_latency_s once before round N;
    # NaN logits in round N's dispatch
    chaos_dispatch_raise_round: int = 0
    chaos_dispatch_fail_slot: int = -1
    chaos_latency_round: int = 0
    chaos_latency_s: float = 0.25
    chaos_poison_logits_round: int = 0


@dataclass
class ObsConfig:
    """Telemetry (``picotron_tpu_torch/obs``): ``enabled`` and
    ``sample_window`` build the serving stack's metrics registry
    (``Obs.from_config``); the JAX trainer's telemetry outputs are read
    only so that ``check_trainable`` can refuse them."""

    # false swaps in null instruments (no bookkeeping on the hot paths)
    enabled: bool = True
    # raw samples each histogram keeps for the exact /statz percentiles
    sample_window: int = 4096
    metrics_jsonl: str = ""
    trace_path: str = ""


@dataclass
class SpecControllerConfig:
    """The per-slot speculation policy loop
    (``inference/speculative.py::SpecController``): it reads each slot's
    draft counts and the batcher's per-kind dispatch latencies and sets
    every slot's draft length (and drafter) for the next round. The JAX
    package's fields and defaults."""

    # off unless inference.spec_len > 0 (validate refuses it otherwise)
    enabled: bool = False
    # windowed accept rate at or above which a slot doubles its draft
    # length toward inference.spec_len
    target: float = 0.5
    # windowed accept rate below which a slot halves it toward 0; the
    # [low, target) band holds
    low: float = 0.25
    # draft tokens a slot proposes between two evaluations
    window: int = 32
    # consecutive evaluations in one direction before a ramp applies
    hysteresis: int = 2
    # rounds a slot sits at draft length 0 before a 1-token probe
    cooloff: int = 64
    # dispatch-latency samples per kind before the measured cost of a
    # verify against a decode block joins the decision
    latency_min_samples: int = 16


@dataclass
class TenancyConfig:
    """Multi-tenant serving (``inference/tenancy.py``): named tenants, each
    an optional LoRA adapter over the shared (bf16 or int8) base, a
    priority class, quotas and SLO targets. The default (no tenants, no
    manifest) builds no adapter pack and leaves every path as it was."""

    # inline tenant definitions (``tenancy.Tenant`` dicts), applied after
    # the manifest
    tenants: list = field(default_factory=list)
    # a JSON tenant manifest: {"tenants": [{...}, ...]}
    manifest: str = ""
    # adapter pack capacity: slots in all (slot 0 is the reserved null
    # adapter) and the largest adapter rank; shapes never change, so
    # adding or removing a tenant writes a slot
    adapter_slots: int = 8
    adapter_rank: int = 16


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
    # KV memory layout: "contiguous" = every slot owns a max_seq_len strip;
    # "paged" = block-table indirection over a global pool of fixed-size
    # pages (inference/paged_kv.py) with refcounted prefix sharing and
    # copy-on-write, so the cache holds live tokens only and a shared
    # prompt prefix is stored (and prefilled) once.
    kv_layout: str = "contiguous"
    # Rows per KV page (paged layout only); a power of two >= 8.
    kv_page_len: int = 16
    # Pool size in pages (paged layout only). 0 = auto: one reserved NULL
    # page + slots * ceil(max_seq_len / kv_page_len), the contiguous
    # layout's capacity.
    kv_num_pages: int = 0
    # Radix prefix cache (paged layout only): prompt pages stay in a
    # token-keyed trie after prefill; a new request shares its longest
    # cached prefix and prefills only the rest. False = paging, no sharing.
    prefix_cache: bool = True
    # Per-page storage policy (paged layout only): "uniform" = every page
    # read as kv_cache_dtype stores it; "hot_bf16" = pages with more than
    # one holder (shared prefixes, fork pages) read at full precision,
    # pages with one holder read as int8 with per-row scales. Every write
    # lands in both representations, so a page flips with no rewrite.
    # Excludes kv_cache_dtype "int8".
    kv_page_policy: str = "uniform"
    # Speculative decoding (inference/speculative.py, engine.verify): draft
    # tokens proposed per slot per dispatch; one verify pass scores all
    # spec_len + 1 positions and emits 1 to spec_len + 1 tokens a slot.
    # 0 = off: the batcher drives decode_block.
    spec_len: int = 0
    # Longest suffix n-gram the prompt-lookup drafter matches against the
    # slot's own history (tried spec_ngram down to 1).
    spec_ngram: int = 3
    # "ngram" = the prompt-lookup drafter on the host; "learned" = the
    # EAGLE-style head over the target's last hidden state, sharing its
    # embedding, final norm and LM head (the engine then returns that
    # hidden state from every dispatch: return_hidden).
    drafter: str = "ngram"
    # Most recent history tokens the n-gram match may land in; 0 = all.
    spec_history_window: int = 0
    # Per-slot draft length tuning (SpecControllerConfig).
    spec_controller: SpecControllerConfig = field(
        default_factory=SpecControllerConfig)
    # Multi-tenant serving (TenancyConfig).
    tenancy: TenancyConfig = field(default_factory=TenancyConfig)
    # The JAX engine's dense rebuild after a failed flash dispatch. The
    # port raises on a kernel failure; check_servable refuses True (the
    # JAX default).
    attend_fallback: bool = False
    # Sampling inside the dispatch: the prefill family takes (key,
    # temperature, top_k, top_p) and returns the sampled token id, and
    # decode_step returns no [B, V] logits (decode_block and verify always
    # sample in the dispatch). The same key gives the same token either
    # way.
    sample_on_device: bool = False
    # How sampled tokens are keyed: "round" = the batcher's one
    # torch.Generator, drawn in round order; "slot" = one threefry base
    # key per admitted request, the token at sequence index p keyed
    # fold_in(base, p - 1), so a stream does not depend on how its tokens
    # were grouped into rounds and equals the JAX package's token for
    # token; "auto" = "slot" under overlap or mixed dispatch, else
    # "round".
    key_schedule: str = "auto"
    # The overlap pipeline: the batcher issues round N + 1 before it reads
    # round N's results back, so delivery, drafting and admission run
    # while the card executes. Needs the slot schedule.
    overlap: bool = False
    # The mixed prefill lane: every decode block or verify also runs one
    # prefill_chunk-wide chunk of a long (or radix-resumed) prompt for one
    # slot, so no solo prefill dispatch stalls the decoders. Needs the
    # slot schedule.
    mixed_dispatch: bool = False
    # Prefill/decode disaggregation (inference/page_transport.py): "both"
    # serves colocated; "prefill" prefills and hands its pages off through
    # POST /kv/export (its /generate sheds); "decode" seats imported pages
    # and decodes. Any role but "both" needs kv_layout "paged".
    role: str = "both"

    def __post_init__(self):
        # from_dict hands the nested sections through as dicts (unknown
        # keys ignored, as Config.from_dict ignores them)
        if isinstance(self.spec_controller, dict):
            known = {f.name for f in
                     dataclasses.fields(SpecControllerConfig)}
            self.spec_controller = SpecControllerConfig(
                **{k: v for k, v in self.spec_controller.items()
                   if k in known})
        if isinstance(self.tenancy, dict):
            known = {f.name for f in dataclasses.fields(TenancyConfig)}
            self.tenancy = TenancyConfig(
                **{k: v for k, v in self.tenancy.items() if k in known})


# (section, field) -> the values the port behaves as, for JAX fields the
# port does not declare: any other value is refused at load. Inference
# options of paths the port does not have yet.
REFUSED_AT_LOAD = {
    ("inference", "dp_size"): (1,),
}

# (section, field) -> why the port may leave it unread: JAX fields that
# change nothing while the port runs as it does (what keeps them inert is
# refused at load or by check_trainable).
_UNTIL_PP = "inert while pp_size = 1 (check_trainable)"
_UNTIL_CP = "inert while cp_size = 1 (check_trainable)"
_SYNTHETIC = "inert while the dataset is synthetic (check_trainable)"
_ONE_HOST = ("multi-host consensus; inert in the port's one process "
             "(check_trainable)")
INERT_FIELDS = {
    ("distributed", "pp_engine"): _UNTIL_PP,
    ("distributed", "pp_interleave"): _UNTIL_PP,
    ("distributed", "stage_gating"): _UNTIL_PP,
    ("distributed", "use_cpu"): "the port runs on the card unless its "
                                "caller passes device='cpu'",
    ("distributed", "cp_zigzag"): _UNTIL_CP,
    ("distributed", "cp_impl"): _UNTIL_CP,
    ("distributed", "tp_sequence_parallel"): "inert while tp_size = 1 "
                                             "(check_trainable)",
    ("distributed", "check_vma"): "a check of jax.shard_map's types, which "
                                  "eager PyTorch has no counterpart of",
    ("model", "flash_block_q"): "a Pallas block size; the port's kernels "
                                "fix their own tiles",
    ("model", "flash_block_k"): "a Pallas block size; the port's kernels "
                                "fix their own tiles",
    ("model", "flash_layout"): "the Pallas kernel's head layout; the "
                               "port's kernels take [B, S, H, D]",
    ("model", "gather_logits"): "inert while tp_size = 1: the logits are "
                                "whole on one device",
    ("dataset", "split"): _SYNTHETIC,
    ("dataset", "text_column"): _SYNTHETIC,
    ("dataset", "num_workers"): _SYNTHETIC,
    ("dataset", "num_proc"): _SYNTHETIC,
    ("dataset", "subset_name"): _SYNTHETIC,
    ("dataset", "max_in_memory_tokens"): _SYNTHETIC,
    ("logging", "run_name"): "names the wandb run; inert while use_wandb "
                             "is off (check_trainable)",
    ("logging", "profile_stop"): "inert while profile_start is 0 "
                                 "(check_trainable)",
    ("logging", "profile_dir"): "inert while profile_start is 0 "
                                "(check_trainable)",
    ("resilience", "anomaly_ema_beta"): "tunes the loss-anomaly detector, "
                                        "which changes no step under "
                                        "anomaly_policy 'skip' "
                                        "(check_trainable)",
    ("resilience", "anomaly_zscore"): "tunes the loss-anomaly detector, "
                                      "which changes no step under "
                                      "anomaly_policy 'skip' "
                                      "(check_trainable)",
    ("resilience", "anomaly_warmup_steps"): "tunes the loss-anomaly "
                                            "detector, which changes no "
                                            "step under anomaly_policy "
                                            "'skip' (check_trainable)",
    ("resilience", "rollback_after"): "inert while anomaly_policy is "
                                      "'skip' (check_trainable)",
    ("resilience", "max_rollbacks"): "inert while anomaly_policy is 'skip' "
                                     "(check_trainable)",
    ("resilience", "consensus_interval"): _ONE_HOST,
    ("resilience", "peer_timeout_s"): _ONE_HOST,
    ("resilience", "lease_interval_s"): _ONE_HOST,
    ("resilience", "cluster_dir"): _ONE_HOST,
    ("resilience", "chaos_stall_rank_s"): "inert while "
                                          "chaos_stall_rank_at_step is "
                                          "empty (check_trainable)",
    ("obs", "span_ring"): "sizes the JAX package's span ring; the port's "
                          "obs has no tracer until the obs slice (serve.py "
                          "answers /tracez with 501)",
    ("obs", "profile_dir"): "on-demand profiler captures; the port's obs "
                            "has no profiler until the obs slice (serve.py "
                            "answers /profilez with 501)",
    ("obs", "profile_seconds"): "on-demand profiler captures; the port's "
                                "obs has no profiler until the obs slice "
                                "(serve.py answers /profilez with 501)",
}


# (section, field, the only value the port's trainer takes): options of
# the JAX trainer that select a path this port does not have yet
_UNPORTED_TRAINING = (
    ("distributed", "zero1", False),
    ("distributed", "fsdp", False),
    ("training", "steps_per_call", 1),
    ("logging", "use_wandb", False),
    ("logging", "profile_start", 0),
    ("resilience", "anomaly_policy", "skip"),
    ("resilience", "heartbeat_path", ""),
    ("resilience", "ckpt_mirror_dir", ""),
    ("resilience", "chaos_raise_step", 0),
    ("resilience", "chaos_nan_step", 0),
    ("resilience", "chaos_sigterm_step", 0),
    ("resilience", "chaos_truncate_step", 0),
    ("resilience", "chaos_preempt_rank_at_step", ""),
    ("resilience", "chaos_kill_rank_at_step", ""),
    ("resilience", "chaos_stall_rank_at_step", ""),
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

    def check_servable(self) -> None:
        """Refuse, with a clear message, a config whose serving asks for
        the dense rebuild after a kernel failure
        (``inference.attend_fallback``; the port raises). Called by
        ``InferenceEngine``. A training run does not read it, so the load
        takes it: the JAX package's own ``to_dict`` writes its default,
        true."""
        if self.inference.attend_fallback:
            raise ValueError(
                "inference.attend_fallback=True is not in the PyTorch port "
                "yet (it serves attend_fallback=False only)")

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
        r = self.resilience
        if r.dispatch_attempts < 1:
            raise ValueError("dispatch_attempts must be >= 1")
        if r.dispatch_backoff < 0:
            raise ValueError("dispatch_backoff must be >= 0")
        for name in ("chaos_dispatch_raise_round", "chaos_latency_round",
                     "chaos_poison_logits_round"):
            if getattr(r, name) < 0:
                raise ValueError(f"{name} must be >= 0 (0 = off)")
        if r.chaos_dispatch_fail_slot < -1:
            raise ValueError(
                "chaos_dispatch_fail_slot must be >= -1 (-1 = off)")
        if r.chaos_latency_s < 0:
            raise ValueError("chaos_latency_s must be >= 0")
        if r.io_attempts < 1:
            raise ValueError("io_attempts must be >= 1")
        if r.io_backoff < 0 or r.io_jitter < 0:
            raise ValueError("io_backoff and io_jitter must be >= 0")
        if r.emergency_save_timeout_s < 0:
            raise ValueError(
                "emergency_save_timeout_s must be >= 0 (0 = wait forever)")
        if self.resilience.anomaly_policy not in ("skip", "rollback", "abort"):
            raise ValueError(
                f"unknown anomaly_policy {self.resilience.anomaly_policy!r} "
                "(skip|rollback|abort)")
        if inf.decode_block_len < 1:
            raise ValueError("inference.decode_block_len must be >= 1")
        if inf.prefill_chunk < 1:
            raise ValueError("inference.prefill_chunk must be >= 1")
        if not isinstance(inf.sample_on_device, bool):
            raise ValueError(
                f"inference.sample_on_device must be a JSON boolean "
                f"(true/false), got {inf.sample_on_device!r} — quoted "
                f"'true'/'false' strings are not parsed as booleans")
        if inf.attend_impl not in ("dense", "flash"):
            raise ValueError(
                f"unknown inference.attend_impl {inf.attend_impl!r} "
                "(dense|flash)")
        if not isinstance(inf.overlap, bool):
            raise ValueError(
                f"inference.overlap must be a JSON boolean (true/false), "
                f"got {inf.overlap!r}")
        if inf.key_schedule not in ("auto", "round", "slot"):
            raise ValueError(
                f"unknown inference.key_schedule {inf.key_schedule!r} "
                "(auto|round|slot)")
        if inf.overlap and inf.key_schedule == "round":
            raise ValueError(
                "inference.overlap requires the per-slot key schedule — "
                "round-keyed sampling ties token streams to round "
                "boundaries, which the lookahead pipeline changes; set "
                "inference.key_schedule: 'slot' (or leave it 'auto')")
        if not isinstance(inf.mixed_dispatch, bool):
            raise ValueError(
                f"inference.mixed_dispatch must be a JSON boolean "
                f"(true/false), got {inf.mixed_dispatch!r}")
        if inf.mixed_dispatch and inf.key_schedule == "round":
            raise ValueError(
                "inference.mixed_dispatch requires the per-slot key "
                "schedule — round-keyed sampling ties token streams to "
                "round boundaries, which fusing the prefill lane into "
                "decode rounds changes; set inference.key_schedule: "
                "'slot' (or leave it 'auto')")
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
        if inf.spec_len < 0:
            raise ValueError("inference.spec_len must be >= 0 (0 = off)")
        if inf.spec_ngram < 1:
            raise ValueError("inference.spec_ngram must be >= 1")
        if inf.drafter not in ("ngram", "learned"):
            raise ValueError(
                f"unknown inference.drafter {inf.drafter!r} (ngram|learned)"
                " — 'ngram' is the model-free prompt-lookup drafter, "
                "'learned' the EAGLE-style head over the target's last "
                "hidden state")
        if inf.spec_history_window < 0:
            raise ValueError(
                "inference.spec_history_window must be >= 0 (0 = "
                "unbounded match scan)")
        if self.obs.sample_window < 1:
            raise ValueError("obs.sample_window must be >= 1")
        sc = inf.spec_controller
        if not isinstance(sc.enabled, bool):
            raise ValueError(
                f"inference.spec_controller.enabled must be a JSON "
                f"boolean, got {sc.enabled!r}")
        if sc.enabled and inf.spec_len < 1:
            raise ValueError(
                "inference.spec_controller.enabled requires "
                "inference.spec_len > 0 (spec_len is the controller's "
                "per-slot ceiling; there is no speculation to tune at 0)"
                " — set inference.spec_len, or disable the controller")
        if not 0.0 < sc.target <= 1.0:
            raise ValueError(
                "inference.spec_controller.target must be in (0, 1]")
        if not 0.0 <= sc.low <= sc.target:
            raise ValueError(
                "inference.spec_controller.low must satisfy 0 <= low <= "
                f"target (got low={sc.low}, target={sc.target}) — the "
                "[low, target) band is the hysteresis hold region")
        if sc.window < 1:
            raise ValueError("inference.spec_controller.window must be >= 1")
        if sc.hysteresis < 1:
            raise ValueError(
                "inference.spec_controller.hysteresis must be >= 1")
        if sc.cooloff < 0:
            raise ValueError(
                "inference.spec_controller.cooloff must be >= 0 rounds")
        if sc.latency_min_samples < 1:
            raise ValueError(
                "inference.spec_controller.latency_min_samples must be "
                ">= 1")
        if inf.kv_layout not in ("contiguous", "paged"):
            raise ValueError(
                f"unknown inference.kv_layout {inf.kv_layout!r} "
                "(contiguous|paged)")
        if inf.kv_page_len < 8 or inf.kv_page_len & (inf.kv_page_len - 1):
            raise ValueError(
                f"inference.kv_page_len must be a power of two >= 8, got "
                f"{inf.kv_page_len}")
        if inf.kv_num_pages < 0:
            raise ValueError(
                "inference.kv_num_pages must be >= 0 (0 = auto-size)")
        if inf.kv_page_policy not in ("uniform", "hot_bf16"):
            raise ValueError(
                f"unknown inference.kv_page_policy {inf.kv_page_policy!r} "
                "(uniform|hot_bf16)")
        if inf.kv_page_policy == "hot_bf16":
            if inf.kv_layout != "paged":
                raise ValueError(
                    "inference.kv_page_policy 'hot_bf16' requires the paged "
                    "KV layout (per-page refcounts decide which pages read "
                    "as int8); set inference.kv_layout: 'paged', or keep "
                    "kv_page_policy: 'uniform' on the contiguous layout")
            if inf.kv_cache_dtype == "int8":
                raise ValueError(
                    "inference.kv_page_policy 'hot_bf16' manages its own "
                    "int8 representation for cold pages and is mutually "
                    "exclusive with kv_cache_dtype: 'int8' (a uniformly "
                    "quantized cache has no full-precision pages to keep "
                    "hot); set kv_cache_dtype: 'auto', or keep "
                    "kv_page_policy: 'uniform' for a fully int8 cache")
        if inf.role not in ("prefill", "decode", "both"):
            raise ValueError(
                f"unknown inference.role {inf.role!r} "
                "(prefill|decode|both) — 'both' is the colocated default; "
                "'prefill'/'decode' split a disaggregated fleet")
        if inf.role != "both" and inf.kv_layout != "paged":
            raise ValueError(
                f"inference.role {inf.role!r} requires the paged KV "
                "layout (finished prefills hand off as pool pages — "
                "inference/page_transport.py); set inference.kv_layout: "
                "'paged', or keep role: 'both'")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, raw: dict[str, Any]) -> "Config":
        def build(dc, section: dict):
            known = {f.name for f in dataclasses.fields(dc)}
            return dc(**{k: v for k, v in section.items() if k in known})

        for (section, name), only in REFUSED_AT_LOAD.items():
            value = (raw.get(section) or {}).get(name, only[0])
            if value not in only:
                served = " or ".join(repr(v) for v in only)
                raise ValueError(
                    f"{section}.{name}={value!r} is not in the PyTorch port "
                    f"yet (it serves {name}={served} only)")
        sections = {f.name: f.default_factory for f in dataclasses.fields(cls)}
        cfg = cls(**{name: build(dc, raw.get(name) or {})
                     for name, dc in sections.items()})
        cfg.validate()
        return cfg

    @classmethod
    def from_json(cls, path: str) -> "Config":
        with open(path) as f:
            return cls.from_dict(json.load(f))
