"""Training entry point of the PyTorch port, on one CUDA card:

    python -m picotron_tpu_torch.train --config <config.json> [--max-steps N]

Port of ``picotron_tpu/train.py``'s ``train`` (:128) and ``main`` (:539)
at dp = tp = pp = cp = 1: the synthetic loader, ``init_state`` from the
config's seed, and ``build_train_step`` over the loader until
``total_train_steps`` (or ``--max-steps``) or ``max_tokens``. Each logged
step prints the JAX trainer's line, field for field (``Step | Loss |
Global batch size | Tokens/s | Tokens/s/chip | Tokens | MFU | Memory
usage``). Checkpoints, resilience (apart from the non-finite gate),
telemetry, wandb and profiling are not ported: ``Config.check_trainable``
refuses a config that turns one on.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

import torch

from picotron_tpu_torch import train_step as ts
from picotron_tpu_torch import utils
from picotron_tpu_torch.config import Config
from picotron_tpu_torch.data import MicroBatchDataLoader
from picotron_tpu_torch.models import llama


def train(cfg: Config, max_steps_override: Optional[int] = None,
          loss_history: Optional[list] = None, device=None) -> tuple:
    """Run the training loop; returns ``(final_step, trained_tokens,
    last_loss)``. ``loss_history``, when given, collects ``(step, loss)``
    per optimizer step. ``device=None`` is the CUDA card (and raises
    without one); ``device="cpu"`` runs the plain PyTorch path."""
    cfg.check_trainable()
    device = utils.resolve_device(device)
    t0_setup = time.perf_counter()
    m, t, lg = cfg.model, cfg.training, cfg.logging
    loader = MicroBatchDataLoader(cfg)
    params, opt_state = ts.init_state(cfg, device=device)
    step_fn = ts.build_train_step(cfg)
    n_params = llama.num_params(m)
    peak = utils.peak_flops_per_chip(device)
    n_chips = 1
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    max_steps = max_steps_override or t.total_train_steps
    utils.log0(f"model {m.name}: {utils.to_readable_format(n_params)} params | "
               f"{n_chips} x {kind} | global batch {cfg.global_batch_size} "
               f"({utils.to_readable_format(cfg.tokens_per_step)} tokens/step) | "
               f"setup {time.perf_counter() - t0_setup:.1f}s")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    step = trained_tokens = 0
    loss = float("nan")
    while step < max_steps and (t.max_tokens is None
                                or trained_tokens < t.max_tokens):
        t_start = time.perf_counter()
        batch = next(loader)
        params, opt_state, loss_t = step_fn(
            params, opt_state, batch["input_ids"], batch["target_ids"])
        loss = float(loss_t)  # waits for the step
        dt = time.perf_counter() - t_start
        step += 1
        trained_tokens += cfg.tokens_per_step
        if loss_history is not None:
            loss_history.append((step, loss))
        tok_s = cfg.tokens_per_step / dt
        tok_s_chip = tok_s / n_chips
        if step % lg.log_frequency == 0:
            mfu = utils.get_mfu(tok_s_chip, n_params, m.num_hidden_layers,
                                m.hidden_size, t.seq_length, peak)
            mem = utils.device_memory_gb(device)
            parts = [
                f"Step: {step:<5d}",
                f"Loss: {loss:6.4f}",
                f"Global batch size: "
                f"{utils.to_readable_format(cfg.tokens_per_step)}",
                f"Tokens/s: {utils.to_readable_format(tok_s)}",
                f"Tokens/s/chip: {utils.to_readable_format(tok_s_chip)}",
                f"Tokens: {utils.to_readable_format(trained_tokens)}",
            ]
            if mfu is not None:
                parts.append(f"MFU: {mfu:.2f}%")
            if mem is not None:
                parts.append(f"Memory usage: {mem:.2f}GB")
            utils.log0(" | ".join(parts), flush=True)
    return step, trained_tokens, loss


def main(argv=None, device=None) -> int:
    """CLI entry. ``device`` (not a flag: the trainer runs on the card)
    lets a caller run the whole path on the CPU with ``device="cpu"``."""
    parser = argparse.ArgumentParser(
        description="picotron-tpu trainer, PyTorch port (one JSON config "
                    "per experiment, one CUDA card)")
    parser.add_argument("--config", required=True, help="path to config.json")
    parser.add_argument("--max-steps", type=int, default=None,
                        help="override training.total_train_steps")
    args = parser.parse_args(argv)
    cfg = Config.from_json(args.config)
    step, tokens, loss = train(cfg, max_steps_override=args.max_steps,
                               device=device)
    utils.log0(f"done: {step} steps, {tokens} tokens, final loss {loss:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
