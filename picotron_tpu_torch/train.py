"""Training entry point of the PyTorch port, on one CUDA card:

    python -m picotron_tpu_torch.train --config <config.json> [--max-steps N]

Port of ``picotron_tpu/train.py``'s ``train`` (:128) and ``main`` (:539)
at dp = tp = pp = cp = 1: the synthetic loader, ``init_state`` from the
config's seed, and ``build_train_step`` over the loader until
``total_train_steps`` (or ``--max-steps``) or ``max_tokens``. Each logged
step prints the JAX trainer's line, field for field (``Step | Loss |
Global batch size | Tokens/s | Tokens/s/chip | Tokens | MFU | Memory
usage``).

Checkpoints (``checkpoint.py``), as in the JAX trainer:

- ``checkpoint.hf_bootstrap_path``: the HF file's names and shapes are
  checked against the model, then its weights replace the seed's init
  (with ``hf_bootstrap_reinit``, the init stays);
- resume: an explicit ``load_path`` must hold a checkpoint; ``"auto"``, or
  ``resilience.auto_resume`` with ``save_frequency`` > 0, resumes from the
  latest step under ``save_dir`` when there is one. The loader's saved
  position is verified, then skipped to;
- a save every ``save_frequency`` steps, and in the ``finally`` (with
  ``resilience.save_on_exit``) a flush of the last steps, on a clean end,
  a crash between steps or a signal;
- under ``resilience.handle_signals`` SIGTERM or SIGINT ends the loop after
  the step in flight, the flush runs, and ``main`` returns
  ``EXIT_PREEMPTED`` (75): the same command run again resumes.

Telemetry, wandb, profiling and the anomaly policies are not ported:
``Config.check_trainable`` refuses a config that turns one on.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Optional

import torch

from picotron_tpu_torch import checkpoint as ckpt
from picotron_tpu_torch import train_step as ts
from picotron_tpu_torch import utils
from picotron_tpu_torch.config import Config
from picotron_tpu_torch.data import MicroBatchDataLoader
from picotron_tpu_torch.models import llama
from picotron_tpu_torch.resilience.preemption import (
    EXIT_PREEMPTED,
    PreemptionGuard,
    was_preempted,
)


def train(cfg: Config, max_steps_override: Optional[int] = None,
          loss_history: Optional[list] = None, device=None) -> tuple:
    """Run the training loop; returns ``(final_step, trained_tokens,
    last_loss)``. ``loss_history``, when given, collects ``(step, loss)``
    per optimizer step. ``device=None`` is the CUDA card (and raises
    without one); ``device="cpu"`` runs the plain PyTorch path."""
    cfg.check_trainable()
    device = utils.resolve_device(device)
    t0_setup = time.perf_counter()
    m, t, c, lg, r = (cfg.model, cfg.training, cfg.checkpoint, cfg.logging,
                      cfg.resilience)
    io = dict(io_attempts=r.io_attempts, io_backoff=r.io_backoff,
              io_jitter=r.io_jitter)
    guard = (PreemptionGuard().install() if r.handle_signals
             else PreemptionGuard())  # not installed: never triggered
    # what the finally below may touch, defined before anything can raise
    manager = loader = params = opt_state = None
    step = last_saved_step = trained_tokens = 0
    in_step = False  # a step updates the state in place: no flush mid-step
    loss = float("nan")
    try:
        loader = MicroBatchDataLoader(cfg)
        params, opt_state = ts.init_state(cfg, device=device)
        if c.hf_bootstrap_path:
            # names and shapes from the headers, in both modes
            ckpt.validate_hf_template(c.hf_bootstrap_path, m)
            if c.hf_bootstrap_reinit:
                utils.log0(f"hf_bootstrap_reinit: validated "
                           f"{c.hf_bootstrap_path} as a shape template; "
                           f"keeping random init (reference re-randomize "
                           f"semantics)")
            else:
                loaded = ckpt.load_hf_safetensors(c.hf_bootstrap_path, m,
                                                  device=device, **io)
                with torch.no_grad():
                    for p, w in zip(ts.param_leaves(params),
                                    ts.param_leaves(loaded)):
                        p.copy_(w)
                del loaded
        step_fn = ts.build_train_step(cfg)

        # an explicit load_path must hold a checkpoint; "auto" (or
        # auto_resume while saving) resumes from the latest step under
        # save_dir when there is one
        resume_dir, resume_required = None, False
        if c.load_path and c.load_path != "auto":
            resume_dir, resume_required = c.load_path, True
        elif c.load_path == "auto" or (r.auto_resume
                                       and c.save_frequency > 0):
            resume_dir = c.save_dir
        if c.save_frequency > 0 or resume_dir:
            manager = ckpt.CheckpointManager(resume_dir or c.save_dir, **io)
        if manager is not None and resume_dir and (
                resume_required or manager.latest_step() is not None):
            params, opt_state, step, trained_tokens = manager.load(
                params, opt_state)
            # the geometry check comes before the skip: a changed batch
            # geometry would put the loader on other data
            loader.verify_resume(
                (manager.last_restored_meta or {}).get("data"), step)
            loader.skip_steps(step)
            last_saved_step = step
            utils.log0(f"resumed from {resume_dir} at step {step} "
                       f"({utils.to_readable_format(trained_tokens)} "
                       f"tokens)", flush=True)
            if (os.path.abspath(resume_dir) != os.path.abspath(c.save_dir)
                    and c.save_frequency > 0):
                manager = ckpt.CheckpointManager(c.save_dir, **io)

        n_params = llama.num_params(m)
        peak = utils.peak_flops_per_chip(device)
        n_chips = 1
        kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
                else "cpu")
        max_steps = max_steps_override or t.total_train_steps
        utils.log0(f"model {m.name}: {utils.to_readable_format(n_params)} "
                   f"params | {n_chips} x {kind} | global batch "
                   f"{cfg.global_batch_size} "
                   f"({utils.to_readable_format(cfg.tokens_per_step)} "
                   f"tokens/step) | setup "
                   f"{time.perf_counter() - t0_setup:.1f}s")
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)

        while step < max_steps and (t.max_tokens is None
                                    or trained_tokens < t.max_tokens):
            if guard.triggered:
                utils.log0(f"preemption: {guard.signame} received; "
                           f"flushing checkpoint at step {step} and "
                           f"exiting {EXIT_PREEMPTED}", flush=True)
                break
            t_start = time.perf_counter()
            batch = next(loader)
            in_step = True
            params, opt_state, loss_t = step_fn(
                params, opt_state, batch["input_ids"], batch["target_ids"])
            loss = float(loss_t)  # waits for the step
            in_step = False
            dt = time.perf_counter() - t_start
            step += 1
            trained_tokens += cfg.tokens_per_step
            if loss_history is not None:
                loss_history.append((step, loss))
            tok_s = cfg.tokens_per_step / dt
            tok_s_chip = tok_s / n_chips
            if step % lg.log_frequency == 0:
                mfu = utils.get_mfu(tok_s_chip, n_params,
                                    m.num_hidden_layers, m.hidden_size,
                                    t.seq_length, peak)
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
            if (manager is not None and c.save_frequency > 0
                    and step % c.save_frequency == 0):
                manager.save(step, params, opt_state, trained_tokens,
                             data_meta=loader.state_meta(step))
                last_saved_step = step
    finally:
        guard.uninstall()
        # the final flush: on a clean end, a signal, or a crash between
        # steps (a crash inside a step leaves a half-updated state: the
        # last periodic checkpoint stands)
        if (manager is not None and c.save_frequency > 0 and r.save_on_exit
                and step > last_saved_step and not in_step):
            def _flush():
                manager.save(step, params, opt_state, trained_tokens,
                             data_meta=loader.state_meta(step))

            if guard.triggered:
                # on a thread joined with a deadline: a wedged save costs
                # at most emergency_save_timeout_s of the grace window
                if guard.emergency_save(
                        _flush, timeout_s=r.emergency_save_timeout_s):
                    utils.log0(f"flushed emergency checkpoint at step "
                               f"{step}", flush=True)
            else:
                _flush()
                utils.log0(f"flushed checkpoint at step {step}", flush=True)
    return step, trained_tokens, loss


def main(argv=None, device=None, loss_history: Optional[list] = None) -> int:
    """CLI entry. ``device`` (not a flag: the trainer runs on the card)
    lets a caller run the whole path on the CPU with ``device="cpu"``;
    ``loss_history`` collects ``(step, loss)`` as ``train`` does. Returns
    0, or ``EXIT_PREEMPTED`` after a signal's flush."""
    parser = argparse.ArgumentParser(
        description="picotron-tpu trainer, PyTorch port (one JSON config "
                    "per experiment, one CUDA card)")
    parser.add_argument("--config", required=True, help="path to config.json")
    parser.add_argument("--max-steps", type=int, default=None,
                        help="override training.total_train_steps")
    args = parser.parse_args(argv)
    cfg = Config.from_json(args.config)
    step, tokens, loss = train(cfg, max_steps_override=args.max_steps,
                               loss_history=loss_history, device=device)
    if was_preempted():
        utils.log0(f"preempted; checkpoint flushed at step {step} — exit "
                   f"{EXIT_PREEMPTED} (re-run the same command to resume)",
                   flush=True)
        return EXIT_PREEMPTED
    utils.log0(f"done: {step} steps, {tokens} tokens, final loss {loss:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
