"""Decode rate and TTFT of three of the port's serving paths, and the
training step time, for two trees in one run on one CUDA card.

    python3 serve_ab.py --root OLD --root NEW [--path train ...]

Each ``--root`` is a checkout of the repo (its ``picotron_tpu_torch`` and
``chip_smoke.py``). The trees run in the order OLD, NEW, NEW, OLD, each
run in a process of its own with that root first on ``sys.path`` (its
kernels built from its own sources), so a drift of the card or the host
over the run falls on both trees alike. Each run serves, twice after a
warm-up, on each path:

- ``serve``: ``chip_smoke.py``'s 8 requests (the tree's own ``_requests``)
  on SmolLM-1.7B (config #2's model, bf16) on the contiguous bf16 cache,
  ``attend_impl="flash"``;
- ``serve_tenants``: its 10 requests of three LoRA tenants and the base
  model in one batch (the tree's own ``_tenancy_config`` and
  ``_tenant_requests``) on the same model over paged bf16 pages;
- ``serve_int8``: the 8 requests on Llama-2-7B (config #4's model) with
  int8 weights and int8 KV cache;
- ``train`` (only when asked for): ``chip_smoke.py``'s training phase
  without its gate, CLI and profile: config #2's model and training
  sections on one card (seq 2048 x micro-batch 4, remat, AdamW) over the
  synthetic loader, its warm-up steps, then its timed steps.

Random weights from seed 0, 8 slots, the configs' decode block and chunk.
``--path`` picks paths (default: the three serving ones). Prints one JSON
line per path and run (decode tokens/s as ``chip_smoke.py`` computes it,
TTFT p50 and max, wall seconds; for ``train`` the median step time), then
one summary line with each tree's medians per path.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPEATS = 2  # timed runs per path and process, after one warm-up
SERVING = ("serve", "serve_tenants", "serve_int8")
KEYS = ("decode_tokens_per_s", "ttft_p50_s", "ttft_max_s", "step_s")


def _train(root: str, torch, cs) -> None:
    """The training path's timed steps, on the tree at ``root``."""
    from picotron_tpu_torch import train_step as ts
    from picotron_tpu_torch.config import Config
    from picotron_tpu_torch.data import MicroBatchDataLoader

    with open(cs.CONFIG) as f:
        raw = json.load(f)
    raw["distributed"] = {}  # one of config #2's eight dp ranks
    cfg = Config.from_dict(raw)
    loader = MicroBatchDataLoader(cfg)
    params, opt_state = ts.init_state(cfg, device=torch.device("cuda"),
                                      seed=cs.SEED)
    step_fn = ts.build_train_step(cfg)
    times, losses = [], []
    for i in range(cs.WARMUP_STEPS + cs.TIMED_STEPS):
        b = next(loader)
        t0 = time.perf_counter()
        params, opt_state, loss = step_fn(params, opt_state, b["input_ids"],
                                          b["target_ids"])
        losses.append(float(loss))  # waits for the step
        if i >= cs.WARMUP_STEPS:
            times.append(time.perf_counter() - t0)
    print(json.dumps({"root": root, "path": "train",
                      "step_s": statistics.median(times),
                      "steps_s": times, "losses": losses}), flush=True)
    del params, opt_state
    torch.cuda.empty_cache()


def _child(root: str, paths: list) -> None:
    """One process's runs of ``paths``, on the tree at ``root``."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from picotron_tpu_torch.config import Config
    from picotron_tpu_torch.inference.batcher import ContinuousBatcher, Request
    from picotron_tpu_torch.inference.engine import InferenceEngine
    from picotron_tpu_torch.models import llama

    from picotron_tpu_torch.inference import tenancy

    if "train" in paths:
        _train(root, torch, cs)
    for path, config, int8 in (("serve", cs.CONFIG, False),
                               ("serve_tenants", None, False),
                               ("serve_int8", cs.CONFIG_7B, True)):
        if path not in paths:
            continue
        registry = None
        if path == "serve_tenants":
            cfg = cs._tenancy_config()
            pack, registry = tenancy.build_tenancy(cfg)
            engine = InferenceEngine(cfg, "cuda", slots=8, adapters=pack)
        else:
            cfg = Config.from_json(config)
            if int8:
                cfg.inference.weight_dtype = "int8"
                cfg.inference.kv_cache_dtype = "int8"
            engine = InferenceEngine(cfg, "cuda", slots=8,
                                     attend_impl="flash")
        params = llama.init_params(engine.cfg.model, seed=cs.SEED,
                                   device=engine.device)
        if int8:
            params = llama.quantize_params(params)
        if registry:
            pack.device_leaves(engine.device)
        warm = dict(tenant="acme", adapter_slot=1) if registry else {}
        ContinuousBatcher(engine, params, seed=cs.SEED).run(
            [Request("warm", list(range(1, 25)), max_new_tokens=2, **warm)])
        for rep in range(REPEATS):
            requests = (cs._tenant_requests(np, cfg.model.vocab_size,
                                            f"r{rep}_", registry)
                        if registry else
                        cs._requests(np, cfg.model.vocab_size, f"r{rep}_"))
            batcher = ContinuousBatcher(engine, params, seed=cs.SEED)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results = batcher.run(requests)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            ttft = sorted(results[r.uid].ttft_s for r in requests)
            print(json.dumps({
                "root": root, "path": path, "repeat": rep,
                "decode_tokens_per_s": (batcher.generated_tokens
                                        - len(requests))
                / batcher.decode_seconds,
                "ttft_p50_s": ttft[len(ttft) // 2], "ttft_max_s": ttft[-1],
                "wall_s": wall}), flush=True)
        del engine, params
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", action="append", required=True,
                    help="a checkout of the repo; give exactly two")
    ap.add_argument("--path", action="append", choices=SERVING + ("train",),
                    help="run only these paths (default: the serving ones)")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    paths = args.path or list(SERVING)
    if args.child:
        _child(os.path.abspath(args.root[0]), paths)
        return 0
    if len(args.root) != 2:
        ap.error("give exactly two --root")
    old, new = (os.path.abspath(r) for r in args.root)
    rates = {}
    for root in (old, new, new, old):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", "--root",
             root, *(f"--path={p}" for p in paths)], cwd=root, check=True,
            stdout=subprocess.PIPE, text=True)
        for line in out.stdout.splitlines():
            if line.startswith("{"):
                print(line, flush=True)
                rec = json.loads(line)
                tree = "old" if root == old else "new"
                for key in (k for k in KEYS if k in rec):
                    rates.setdefault(key, {}).setdefault(
                        rec["path"], {}).setdefault(tree, []).append(
                            rec[key])
    print(json.dumps({"median_" + key: {
        path: {tree: statistics.median(v) for tree, v in by.items()}
        for path, by in paths.items()} for key, paths in rates.items()}
        | {"runs": rates}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
