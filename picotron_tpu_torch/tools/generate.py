"""Text generation CLI for the PyTorch port -- the serving path end to end.

    python -m picotron_tpu_torch.tools.generate \
        --config configs/2_smollm_dp8/config.json --random-init \
        --prompt-ids 5,276,388 --prompt-ids 9,10,11 --max-new-tokens 64

Weights come from ``--random-init`` (seed-derived random weights with the
model's init laws); loading checkpoints is not ported yet. All prompts run
through one ContinuousBatcher on the CUDA card. The closing summary line
has the same form as ``picotron_tpu.tools.generate``'s.
"""

from __future__ import annotations

import argparse
import sys
import time


def _build_requests(args) -> list:
    from picotron_tpu_torch.inference.batcher import Request

    prompts = [[int(t) for t in spec.replace(" ", "").split(",") if t]
               for spec in args.prompt_ids or ()]
    if not prompts:
        raise SystemExit("no prompts: pass --prompt-ids")
    return [
        Request(uid=f"req{i}", prompt=p, max_new_tokens=args.max_new_tokens,
                temperature=args.temperature, top_k=args.top_k,
                top_p=args.top_p)
        for i, p in enumerate(prompts)
    ]


def main(argv=None, device=None) -> int:
    """CLI entry. ``device`` (not a flag: the CLI serves on the card) lets
    a caller run the whole path on the CPU with ``device="cpu"``."""
    ap = argparse.ArgumentParser(
        description="generate with the PyTorch port of picotron-tpu "
                    "(continuous-batched KV-cache decode)")
    ap.add_argument("--config", required=True,
                    help="experiment config.json (model shape, inference)")
    ap.add_argument("--random-init", action="store_true",
                    help="seed-derived random weights (the only weight "
                         "source ported so far)")
    ap.add_argument("--prompt-ids", action="append",
                    help="comma-separated token ids (repeatable)")
    ap.add_argument("--max-new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy")
    ap.add_argument("--top-k", type=int, default=0, help="<= 0 disables")
    ap.add_argument("--top-p", type=float, default=1.0, help=">= 1 disables")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--slots", type=int, default=4,
                    help="decode batch width (engine slots)")
    ap.add_argument("--decode-block-len", type=int, default=None,
                    help="decode steps per decode_block call (default: "
                         "config inference.decode_block_len)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked-prefill width for prompts longer than "
                         "this (default: config inference.prefill_chunk)")
    ap.add_argument("--attend-impl", choices=["dense", "flash"], default=None,
                    help="KV-cache attention: the flash-decode kernel or the "
                         "dense whole-window version (default: config "
                         "inference.attend_impl)")
    args = ap.parse_args(argv)
    if not args.random_init:
        ap.error("pass --random-init (checkpoint loading is not ported yet)")

    from picotron_tpu_torch.config import Config
    from picotron_tpu_torch.inference.batcher import ContinuousBatcher
    from picotron_tpu_torch.inference.engine import InferenceEngine
    from picotron_tpu_torch.models import llama
    from picotron_tpu_torch.utils import log0

    cfg = Config.from_json(args.config)
    t0 = time.perf_counter()
    engine = InferenceEngine(cfg, device, slots=args.slots,
                             decode_block_len=args.decode_block_len,
                             prefill_chunk=args.prefill_chunk,
                             attend_impl=args.attend_impl)
    params = llama.init_params(engine.cfg.model, seed=args.seed,
                               device=engine.device)
    requests = _build_requests(args)
    setup_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    batcher = ContinuousBatcher(engine, params, seed=args.seed)
    results = batcher.run(requests)
    gen_s = time.perf_counter() - t0

    n_tokens = 0
    failed = False
    for req in requests:
        r = results[req.uid]
        n_tokens += len(r.tokens)
        ok = (len(r.tokens) > 0
              and all(0 <= t < cfg.model.vocab_size for t in r.tokens))
        failed |= not ok
        log0(f"[{r.uid}] prompt={r.prompt} -> {r.tokens} "
              f"({r.finish_reason})")
    dpt = batcher.decode_dispatches / max(batcher.generated_tokens, 1)
    kv = str(engine.cache_dtype).removeprefix("torch.")
    log0(f"{n_tokens} tokens in {gen_s:.2f}s "
          f"({n_tokens / max(gen_s, 1e-9):.1f} tok/s, "
          f"setup {setup_s:.1f}s, slots={engine.slots}, "
          f"tp=1, block={engine.decode_block_len}, "
          f"kv={kv}, weights=bf16, "
          f"{batcher.decode_dispatches} decode dispatches = "
          f"{dpt:.3f}/token)")
    if failed:
        print("FAILED: some request produced no/invalid tokens",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
