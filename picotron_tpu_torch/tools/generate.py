"""Text generation CLI for the PyTorch port -- the serving path end to end.

    python -m picotron_tpu_torch.tools.generate \
        --config configs/2_smollm_dp8/config.json --random-init \
        --prompt-ids 5,276,388 --prompt-ids 9,10,11 --max-new-tokens 64

Weights come from ``--random-init`` (seed-derived random weights with the
model's init laws); loading checkpoints is not ported yet. All prompts run
through one ContinuousBatcher on the CUDA card. The closing summary line
has the same form as ``picotron_tpu.tools.generate``'s.

``--weight-dtype int8`` quantizes the fresh tree per output channel
(``llama.quantize_params``) and serves it through kernel G;
``--kv-cache-dtype int8`` keeps the cache as int8 rows with fp32 scales.
``--check-weight-parity`` runs the batch again on a bf16 engine fed the
fake-quant reference (the int8 weights dequantized): on the CPU the
greedy tokens must be identical; on the card, where the two matmuls round
differently, it reports the first position where they differ and the
reference's logit gap there.
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


def _load_weights(args, engine, weight_dtype: str):
    """The seed's random tree on the engine's device, quantized for
    ``weight_dtype`` "int8" (the dense tree is dropped on return)."""
    from picotron_tpu_torch.models import llama

    params = llama.init_params(engine.cfg.model, seed=args.seed,
                               device=engine.device)
    return llama.quantize_params(params) if weight_dtype == "int8" else params


def _first_difference(cfg, params, prompt, got, want) -> tuple:
    """Where two greedy streams first differ: (index, the gap between the
    two tokens' logits under ``params`` at that position)."""
    import torch

    from picotron_tpu_torch.models import llama

    i = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
    dev = params["final_norm"].device
    toks = torch.tensor([prompt + got[:i]], dtype=torch.int64, device=dev)
    with torch.no_grad():
        row = llama.forward_logits(params, toks, cfg)[0, -1].float()
    return i, float(row[want[i]] - row[got[i]])


def _weight_parity(args, cfg, engine, results) -> int:
    """``--check-weight-parity``: the same batch on a bf16 engine fed the
    fake-quant reference. 1 on a CPU mismatch, else 0."""
    from picotron_tpu_torch.inference.batcher import ContinuousBatcher
    from picotron_tpu_torch.inference.engine import InferenceEngine
    from picotron_tpu_torch.models import llama
    from picotron_tpu_torch.utils import log0, torch_dtype

    eng2 = InferenceEngine(cfg, engine.device, slots=args.slots,
                           decode_block_len=args.decode_block_len,
                           prefill_chunk=args.prefill_chunk,
                           attend_impl=args.attend_impl, weight_dtype="bf16")
    fakeq = llama.dequantize_params(_load_weights(args, eng2, "int8"),
                                    torch_dtype(cfg.model.dtype))
    results2 = ContinuousBatcher(eng2, fakeq, seed=args.seed).run(
        _build_requests(args))
    bad = [u for u in results if results[u].tokens != results2[u].tokens]
    if not bad:
        log0(f"weight parity: int8 == fake-quant reference for "
             f"{len(results)} requests")
        return 0
    if engine.device.type == "cpu":
        print(f"FAILED: weight parity mismatch (int8 vs fake-quant "
              f"bf16) for {bad}", file=sys.stderr)
        return 1
    for u in bad:
        i, gap = _first_difference(eng2.cfg, fakeq, results[u].prompt,
                                   results[u].tokens, results2[u].tokens)
        log0(f"weight parity: [{u}] int8 and fake-quant streams first "
             f"differ at token {i}; the reference's logit gap there is "
             f"{gap:.4f} (matmuls round differently on the card)")
    return 0


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
    ap.add_argument("--kv-cache-dtype", choices=["auto", "int8"],
                    default=None,
                    help="KV cache storage (default: config "
                         "inference.kv_cache_dtype; int8 = quantized "
                         "cache, ~2x slots/context per HBM byte)")
    ap.add_argument("--weight-dtype", choices=["bf16", "int8"],
                    default=None,
                    help="weight storage (default: config "
                         "inference.weight_dtype) — int8 = per-channel "
                         "quantized matmul weights served through the "
                         "fused dequant matmul, ~half the bf16 bytes")
    ap.add_argument("--check-weight-parity", action="store_true",
                    help="run the batch again on a bf16 engine fed the "
                         "FAKE-QUANT reference (dequantized int8 weights "
                         "through the dense matmul): on the CPU every "
                         "request's tokens must match; on the card the "
                         "first difference and its logit gap are reported")
    args = ap.parse_args(argv)
    if not args.random_init:
        ap.error("pass --random-init (checkpoint loading is not ported yet)")

    from picotron_tpu_torch.config import Config
    from picotron_tpu_torch.inference.batcher import ContinuousBatcher
    from picotron_tpu_torch.inference.engine import InferenceEngine
    from picotron_tpu_torch.utils import log0

    cfg = Config.from_json(args.config)
    if args.kv_cache_dtype is not None:
        cfg.inference.kv_cache_dtype = args.kv_cache_dtype
    if args.weight_dtype is not None:
        cfg.inference.weight_dtype = args.weight_dtype
    if args.check_weight_parity and cfg.inference.weight_dtype != "int8":
        ap.error("--check-weight-parity compares int8 against the "
                 "fake-quant reference; pass --weight-dtype int8")
    if args.check_weight_parity and args.temperature != 0.0:
        ap.error("--check-weight-parity is a greedy-only gate (fused vs "
                 "dense logits are allclose, not bit-equal; sampling can "
                 "flip at near-ties); drop --temperature")
    t0 = time.perf_counter()
    engine = InferenceEngine(cfg, device, slots=args.slots,
                             decode_block_len=args.decode_block_len,
                             prefill_chunk=args.prefill_chunk,
                             attend_impl=args.attend_impl)
    params = _load_weights(args, engine, engine.weight_dtype)
    requests = _build_requests(args)
    setup_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    batcher = ContinuousBatcher(engine, params, seed=args.seed)
    results = batcher.run(requests)
    gen_s = time.perf_counter() - t0

    if args.check_weight_parity:
        del params  # the reference engine builds its own tree
        if _weight_parity(args, cfg, engine, results):
            return 1

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
          f"kv={kv}, weights={engine.weight_dtype}, "
          f"{batcher.decode_dispatches} decode dispatches = "
          f"{dpt:.3f}/token)")
    if failed:
        print("FAILED: some request produced no/invalid tokens",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
