"""Text generation CLI for the PyTorch port -- the serving path end to end.

    python -m picotron_tpu_torch.tools.generate \
        --config configs/2_smollm_dp8/config.json --hf-path model.safetensors \
        --prompt-ids 5,276,388 --prompt-ids 9,10,11 --max-new-tokens 64

Weights come from exactly one of:

  --load-path    the port's training checkpoint directory (the trainer's
                 ``checkpoint.save_dir``; its newest readable step,
                 parameters only: ``CheckpointManager.load_params``)
  --hf-path      an HF-format safetensors file or directory
                 (``checkpoint.load_hf_safetensors``)
  --random-init  seed-derived random weights with the model's init laws

A ``--load-path`` that holds an orbax checkpoint of the JAX package is
refused with a message: the port cannot read orbax. All prompts run
through one ContinuousBatcher on the CUDA card. The closing summary line
has the same form as ``picotron_tpu.tools.generate``'s.

``--weight-dtype int8`` quantizes the weights per output channel as they
load (from a file, leaf by leaf as they come off it; a fresh tree through
``llama.quantize_params``) and serves them through kernel G;
``--kv-cache-dtype int8`` keeps the cache as int8 rows with fp32 scales.
``--kv-layout paged`` serves from a page pool with radix prefix sharing
(``--kv-page-policy hot_bf16`` reads shared pages at full precision and
a slot's own pages as int8); a second summary line then reports the
pool and the prefix cache's counters.
``--check-weight-parity`` runs the batch again on a bf16 engine fed the
fake-quant reference (the int8 weights dequantized): on the CPU the
greedy tokens must be identical; on the card, where the two matmuls round
differently, it reports the first position where they differ and the
reference's logit gap there.
``--spec-len N`` speculates: the prompt-lookup drafter (``--spec-ngram``,
or ``inference.drafter`` of the config) proposes N tokens a slot and one
verify pass emits 1 to N + 1; the summary line then reports ``spec=N
accept=R``.
``--sample-on-device`` draws each first token inside its prefill dispatch
(``inference.sample_on_device``): the same tokens as without it.
``--adapter RANK[:SEED[:SCALE]]`` serves every request through one
seed-derived LoRA adapter (slot 1 of a two-slot pack, through kernel H on
the card); ``--check-adapter-parity`` runs the batch again on a pack-less
engine fed the merged tree ``W + A @ B`` (an int8 primary merges into its
fake-quant twin), exact on the CPU and reported as above on the card. A
config with ``inference.tenancy`` tenants or a manifest is refused with a
pointer to the HTTP server that serves them,
``python -m picotron_tpu_torch.tools.serve``.
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


def _build_adapter(args, cfg) -> tuple:
    """``--adapter``'s two-slot pack with the seed's adapter in slot 1, and
    that adapter's leaves (the merged reference's input)."""
    from picotron_tpu_torch.inference import tenancy

    pack = tenancy.AdapterPack(cfg.model, slots=2, rank=args.adapter_rank)
    leaves = pack.random_leaves(args.adapter_rank, args.adapter_seed,
                                args.adapter_scale)
    pack.set_slot(1, leaves)
    return pack, leaves


def _load_weights(args, engine, weight_dtype: str):
    """The weights of ``--hf-path``, ``--load-path`` or ``--random-init``
    on the engine's device, quantized as they load for ``weight_dtype``
    "int8" (a random tree's dense copy is dropped on return)."""
    from picotron_tpu_torch import checkpoint as ckpt
    from picotron_tpu_torch.models import llama
    from picotron_tpu_torch.utils import log0

    m, r = engine.cfg.model, engine.cfg.resilience
    io = dict(io_attempts=r.io_attempts, io_backoff=r.io_backoff,
              io_jitter=r.io_jitter)
    if args.hf_path:
        return ckpt.load_hf_safetensors(args.hf_path, m,
                                        weight_dtype=weight_dtype,
                                        device=engine.device, **io)
    if args.load_path:
        mgr = ckpt.CheckpointManager(args.load_path, **io)
        params, step, tokens = mgr.load_params(
            m, device=engine.device, weight_dtype=weight_dtype)
        log0(f"loaded step {step} ({tokens} trained tokens) from "
             f"{args.load_path}")
        return params
    params = llama.init_params(m, seed=args.seed, device=engine.device)
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


def _parity(args, cfg, engine, results, adapter_leaves=None) -> int:
    """The parity gates: the same batch on a pack-less bf16 engine fed the
    reference tree, which is the fake-quant tree (``--check-weight-parity``,
    or an int8 primary under ``--check-adapter-parity``) with the
    adapter merged in when ``adapter_leaves`` is given. 1 on a CPU
    mismatch, else 0."""
    from picotron_tpu_torch.inference.batcher import ContinuousBatcher
    from picotron_tpu_torch.inference.engine import InferenceEngine
    from picotron_tpu_torch.models import llama
    from picotron_tpu_torch.utils import log0, torch_dtype

    eng2 = InferenceEngine(cfg, engine.device, slots=args.slots,
                           decode_block_len=args.decode_block_len,
                           prefill_chunk=args.prefill_chunk,
                           attend_impl=args.attend_impl, weight_dtype="bf16",
                           spec_len=args.spec_len,
                           spec_ngram=args.spec_ngram)
    ref = _load_weights(args, eng2, engine.weight_dtype)
    if engine.weight_dtype == "int8":
        ref = llama.dequantize_params(ref, torch_dtype(cfg.model.dtype))
    gate, ours, theirs = "weight", "int8", "fake-quant reference"
    if adapter_leaves is not None:
        ref = llama.merge_adapter(ref, adapter_leaves)
        gate, ours, theirs = ("adapter", "segmented adapter",
                              "merged-weight reference")
    results2 = ContinuousBatcher(eng2, ref, seed=args.seed).run(
        _build_requests(args))
    bad = [u for u in results if results[u].tokens != results2[u].tokens]
    if not bad:
        log0(f"{gate} parity: {ours} == {theirs} for "
             f"{len(results)} requests"
             + (f" (rank={args.adapter_rank}, weights="
                f"{engine.weight_dtype})" if adapter_leaves is not None
                else ""))
        return 0
    if engine.device.type == "cpu":
        print(f"FAILED: {gate} parity mismatch ({ours} vs {theirs}) for "
              f"{bad}", file=sys.stderr)
        return 1
    for u in bad:
        i, gap = _first_difference(eng2.cfg, ref, results[u].prompt,
                                   results[u].tokens, results2[u].tokens)
        log0(f"{gate} parity: [{u}] {ours} and {theirs} streams "
             f"first differ at token {i}; the reference's logit gap there "
             f"is {gap:.4f} (matmuls round differently on the card)")
    return 0


def main(argv=None, device=None) -> int:
    """CLI entry. ``device`` (not a flag: the CLI serves on the card) lets
    a caller run the whole path on the CPU with ``device="cpu"``."""
    ap = argparse.ArgumentParser(
        description="generate with the PyTorch port of picotron-tpu "
                    "(continuous-batched KV-cache decode)")
    ap.add_argument("--config", required=True,
                    help="experiment config.json (model shape, inference)")
    ap.add_argument("--load-path", default="",
                    help="the port's training checkpoint directory "
                         "(parameters of its newest readable step)")
    ap.add_argument("--hf-path", default="",
                    help="HF-format safetensors file or directory")
    ap.add_argument("--random-init", action="store_true",
                    help="seed-derived random weights (plumbing smoke)")
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
    ap.add_argument("--spec-len", type=int, default=None,
                    help="speculative decoding: draft tokens per verify "
                         "dispatch (default: config inference.spec_len; "
                         "0 = off)")
    ap.add_argument("--spec-ngram", type=int, default=None,
                    help="longest suffix n-gram the prompt-lookup drafter "
                         "matches (default: config inference.spec_ngram)")
    ap.add_argument("--attend-impl", choices=["dense", "flash"], default=None,
                    help="KV-cache attention: the flash-decode kernel or the "
                         "dense whole-window version (default: config "
                         "inference.attend_impl)")
    ap.add_argument("--kv-cache-dtype", choices=["auto", "int8"],
                    default=None,
                    help="KV cache storage (default: config "
                         "inference.kv_cache_dtype; int8 = quantized "
                         "cache, ~2x slots/context per HBM byte)")
    ap.add_argument("--kv-layout", choices=["contiguous", "paged"],
                    default=None,
                    help="KV cache layout (default: config "
                         "inference.kv_layout; paged = block-table pool "
                         "with refcounted prefix sharing + COW)")
    ap.add_argument("--kv-page-policy", choices=["uniform", "hot_bf16"],
                    default=None,
                    help="per-page storage policy (paged layout only; "
                         "default: config inference.kv_page_policy) — "
                         "hot_bf16 reads radix-shared prefix pages at "
                         "full precision, exclusive tails as int8")
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
    ap.add_argument("--adapter", default=None,
                    metavar="RANK[:SEED[:SCALE]]",
                    help="serve every request through one seed-derived "
                         "LoRA adapter (tenancy.AdapterPack, slot 1) "
                         "over the base weights: the multi-tenant "
                         "segmented dispatch with a single tenant")
    ap.add_argument("--sample-on-device", action="store_true",
                    help="sample inside the dispatch: the prefill family "
                         "returns token ids, never [B, vocab] logits "
                         "(the same tokens as without it)")
    ap.add_argument("--check-adapter-parity", action="store_true",
                    help="run the batch again on an adapter-less engine "
                         "fed the MERGED reference (W + A @ B; an int8 "
                         "primary merges into its fake-quant twin): on "
                         "the CPU every request's tokens must match; on "
                         "the card the first difference and its logit "
                         "gap are reported")
    args = ap.parse_args(argv)
    if sum(map(bool, (args.load_path, args.hf_path, args.random_init))) != 1:
        ap.error("pass exactly one of --load-path / --hf-path / "
                 "--random-init")

    from picotron_tpu_torch.config import Config
    from picotron_tpu_torch.inference import tenancy
    from picotron_tpu_torch.inference.batcher import ContinuousBatcher
    from picotron_tpu_torch.inference.engine import InferenceEngine
    from picotron_tpu_torch.utils import log0

    cfg = Config.from_json(args.config)
    if cfg.inference.tenancy.tenants or cfg.inference.tenancy.manifest:
        ap.error("inference.tenancy tenants and manifests are served by "
                 "the HTTP server: python -m picotron_tpu_torch.tools.serve "
                 "--config <this config> (per-tenant adapters, quotas and "
                 "/tenants); generate serves one adapter with --adapter "
                 "RANK[:SEED[:SCALE]]")
    if args.load_path and cfg.resilience.ckpt_mirror_dir:
        ap.error("resilience.ckpt_mirror_dir: the PyTorch port keeps no "
                 "checkpoint mirror tier yet; --load-path reads the "
                 "directory it is given")
    if args.kv_cache_dtype is not None:
        cfg.inference.kv_cache_dtype = args.kv_cache_dtype
    if args.kv_layout is not None:
        cfg.inference.kv_layout = args.kv_layout
    if args.kv_page_policy is not None:
        cfg.inference.kv_page_policy = args.kv_page_policy
    if args.weight_dtype is not None:
        cfg.inference.weight_dtype = args.weight_dtype
    if args.sample_on_device:
        cfg.inference.sample_on_device = True
    cfg.validate()
    if args.check_weight_parity and cfg.inference.weight_dtype != "int8":
        ap.error("--check-weight-parity compares int8 against the "
                 "fake-quant reference; pass --weight-dtype int8")
    if args.check_weight_parity and args.temperature != 0.0:
        ap.error("--check-weight-parity is a greedy-only gate (fused vs "
                 "dense logits are allclose, not bit-equal; sampling can "
                 "flip at near-ties); drop --temperature")
    if args.check_adapter_parity and args.adapter is None:
        ap.error("--check-adapter-parity compares the segmented adapter "
                 "dispatch against its merged-weight oracle; pass "
                 "--adapter RANK[:SEED[:SCALE]]")
    if args.check_adapter_parity and args.temperature != 0.0:
        ap.error("--check-adapter-parity is a greedy-only gate (segmented "
                 "vs merged logits are allclose, not bit-equal; sampling "
                 "can flip at near-ties); drop --temperature")
    if args.check_weight_parity and args.adapter is not None:
        ap.error("--check-weight-parity's reference engine is "
                 "adapter-less; run it without --adapter (adapter "
                 "correctness has its own gate, --check-adapter-parity)")
    if args.adapter is not None:
        parts = str(args.adapter).split(":")
        try:
            args.adapter_rank = int(parts[0])
            args.adapter_seed = int(parts[1]) if len(parts) > 1 else 0
            args.adapter_scale = (float(parts[2]) if len(parts) > 2
                                  else tenancy.DEFAULT_ADAPTER_SCALE)
        except ValueError as e:
            ap.error(f"bad --adapter spec {args.adapter!r} "
                     f"(want RANK[:SEED[:SCALE]]): {e}")
        if args.adapter_rank < 1:
            ap.error("--adapter rank must be >= 1")
    t0 = time.perf_counter()
    adapters = adapter_leaves = None
    if args.adapter is not None:
        adapters, adapter_leaves = _build_adapter(args, cfg)
    engine = InferenceEngine(cfg, device, slots=args.slots,
                             decode_block_len=args.decode_block_len,
                             prefill_chunk=args.prefill_chunk,
                             attend_impl=args.attend_impl,
                             adapters=adapters, spec_len=args.spec_len,
                             spec_ngram=args.spec_ngram)
    params = _load_weights(args, engine, engine.weight_dtype)
    requests = _build_requests(args)
    if adapters is not None:
        for r in requests:
            r.adapter_slot = 1
    setup_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    batcher = ContinuousBatcher(engine, params, seed=args.seed)
    results = batcher.run(requests)
    gen_s = time.perf_counter() - t0

    if args.check_weight_parity or args.check_adapter_parity:
        del params  # the reference engine builds its own tree
        if _parity(args, cfg, engine, results, adapter_leaves):
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
    spec = (f"spec={engine.spec_len} "
            f"accept={batcher.accept_rate:.2f} " if engine.spec_len > 0
            and batcher.accept_rate is not None else "")
    log0(f"{n_tokens} tokens in {gen_s:.2f}s "
          f"({n_tokens / max(gen_s, 1e-9):.1f} tok/s, "
          f"setup {setup_s:.1f}s, slots={engine.slots}, "
          f"tp=1, block={engine.decode_block_len}, "
          f"kv={kv}, weights={engine.weight_dtype}, "
          f"{spec}{batcher.decode_dispatches} decode dispatches = "
          f"{dpt:.3f}/token)")
    if batcher.paged is not None:
        st = batcher.stats()
        log0(f"paged kv: page_len={st['kv_page_len']}, "
             f"policy={engine.kv_page_policy}, pages live "
             f"{st['kv_pages_live']}/{st['kv_pages_total']} "
             f"(shared {st['kv_pages_shared']}, int8-read "
             f"{st['kv_pages_quant']}), prefix hits "
             f"{st['prefix_hits']}/{st['prefix_queries']}, cached tokens "
             f"{st['prefix_cached_tokens']}, cow copies "
             f"{st['cow_copies']}, evictions {st['radix_evictions']}")
    if failed:
        print("FAILED: some request produced no/invalid tokens",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
