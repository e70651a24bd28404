"""Chip smoke test of the PyTorch port (picotron_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each of which must pass:

1. the card's name and power limit (nvidia-smi), then the CUDA kernels
   built from this checkout's sources (build seconds printed, and each
   kernel's registers, static shared memory and spills as ptxas reports
   them), and kernel C's instructions (``cuobjdump -sass``): each of its
   ten chunk instantiations (five variants, two head dims) must hold
   HGMMA (tensor-core) instructions, its decode instantiations none, and
   no separate merge kernel may be left; kernel G's two prefill (wgmma)
   instantiations (tiles by TMA, by cp.async) must hold HGMMA, its two
   split-K GEMV ones mma.sync (HMMA) and no HGMMA;
2. every kernel against its plain PyTorch version on the card, in bf16, at
   the main paths' shapes plus a ragged and a GQA shape (B and C at
   head_dim 64 and 128, B also at S = 200, which no 64-row tile divides;
   B with its LSE, E and F at the training shape, a ragged S and a GQA
   shape at head_dim 64, and the GQA shape at 128; G at every projection
   shape of Llama-2-7B; C's int8 variant at its decode and chunk shapes).
   B (the forward), E (dQ) and F (dK/dV) run their products on the bf16
   tensor cores (wgmma), and so do C's chunk rows; the rest run on the
   fp32 pipes. C's five variants split their walk over the window across
   blocks, and the last block of each row block merges the splits: one
   launch a call, which each C row reads from a profiler trace (one device
   kernel per call), with the same output bit for bit when called twice
   and the merge's counters back at zero. Every C row names its split
   plan, and C is also held at lengths that leave whole splits empty (0,
   1, 129) and, at chunks (S = 512, GQA, and a ragged 400 rows of S x g),
   at rows that see no key: those rows must come out exactly 0. One JSON
   line per shape with the kernel's time, the plain version's, one
   library call's (a yardstick only; the port never calls it) and the
   card's lower bound; C's rows, A's, D's and H's also with the device
   time of the kernel and of the library call, from a profiler trace. A
   (RMSNorm) at ``A_SHAPES`` and D (its backward) at ``D_SHAPES``: the
   main paths' shapes, an H 4096 shape and a ragged width (H 1000), each
   one device kernel a call, D's dx and dw the same bits when called
   twice, each row with its launch plan.
   The backward kernels' library yardstick is F.rms_norm and
   F.scaled_dot_product_attention under autograd, timed as forward +
   backward less forward (D's also on the device, from traces); G's is
   aten's int8-weight matmul (or cuBLAS on a bf16 copy of the weight),
   and each G row also times ``torch.matmul`` on a bf16 copy of the
   weight (what the tensor cores give the shape), reads
   its kernel's device time from a trace (one kernel a call) and checks
   that two calls give the same bits (its split-K counters back at zero
   after the rows); C-int8's SDPA over a dequantized copy; C's
   paged variants (paged, paged int8, hot_bf16 mixed pages) at their
   decode shape (8 slots, 16-row pages, 128 pages per slot, a shuffled
   table whose slots share a prefix's pages and end in NULL entries,
   lengths 0 to 2048) at head_dim 64 and 128, the chunk shape (S = 512 over
   300 cached tokens), a GQA shape and page lengths 8 and 128, each with
   SDPA over a window gathered outside the timing as its yardstick; and
   three identities that must hold bit for bit (max |diff| = 0): paged C
   over a shuffled table = contiguous C over the same rows, paged C-int8 =
   C-int8, and mixed pages with every flag 0 (1) = paged C (paged C-int8);
   and kernel H (the segmented LoRA residual) in both of its modes at
   SmolLM-1.7B's seven projection shapes at decode (8 rows mixing the null
   adapter with three adapters, one of rank 4 in a rank-16 pack) and at a
   512-row prefill chunk, at Llama-2-7B's at decode and at a ragged shape:
   the residual (null rows exactly 0) and the residual added into a base
   output in place (bit for bit the residual + PyTorch's cast and add,
   null rows bit for bit the base), each one device kernel a call, with
   two ``torch.bmm`` over gathered adapters (and, fused, the cast and the
   add) as its yardstick; at the SmolLM decode shape the model's seam
   (``llama.matmul`` over an adapter leaf) must run two device kernels a
   call, the base product and H. Then the verify shape of speculative
   decoding (spec_len 4: 8 slots of 5 rows, each at its own offset): C in
   all five variants at the decode windows (T 2048, C-int8 4096), head_dim
   64 and 128, lengths that leave a slot free, give a slot rows that see no
   key and end on either side of a 128-key tile, plus a GQA row (5 x 4 =
   20 rows a kv head: the chunk rows on wgmma); G at M 40 (wgmma) on
   Llama-2-7B's w_up and lm_head shapes; H in both modes at B 8, S 5, K N
   2048; each against its plain version, one launch a call, the same bits
   twice, with its bound and library time;
3. the serving path: SmolLM-1.7B at full width and depth (random weights
   from a fixed seed, bf16) behind InferenceEngine + ContinuousBatcher with
   ``attend_impl="flash"``, serving 8 requests (six greedy, two sampled;
   three prompts long enough for chunked prefill). Every request must
   return its full budget of in-vocabulary tokens, every serving kernel's
   launch count must rise during the run, and each greedy stream must
   agree with a full-sequence forward of the same weights (every generated
   token within a small margin of that position's top logit); then the
   ``picotron_tpu_torch.tools.generate`` command line on the same model,
   which must serve on the card without being told to;
4. the serving requests once more under torch.profiler: where the device
   time went, the device's busy share of the wall time, and C's kernels by
   name (no separate merge kernel may appear in any profile);
5. the paged serving path: the SmolLM-1.7B model of phase 3 (8 slots,
   window 2048, 16-row pages, the pool auto-sized, the radix prefix cache
   on) serving a shared-prefix traffic of 8 requests (four under one
   300-token system prompt, the first prompt once more, three unrelated
   prompts; six greedy, two sampled) three times: uniform bf16 pages,
   ``kv_cache_dtype: "int8"`` and ``kv_page_policy: "hot_bf16"``. Each run
   must launch its own variant of C and no other (nor contiguous C), find
   4 prefix hits and 1223 cached tokens, make at least 4 copy-on-writes,
   and pass phase 3's greedy gate; after the first scheduler round, with
   every slot live, the hot_bf16 run's tables must point at both bf16
   (shared) and int8 (one holder) pages; the hot_bf16 run once more under
   the profiler, then the generate command line with ``--kv-layout paged
   --kv-page-policy hot_bf16``, on the card by default;
6. several tenants in one batch: the SmolLM-1.7B model of phase 3 on
   paged bf16 pages with three tenants' LoRA adapters (ranks 16, 8 and 4,
   priorities 2, 1 and 0) in one 8-slot pack, serving 10 requests (the
   priority-0 tenant's two submitted first; the system prompt under
   acme, acme, globex and base suffixes; r0's prompt again; unrelated
   prompts; eight greedy, two sampled). The higher classes must be seated
   first, H must launch 168 times for A's 49, the prefix cache must hit
   only inside a tenant's domain, every greedy token must sit within the
   margin of the top logit of its tenant's merged tree, and at least two
   tenants' adapters must move their streams off the base model's; then
   the run under the profiler (H's share of device time) and the generate
   command line with ``--adapter 16:1 --check-adapter-parity``;
7. the int8 serving path: config #4's model (Llama-2-7B at full width and
   depth, random weights from a fixed seed quantized on the card) with
   ``weight_dtype`` and ``kv_cache_dtype`` "int8", serving the same 8
   requests, under the same checks; every product runs through G and every
   cache attend through C's int8 variant, and its profile must show no
   library GEMM or attention kernel; then the generate command line with
   ``--weight-dtype int8 --kv-cache-dtype int8``;
8. the training path: config #2's ``model`` and ``training`` sections on a
   single device (full-width, 24-layer SmolLM-1.7B, seq 2048 x micro-batch
   4, remat "full", AdamW) from a fixed seed over the synthetic loader.
   First the gate: one step's loss and gradients through the kernels must
   agree with the plain path (``attention_impl: "sdpa"``,
   ``use_pallas_rmsnorm: false``) from the same parameters and batch. Then
   warm-up steps and timed steps: every loss finite, every training
   kernel launched. Then the ``picotron_tpu_torch.train`` command line on
   config #1, on the card by default, and one training step under
   torch.profiler;
9. checkpoints, on config #1's model (full-width SmolLM-1.7B, 5 layers,
   seq 128 x micro-batch 4, bf16) in a temporary directory the phase
   deletes: 4 training steps saving every 2, then the trainer's command
   line with ``load_path: "auto"`` to step 6, which must log that it
   resumed at step 4 and give the losses of an uninterrupted 6-step run
   from the same seed bit for bit; a full restore and a save of step 6
   and the HF export of its parameters (timed, with their bytes), the
   export loaded back in bf16 (the same bits) and int8 (timed); a child
   ``python -m picotron_tpu_torch.train`` sent SIGTERM after its first
   step, which must exit 75 having flushed a readable checkpoint at the
   step it reached; then the generate command line with ``--hf-path`` on
   the export and ``--load-path`` on the checkpoint directory, on the
   card by default, which must serve the same greedy tokens, each within
   phase 3's margin of the loaded weights' top logit, launching A, B and
   C, and ``--hf-path --weight-dtype int8 --kv-cache-dtype int8
   --check-weight-parity``, launching G and C-int8. One
   ``{"checkpoint": ...}`` line with the seconds and bytes;
10. speculative decoding (``spec_len`` 4) on phase 3's model: contiguous
   bf16 with the n-gram drafter (``serve_spec``), with the learned drafter
   and the spec_len controller (``serve_spec_learned``), paged bf16 with
   the n-gram drafter on phase 5's traffic (``serve_spec_paged``: 4 prefix
   hits and 1223 cached tokens), a scripted drafter that proposes the
   first run's greedy streams (``serve_spec_oracle``: more than half its
   drafts accepted, so the multi-token emit path runs) and one that
   proposes phase 3's spec-off streams (``serve_spec_offscript``: its
   accept rate and where the two runs' greedy chains part are printed).
   Each run must return full budgets, launch its path's kernels (C's
   variant at S = 5) and no other, and pass phase 3's greedy gate; its
   line prints decode tokens/s, dispatches per token and the accept rate
   beside phases 3's and 5's spec-off figures. Then the generate command
   line with ``--spec-len 4 --spec-ngram 3``, on the card by default;
11. the per-slot key schedule, sampling in the dispatch and the
   fault-tolerant serving round on phase 3's model, 8 slots, phase 3's
   prompts: ``serve_slot`` (``key_schedule: "slot"`` at temperature 0.8:
   the same bits at decode blocks of 1 and 4, phase 3's greedy streams at
   temperature 0, an [8, V] draw equal to each row's draw alone; its decode
   rate beside the round schedule's, the draw's time beside
   torch.multinomial's), ``serve_slot_spec`` (``spec_len`` 4: full budgets,
   the greedy gate, where its sampled streams part from ``serve_slot``'s),
   ``sample_on_device`` (phase 3's greedy streams; no [8, V] copy to the
   host in a profiled ``decode_step`` round) and ``serve_chaos`` (two
   attempts a dispatch, a raise, a failing slot, a latency spike and a
   request's deadline, greedy and at temperature 0.8: the failing slot's
   request "error", the late one "timeout", every other one its full
   budget and the fault-free run's bits; then NaN logits in a round: every
   request accounted for). Each run launches A, B and C and no other;
12. the overlap pipeline and the mixed prefill lane on phase 3's model (8
   slots, decode blocks of 4, chunks of 512, the slot schedule):
   ``serve_overlap`` (phase 3's prompts and budgets, contiguous, with
   overlap at temperature 0.8, in turns with the serial scheduler, and
   greedy: the serial runs' bits; decode tokens/s, the issue-to-issue gap
   and the device's busy share of each mode), ``serve_lane_paged`` (paged
   bf16 with the prefix cache: phase 5's traffic, then two 1,400-token
   prompts once four slots decode; serial, the lane, the lane with
   overlap: the serial bits and prefill dispatches, phase 5's prefix hits
   and cached tokens; each mode's decode stall, the decoders' TPOT and the
   long prompts' TTFT) and ``serve_lane_spec`` (``spec_len`` 4, n-gram,
   the lane with overlap: the serial spec run's bits, full budgets, phase
   3's greedy gate). Every run with overlap issues its rounds under
   ``torch.cuda.set_sync_debug_mode("error")``, and each run launches its
   path's kernels (A, B and C, or C's paged variant) and no other;
13. the HTTP front end (``tools/serve.py``): phase 3's model and requests
   POSTed to ``Server(engine, params, port=0)`` (two streamed), in turns
   with ``ContinuousBatcher.run`` on the same engine: the same bits, the
   decode rates both ways, TTFT through HTTP and the front end's host
   seconds a request (``serve_http``); phase 6's tenancy config with a
   tenant hot-added by ``POST /tenants``, served and removed
   (``serve_http_tenants``: A, B, C-paged and H); the CLI in a
   subprocess at full width (``--config --random-init --port 0``: start-up
   seconds, one POST, SIGTERM with a request in flight, which is served,
   and exit 0); ``--smoke`` and ``--smoke --overlap`` on the card;
14. prefill/decode disaggregation on phase 5's model and traffic, once
   each for uniform bf16 pages (``serve_disagg``), int8 KV
   (``serve_disagg_int8``) and ``hot_bf16`` (``serve_disagg_mixed``): a
   colocated run (``role: "both"``), then a prefill engine (``role:
   "prefill"``) prefills each request with a budget of 1, exports it with
   its first token through ``json.dumps``/``json.loads``, and a decode
   engine (``role: "decode"``) seats it as ``Request(kv_import=...)``.
   Gates: no prefill dispatch and 8 seats on the decode side, the
   colocated greedy streams bit for bit (the repeated prompt, whose
   payload carries the first prompt's cached last row, within phase 3's
   logit margin where it parts), every imported page equal to its
   exported page in every leaf, A and the C variant and no B on the decode
   side, A and B on the prefill side, a torn payload self-prefilled and
   counted, the decode pool held by the cache alone afterwards; export and
   import seconds, raw and JSON bytes, decode tokens/s and TTFT beside the
   colocated run's. The bf16 run also moves a parked slot with
   ``migrate_slot`` (the unmoved stream's bits, pages x page bytes moved)
   and serves the HTTP plane: a one-page prompt through POST /kv/export
   and POST /generate with ``"kv"`` (the colocated tokens, 1 seat, 0
   prefill dispatches), the role 503s, GET /kv/pages and /kv/prefixes,
   and a two-page payload's 413 (the 8 MiB body cap);
15. a ``{"kernels": [...]}`` line with each kernel's launches on its own
   path (and on each path: ``serve``, ``serve_paged``,
   ``serve_paged_int8``, ``serve_mixed`` (the ``hot_bf16`` page policy),
   ``serve_tenants``, ``serve_int8``, ``train``, ``checkpoint``,
   ``serve_spec``, ``serve_spec_learned``, ``serve_spec_paged``,
   ``serve_spec_oracle``, ``serve_spec_offscript``, ``serve_slot``,
   ``serve_slot_spec``, ``sample_on_device``, ``serve_chaos``,
   ``serve_overlap``, ``serve_lane_paged``, ``serve_lane_spec``,
   ``serve_http``, ``serve_http_tenants``, ``serve_disagg``,
   ``serve_disagg_int8``, ``serve_disagg_mixed``), then ``{"ok": true,
   "device": {...}}`` as the last line.

Any failure exits non-zero before the last line is printed. Without a
CUDA card, or outside a checkout that holds the package, it fails at once.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(HERE, "configs", "2_smollm_dp8", "config.json")
CONFIG_7B = os.path.join(HERE, "configs", "4_llama2_7b_dp4_tp2_pp2_sl1024",
                         "config.json")
CONFIG_1 = os.path.join(HERE, "configs", "1_smollm_single_cpu", "config.json")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
BF16_FLOP_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak
DEVICE = "cuda"
SEED = 0
NEW_TOKENS = 64
PROMPT_LENS = (24, 48, 130, 260, 400, 600, 777, 900)
# the paged phase's traffic: a system prompt under four suffixes, the first
# prompt again, three unrelated prompts (SAMPLED as above)
SYSTEM_LEN = 300
SUFFIX_LENS = (24, 48, 130, 260)
UNRELATED_LENS = (400, 777, 900)
PAGE_LEN = 16
# what the radix cache must find: three hits on the system prompt and the
# repeated prompt, which is shared up to one token short of its end
PREFIX_HITS = 4
PREFIX_CACHED = 3 * SYSTEM_LEN + SYSTEM_LEN + SUFFIX_LENS[0] - 1
MIN_COW = 4
# the pool after the first scheduler round (every slot live, one decode
# block run), as the JAX allocator lays this traffic out: 193 live pages,
# 16 of them with one holder (int8-read under hot_bf16), the rest shared
# with the radix cache
LIVE_PAGES = 193
LIVE_ONE_HOLDER = 16
# (path, kv_cache_dtype, kv_page_policy) of the paged phase's three runs
PAGED_RUNS = (("serve_paged", "auto", "uniform"),
              ("serve_paged_int8", "int8", "uniform"),
              ("serve_mixed", "auto", "hot_bf16"))
SAMPLED = (3, 6)  # request indices drawn at temperature 0.8, top-p 0.9
# the tenancy phase: three tenants with adapters of rank 16, 8 and 4 in an
# 8-slot rank-16 pack (inference.tenancy), and the anonymous base tenant
TENANTS = ({"name": "acme", "adapter_rank": 16, "adapter_seed": 1,
            "priority": 2},
           {"name": "globex", "adapter_rank": 8, "adapter_seed": 2,
            "priority": 1},
           {"name": "initech", "adapter_rank": 4, "adapter_seed": 3,
            "priority": 0})
# its traffic in submission order, (uid, tenant, prompt): initech's two
# unrelated prompts first; r0-r3 the system prompt under SUFFIX_LENS for
# acme, acme, globex and the base tenant; r4 r0's prompt again (acme);
# r5-r7 unrelated prompts for globex, the base tenant and acme
TENANT_TRAFFIC = (("i0", "initech", "unrelated", 500),
                  ("i1", "initech", "unrelated", 650),
                  ("r0", "acme", "system", SUFFIX_LENS[0]),
                  ("r1", "acme", "system", SUFFIX_LENS[1]),
                  ("r2", "globex", "system", SUFFIX_LENS[2]),
                  ("r3", "", "system", SUFFIX_LENS[3]),
                  ("r4", "acme", "repeat", 0),
                  ("r5", "globex", "unrelated", 400),
                  ("r6", "", "unrelated", 777),
                  ("r7", "acme", "unrelated", 900))
TENANT_SAMPLED = ("i1", "r5")  # drawn at temperature 0.8, top-p 0.9
# what the radix cache must find (the port's allocator on this traffic on
# the CPU, which is the JAX allocator's): hits only inside a tenant's own
# domain, r1 on the system prompt and r4 on r0's prompt (one token short
# of its end), both acme's; every tenant prefills the system prompt once
TENANT_PREFIX_QUERIES = len(TENANT_TRAFFIC)
TENANT_PREFIX_HITS = 2
TENANT_PREFIX_CACHED = SYSTEM_LEN + SYSTEM_LEN + SUFFIX_LENS[0] - 1
TENANT_COW = 9
LOGIT_MARGIN = 0.3  # greedy token vs the reference's top logit (see phase 3)
RTOL = ATOL = 2e-2  # kernel vs plain version in bf16 (see _check)
# C's paged variants vs their plain versions, set from what they showed on
# an H100: max |diff| 4.8e-7 to 2.0e-3 over every shape, never more than one
# bf16 rounding step of the output (at most 2^-7 relative), which the limit
# admits at any magnitude; one skipped 128-key tile of a long slot moves
# entries by about 1e-2 and the slot's output by about a quarter in
# relative L2
PAGED_ATOL = 2e-3
PAGED_RTOL = 1e-2
PAGED_SLOT_REL_L2 = 1e-2
# A's and D's (rows, H): A at decode (8 slots), a 512-row prefill chunk and
# the training shape (seq 2048 x micro-batch 4) on SmolLM-1.7B, Llama-2-7B's
# decode (H 4096), and a ragged width (H % 64 != 0); D at the training
# shape, a ragged row count, an H 4096 shape and the ragged width. Beside
# the main shapes (A at decode, D at training) the closing line keeps the
# variants named here
A_SHAPES = ((8, 2048), (512, 2048), (8192, 2048), (8, 4096), (37, 1000))
A_VARIANTS = {(512, 2048): "prefill", (8192, 2048): "train",
              (8, 4096): "h4096"}
D_SHAPES = ((8192, 2048), (1000, 2048), (4096, 4096), (37, 1000))
D_VARIANTS = {(4096, 4096): "h4096"}
# G's (K, N) on the Llama-2-7B path: wq/wk/wv/wo, w_gate/w_up, w_down,
# lm_head
G_SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000))
# H's (K, N): wq/wk/wv/wo, w_gate/w_up and w_down of SmolLM-1.7B (the
# tenancy path) and of Llama-2-7B; a pack of 8 slots at rank 16 holding
# adapters of rank 16, 8 and 4 in slots 1 to 3, and the decode rows' slots,
# null rows among them
H_SMOL_SHAPES = ((2048, 2048), (2048, 8192), (8192, 2048))
H_7B_SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096))
H_SLOTS, H_RANK = 8, 16
H_ADAPTERS = ((1, 16), (2, 8), (3, 4))
H_DECODE_IDS = (0, 1, 2, 3, 1, 0, 3, 2)
# H vs its plain version: both sum fp32 products of the same bf16 inputs,
# in different orders
LORA_ATOL = LORA_RTOL = 1e-4
# the verify shape of speculative decoding (spec_len 4): 8 slots of S = 5
# rows at their own offsets; lengths (query rows' ends) that hold a free
# slot (0), a slot whose first rows see no key (3), and ends on either side
# of a 128-key tile
SPEC_LEN = 4
VERIFY_S = SPEC_LEN + 1
VERIFY_LENS = [0, 3, 127, 128, 129, 133, 700, 2048]
VERIFY_LENS_INT8 = [0, 3, 127, 129, 964, 2000, 3000, 4096]
# G at the verify's row count on Llama-2-7B (8 slots x 5 rows): above
# quant_matmul.SPLITK_MAX_M, so the wgmma path
VERIFY_M = 8 * VERIFY_S
WARMUP_STEPS = 2  # training steps before the timed ones
TIMED_STEPS = 8
# kernel path vs plain path, one training step in bf16 (phase 8): the two
# round P at different places (the flash kernels to bf16 before P @ V, the
# plain sdpa never) and sum in different orders. On an H100 that moved the
# loss by 5e-6 and a gradient leaf by up to 1.6e-2 relative L2
LOSS_RTOL = 5e-3
GRAD_REL_L2 = 5e-2


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_trace(torch, fn, iters: int = 10, per_call=None) -> tuple:
    """The device side of one call of ``fn``, from a torch.profiler trace
    of ``iters`` calls (no host time, so a call whose wrapper costs more on
    the host than its kernels take on the device is measured by its
    kernels): (milliseconds, device events per call, their names). A trace
    now and then comes back without events, or short of some (kernels
    launched in thread-block clusters lose one in most traces and, now and
    then, most of them): a trace with none, or (given ``per_call``) with
    another count than ``per_call`` a call, is taken again, up to eight
    times. A trace loses events but never adds one, so the trace with the
    most events is returned ((None, 0, []) if none held an event)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    out = (None, 0, [])
    for _ in range(8):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.profiler.kineto_results.events()
                  if str(e.device_type()).endswith("CUDA")]
        ns = sum(e.duration_ns() for e in events)
        if ns > 0 and len(events) / iters > out[1]:
            out = (ns / 1e6 / iters, len(events) / iters,
                   sorted({e.name()[:90] for e in events}))
        if ns > 0 and (per_call is None or len(events) == per_call * iters):
            return out
    return out


def _device_ms(torch, fn, iters: int = 10) -> float | None:
    """The device time of one call of ``fn``: every kernel it launches,
    summed from a profiler trace (``_device_trace``)."""
    return _device_trace(torch, fn, iters)[0]


def _sass_counts(lib_path: str, marks: tuple) -> dict:
    """From ``cuobjdump -sass`` of the built library: for each kernel whose
    mangled name holds one of ``marks``, its count of tensor-core (HGMMA:
    wgmma; HMMA: mma.sync) and fp32 FMA (FFMA) instructions."""
    from picotron_tpu_torch.ops.kernels import build

    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = (m.group(1) if any(k in m.group(1) for k in marks)
                    else None)
            if name:
                counts[name] = {"HGMMA": 0, "HMMA": 0, "FFMA": 0}
        elif name:
            for op in counts[name]:
                if re.search(rf"\b{op}\b", line):
                    counts[name][op] += 1
    return counts


def _demangled(mangled: str) -> tuple:
    """(a kernel's own name, its integer template arguments)."""
    k = re.search(r"_cu_[0-9a-f]{8}(\d+)", mangled)
    base = mangled[k.end():k.end() + int(k.group(1))] if k else mangled
    return base, [int(a) for a in re.findall(r"Li(\d+)E", mangled)]


def _sass_check(lib_path: str) -> list:
    """Kernel C in the built library, from ``cuobjdump -sass``: each
    instantiation's count of tensor-core (HGMMA) and fp32 FMA (FFMA)
    instructions. The chunk walks (row tile 64) must run their products
    on the tensor cores, the decode walks (row tile 16) on the fp32 pipes,
    and no separate merge kernel may be left. Returns one record per
    instantiation."""
    counts = _sass_counts(lib_path, ("flash_decode",))
    out = []
    for mangled, n in sorted(counts.items()):
        if "merge" in mangled:
            raise AssertionError(f"a separate merge kernel is left: "
                                 f"{mangled}")
        base, args = _demangled(mangled)
        rows = args[1] if len(args) > 1 else None
        rec = {"kernel": f"{base}<{','.join(map(str, args))}>",
               "row_tile": rows, "HGMMA": n["HGMMA"], "FFMA": n["FFMA"]}
        if rows == 64 and n["HGMMA"] == 0:
            raise AssertionError(f"{rec['kernel']}: no HGMMA in a chunk "
                                 "walk")
        if rows == 16 and n["HGMMA"] != 0:
            raise AssertionError(f"{rec['kernel']}: HGMMA in a decode walk")
        out.append(rec)
    if sum(r["row_tile"] == 64 for r in out) != 10:
        raise AssertionError(f"expected 10 chunk instantiations of C (5 "
                             f"variants x 2 head dims): {out}")
    return out


def _sass_quant_check(lib_path: str) -> list:
    """Kernel G in the built library: its prefill (wgmma) instantiations,
    fed by TMA and by cp.async, must hold HGMMA instructions; its split-K
    GEMV ones (one and two n8 tiles of tokens) mma.sync (HMMA) and no
    HGMMA. Returns one record per instantiation."""
    out = []
    for mangled, n in sorted(_sass_counts(lib_path,
                                          ("quant_matmul",)).items()):
        base, args = _demangled(mangled)
        args += ["true" if b == "1" else "false"
                 for b in re.findall(r"Lb([01])E", mangled)]
        rec = {"kernel": f"{base}<{','.join(map(str, args))}>", **n}
        if "wgmma" in base and n["HGMMA"] == 0:
            raise AssertionError(f"{rec['kernel']}: no HGMMA in G's "
                                 "prefill kernel")
        if "splitk" in base and (n["HMMA"] == 0 or n["HGMMA"] != 0):
            raise AssertionError(f"{rec['kernel']}: G's split-K kernel "
                                 f"must run mma.sync only: {n}")
        out.append(rec)
    kinds = sorted(r["kernel"] for r in out)
    if sum("wgmma" in k for k in kinds) != 2 \
            or sum("splitk" in k for k in kinds) != 2:
        raise AssertionError(f"expected G's two wgmma and two split-K "
                             f"instantiations: {kinds}")
    return out


def _ptxas_summary(log: str) -> list:
    """One line per compiled kernel from ``nvcc -Xptxas -v`` output: its
    name with template arguments, registers, static shared memory (the
    dynamic shared memory a launch asks for is in each source's layout),
    and spill bytes."""
    out, name, spill = [], "?", ""
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            mangled = m.group(1)
            # <file>_cu_<8 hex digits><length><name>: the kernel's own name
            k = re.search(r"_cu_[0-9a-f]{8}(\d+)", mangled)
            name = (mangled[k.end():k.end() + int(k.group(1))] if k
                    else mangled)
            args = re.findall(r"Li(\d+)E", mangled)
            name += f"<{','.join(args)}>" if args else ""
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)
            smem = re.search(r"(\d+) bytes smem", line)
            out.append(f"{name}: {regs.group(1) if regs else '?'} registers, "
                       f"{smem.group(1) if smem else 0} bytes static smem, "
                       f"{spill}")
    return out


def _bound(nbytes: float, flops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _check(name, got, want, mask=None, atol=ATOL, rtol=RTOL) -> float:
    """Max |kernel - plain| over the compared entries; fails past
    |d| <= atol + rtol * |plain|. Both sides are bf16 outputs of fp32
    arithmetic summed in different orders, so they may differ by a
    rounding step of bf16 (2^-8 relative) and a little more where the
    softmax and the sum of squares reassociate."""
    import torch

    got, want = got.float(), want.float()
    if mask is not None:
        got, want = got[mask], want[mask]
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} entries outside tolerance, max abs "
            f"err {float(err.max()):.4g}")
    return float(err.max())


# what C's rows, A's, G's and H's add to their records: C's split plan, and
# the kernels' and the library call's device time (the wrapper times include
# the host's cost of a call, which at decode is about that of the kernels);
# G's second yardstick's (torch.matmul on a bf16 copy of the weight)
DEVICE_KEYS = ("split_plan", "device_ms", "library_device_ms",
               "bf16_matmul_device_ms", "plan")


def _c_extra(torch, kc, run, lib, q, k, block_tables=None) -> dict:
    """A C row's split plan and device times; its call must be one kernel
    launch, the same bit for bit when made twice on the same inputs, and
    leave the merge's counters at zero."""
    a, b = run(), run()
    if not torch.equal(a, b):
        raise AssertionError("two C calls on the same inputs differ")
    iters = 10
    ms, per_call, names = _device_trace(torch, run, iters, per_call=1)
    # every event one C kernel, none beyond one a call; a trace may still
    # come back one event short (9 of 10 on an H100, five traces running),
    # so the kernel's time is its events' mean
    if len(names) != 1 or "flash_decode" not in names[0] \
            or not (iters - 1) / iters <= per_call <= 1:
        raise AssertionError(f"a C call made {per_call} device launches, "
                             f"not 1: {names}")
    ms /= per_call
    _counters_zero(torch, kc)
    lib_ms = _device_ms(torch, lib)
    return {"split_plan": _plan(kc, q, k, block_tables),
            "device_ms": ms, "library_device_ms": lib_ms,
            "device_kernels": names, "device_events_per_call": per_call,
            "device_over_library": ms / lib_ms if ms and lib_ms else None}


def _counters_zero(torch, kc) -> None:
    """C's merge counters are all zero between launches."""
    torch.cuda.synchronize()
    for dev, buf in kc.COUNTERS.items():
        if bool(buf.any()):
            raise AssertionError(f"C's merge counters on {dev} are not all "
                                 f"zero: {int((buf != 0).sum())} set")


def _plan(kc, q, k, block_tables=None) -> dict:
    """C's split plan for a call (a function of its shapes alone)."""
    n_splits, per = kc.plan_for(q, k, block_tables)
    return {"n_splits": n_splits, "tiles_per_split": per,
            "keys_per_tile": kc.TILE_KEYS}


def _empty_rows_zero(name, got, lens, S) -> None:
    """Rows that see no key (a slot whose length leaves every split
    empty for them) must come out exactly 0."""
    for b, L in enumerate(lens):
        dead = max(0, min(S, S - L))  # rows at positions < 0
        if dead and bool(got[b, :dead].float().abs().max() != 0):
            raise AssertionError(f"{name}: slot {b}'s rows with no visible "
                                 "key are not exactly 0")


def _kernel_checks(torch, F) -> dict:
    """Phase 2: each kernel against its plain version; returns per-kernel
    records for the closing line (the main-path shape's times, the
    largest error over every checked shape)."""
    from picotron_tpu_torch.ops.kernels import decode_attention as kc
    from picotron_tpu_torch.ops.kernels import flash_attention as kb
    from picotron_tpu_torch.ops.kernels import rmsnorm as ka

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    records = {}

    def record(kernel, shape, err, ms, plain_ms, library_ms, bound, main,
               variant=None, library=None, extra=None):
        """One shape's JSON line; the main-path shape's numbers go to the
        closing line, and a variant's (B with its LSE, B and C at
        head_dim 128) beside them, under the variant's name."""
        line = {"kernel": kernel.name, "shape": shape, "max_abs_err": err,
                "kernel_ms": ms, "plain_ms": plain_ms,
                "library_ms": library_ms, "bound_ms": bound[0],
                "bound_by": bound[1]}
        if library is not None:
            line["library"] = library
        line.update(extra or {})
        print(json.dumps(line), flush=True)
        rec = records.setdefault(kernel.name, {"max_abs_err": 0.0})
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        if main:
            (rec.setdefault(variant, {}) if variant else rec).update(
                shape=shape, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound[0], bound_by=bound[1],
                **{key: (extra or {})[key] for key in DEVICE_KEYS
                   if key in (extra or {})})

    # A: RMSNorm over [rows, H] at A_SHAPES, each one device kernel a call
    eps = 1e-5
    for rows, H in A_SHAPES:
        x, w = randn(rows, H), (1.0 + 0.1 * randn(H).float()).to(bf)
        run = lambda: ka.rms_norm(x, w, eps)  # noqa: E731
        name = f"rmsnorm rows={rows} H={H}"
        err = _check(name, run(), ka.rms_norm_plain(x, w, eps))
        lib = ((lambda: F.rms_norm(x, (H,), w, eps))
               if hasattr(F, "rms_norm") else None)
        ms, _, names = _launches_a_call(torch, name, run, "rmsnorm_fwd")
        record(ka.KERNEL, {"rows": rows, "H": H}, err, _time_ms(run),
               _time_ms(lambda: ka.rms_norm_plain(x, w, eps)),
               _time_ms(lib) if lib else None,
               _bound((2 * rows * H + H) * 2, 0.0),
               main=(rows, H) == (8, 2048) or (rows, H) in A_VARIANTS,
               variant=A_VARIANTS.get((rows, H)),
               extra={"device_ms": ms,
                      "library_device_ms": (_device_ms(torch, lib)
                                            if lib else None),
                      "device_kernels": names,
                      "plan": ka.plan_fwd(rows, H)})

    # B: causal prefill attention, [1, S, 32, D]; one GQA shape (g = 4),
    # one S that no 64-row tile divides (200); D = 64 (SmolLM) and D = 128
    # (Llama-2-7B)
    for D, S, nh, nkv in ((D, S, nh, nkv) for D in (64, 128)
                          for S, nh, nkv in ((16, 32, 32), (48, 32, 32),
                                             (200, 32, 32), (512, 32, 32),
                                             (2048, 32, 32), (512, 32, 8))):
        q, k, v = randn(1, S, nh, D), randn(1, S, nkv, D), randn(1, S, nkv, D)
        scale = D ** -0.5
        err = _check(f"flash_attention S={S} H={nh} Hkv={nkv}",
                     kb.flash_attention(q, k, v, scale),
                     kb.flash_attention_plain(q, k, v, scale))
        g = nh // nkv
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in
                      (q, k.repeat_interleave(g, 2), v.repeat_interleave(g, 2)))
        flops = 4 * D * nh * S * (S + 1) / 2
        record(kb.KERNEL, {"B": 1, "S": S, "H": nh, "Hkv": nkv, "D": D}, err,
               _time_ms(lambda: kb.flash_attention(q, k, v, scale)),
               _time_ms(lambda: kb.flash_attention_plain(q, k, v, scale)),
               _time_ms(lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=True, scale=scale)),
               _bound((2 * nh + 2 * nkv) * S * D * 2, flops),
               main=(S, nkv) == (512, 32),
               variant="d128" if D == 128 else None)

    # C: flash decode against an 8-slot, 2048-row cache (decode S = 1 and a
    # 16-wide block), one slot empty; the 512-wide chunked-prefill shape
    # (rows on the tensor cores), also GQA (g = 4) and at a ragged S x g
    # (400 rows: no multiple of the 64-row tile) whose first slot's leading
    # rows see no key; one GQA decode shape (g = 4); three slots whose
    # lengths leave whole splits empty (0, 1, 129); D = 64 and D = 128
    T = 2048
    lens8 = [0, 1, 17, 128, 129, 700, 1500, 2048]
    for D, B, S, nh, nkv, lens in (
            (D, *shape) for D in (64, 128)
            for shape in ((8, 1, 32, 32, lens8), (8, 16, 32, 32, lens8),
                          (1, 512, 32, 32, [1536]), (1, 512, 32, 8, [1536]),
                          (2, 100, 32, 8, [60, 1100]),
                          (8, 1, 32, 8, lens8), (3, 1, 32, 32, [0, 1, 129]))):
        q = randn(B, S, nh, D)
        k, v = randn(B, T, nkv, D), randn(B, T, nkv, D)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        scale = D ** -0.5
        live = lengths > 0  # an empty slot's rows are not compared
        got = kc.flash_decode_attention(q, k, v, lengths, scale)
        err = _check(f"flash_decode B={B} S={S} H={nh} Hkv={nkv}", got,
                     kc.flash_decode_attention_plain(q, k, v, lengths,
                                                     scale), mask=live)
        _empty_rows_zero(f"flash_decode B={B} S={S} lengths={lens}", got,
                         lens, S)
        g = nh // nkv
        pos_q = lengths[:, None] - S + torch.arange(S, device=dev)[None]
        amask = (torch.arange(T, device=dev)[None, None]
                 <= pos_q[:, :, None])[:, None]  # [B, 1, S, T]
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (t.repeat_interleave(g, 2).transpose(1, 2).contiguous()
                  for t in (k, v))
        visible = sum(max(0, min(L - S + s + 1, T)) for L in lens
                      for s in range(S))
        keys_read = sum(min(L, T) for L in lens)
        nbytes = 2 * keys_read * nkv * D * 2 + 2 * B * S * nh * D * 2
        run = lambda: kc.flash_decode_attention(  # noqa: E731
            q, k, v, lengths, scale)
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=amask, scale=scale)
        chunk = (B, S, nkv, D) == (1, 512, 32, 64)
        record(kc.KERNEL, {"B": B, "S": S, "H": nh, "Hkv": nkv, "T": T,
                           "D": D, "lengths": lens}, err, _time_ms(run),
               _time_ms(lambda: kc.flash_decode_attention_plain(
                   q, k, v, lengths, scale)),
               _time_ms(lib), _bound(nbytes, 4 * D * nh * visible),
               main=(B, S, nkv) == (8, 1, 32) or chunk,
               variant=("chunk" if chunk else "d128" if D == 128 else None),
               extra=_c_extra(torch, kc, run, lib, q, k))
    _int8_kernel_checks(torch, F, randn, record)
    _paged_kernel_checks(torch, F, randn, record)
    _training_kernel_checks(torch, F, randn, record)
    _lora_kernel_checks(torch, randn, record)
    _verify_kernel_checks(torch, F, randn, record)
    return records


def _g_row(torch, randn, record, M, K, N, main, variant=None) -> None:
    """One G row: kernel G on [M, K] x int8 [K, N] against its plain
    version, the same bits twice, one device kernel a call, with aten's
    int8-weight matmul (or cuBLAS on a bf16 copy of the weight) and
    ``torch.matmul`` on a bf16 copy as yardsticks."""
    from picotron_tpu_torch.ops.kernels import quant_matmul as kg
    from picotron_tpu_torch.ops.quant_matmul import quantize_weight

    int8mm = getattr(torch.ops.aten, "_weight_int8pack_mm", None)
    x = randn(M, K)
    w = quantize_weight(randn(K, N).float() * 0.02)
    q, s = w["q"], w["s"]
    name = f"quant_matmul M={M} K={K} N={N}"
    got = kg.quant_matmul_2d(x, q, s)
    err = _check(name, got, kg.quant_matmul_plain(x, q, s))
    if not torch.equal(kg.quant_matmul_2d(x, q, s), got):
        raise AssertionError(f"{name}: two calls differ")
    # the yardstick: aten's int8-weight matmul where this torch has it
    # for CUDA, else cuBLAS on a bf16 copy of the weight made here,
    # outside the timing
    lib_name, lib_ms, lib = None, None, None
    if int8mm is not None:
        qt, sb = q.t().contiguous(), s.to(torch.bfloat16)
        try:
            int8mm(x, qt, sb)
            lib = lambda: int8mm(x, qt, sb)  # noqa: E731
            lib_ms = _time_ms(lib)
            lib_name = "aten._weight_int8pack_mm"
        except (RuntimeError, NotImplementedError):
            pass
    # a second yardstick, never called by the port: torch.matmul on a
    # bf16 copy of the weight (made here, outside the timing), what the
    # tensor cores give this shape
    wb = q.to(torch.bfloat16)
    mm = lambda: x @ wb  # noqa: E731
    if lib_ms is None:
        lib = mm
        lib_ms = _time_ms(lib)
        lib_name = "torch.matmul on a bf16 copy of the weight"
    run = lambda: kg.quant_matmul_2d(x, q, s)  # noqa: E731
    ms, per, names = _launches_a_call(torch, name, run, "quant_matmul")
    record(kg.KERNEL, {"M": M, "K": K, "N": N,
                       "plan": kg.plan(M, K, N)}, err,
           _time_ms(run),
           _time_ms(lambda: kg.quant_matmul_plain(x, q, s)), lib_ms,
           _bound(M * K * 2 + K * N + N * 4 + M * N * 2, 2 * M * K * N),
           main=main, variant=variant, library=lib_name,
           extra={"device_ms": ms, "device_kernels": names,
                  "device_events_per_call": per,
                  "library_device_ms": _device_ms(torch, lib),
                  "bf16_matmul_ms": _time_ms(mm),
                  "bf16_matmul_device_ms": _device_ms(torch, mm)})


def _int8_kernel_checks(torch, F, randn, record) -> None:
    """Phase 2, the int8 serving path's kernels: G at each projection
    shape of Llama-2-7B with M in {1, 8, 512}, plus ragged shapes; C's int8
    variant at the decode and chunk shapes (T = 4096, D = 128), ragged
    lengths with one slot empty, and one GQA shape."""
    from picotron_tpu_torch.inference.kv_cache import quantize_kv
    from picotron_tpu_torch.ops.kernels import decode_attention as kc
    from picotron_tpu_torch.ops.kernels import quant_matmul as kg

    dev = torch.device(DEVICE)
    for M, K, N in [(M, K, N) for K, N in G_SHAPES for M in (1, 8, 512)] \
            + [(37, 4100, 1000), (5, 4100, 1000)]:
        _g_row(torch, randn, record, M, K, N,
               main=(M, K, N) in ((8, 4096, 11008), (512, 4096, 11008),
                                  (8, 4096, 32000)),
               variant={(512, 4096, 11008): "prefill",
                        (8, 4096, 32000): "lm_head"}.get((M, K, N)))
    torch.cuda.synchronize()
    for dev, (_, counters) in kg.SCRATCH.items():
        if bool(counters.any()):
            raise AssertionError(f"G's split-K counters on {dev} are not all "
                                 f"zero: {int((counters != 0).sum())} set")
    torch.cuda.empty_cache()

    # C-int8 at Llama-2-7B's head_dim 128 (and the chunk at 64 too): the
    # decode and chunk shapes, a GQA chunk, a ragged S x g (400 rows) with
    # rows that see no key, a GQA decode shape, and empty splits
    T = 4096
    lens8 = [0, 1, 130, 257, 700, 964, 2000, 4096]
    for B, S, nh, nkv, D, lens in ((8, 1, 32, 32, 128, lens8),
                                   (1, 512, 32, 32, 128, [1024]),
                                   (1, 512, 32, 32, 128, [900]),
                                   (1, 512, 32, 32, 64, [1024]),
                                   (1, 512, 32, 8, 128, [1024]),
                                   (2, 100, 32, 8, 128, [60, 1100]),
                                   (8, 1, 32, 8, 128, lens8),
                                   (3, 1, 32, 32, 128, [0, 1, 129])):
        q = randn(B, S, nh, D)
        kq, ks = quantize_kv(randn(B, T, nkv, D))
        vq, vs = quantize_kv(randn(B, T, nkv, D))
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        scale = D ** -0.5
        live = lengths > 0
        got = kc.flash_decode_attention(q, kq, vq, lengths, scale, ks, vs)
        err = _check(f"flash_decode_int8 B={B} S={S} H={nh} Hkv={nkv}", got,
                     kc.flash_decode_attention_int8_plain(
                         q, kq, vq, lengths, scale, ks, vs), mask=live)
        _empty_rows_zero(f"flash_decode_int8 B={B} S={S} lengths={lens}",
                         got, lens, S)
        g = nh // nkv
        pos_q = lengths[:, None] - S + torch.arange(S, device=dev)[None]
        amask = (torch.arange(T, device=dev)[None, None]
                 <= pos_q[:, :, None])[:, None]  # [B, 1, S, T]
        qt = q.transpose(1, 2).contiguous()
        kt, vt = ((t.float() * sc[..., None]).to(torch.bfloat16)
                  .repeat_interleave(g, 2).transpose(1, 2).contiguous()
                  for t, sc in ((kq, ks), (vq, vs)))
        visible = sum(max(0, min(L - S + s + 1, T)) for L in lens
                      for s in range(S))
        keys_read = sum(min(L, T) for L in lens)
        nbytes = 2 * keys_read * nkv * (D + 4) + 2 * B * S * nh * D * 2
        run = lambda: kc.flash_decode_attention(  # noqa: E731
            q, kq, vq, lengths, scale, ks, vs)
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=amask, scale=scale)
        chunk = (B, S, nkv, D, lens) == (1, 512, 32, 128, [1024])
        record(kc.KERNEL_INT8, {"B": B, "S": S, "H": nh, "Hkv": nkv, "T": T,
                                "D": D, "lengths": lens}, err, _time_ms(run),
               _time_ms(lambda: kc.flash_decode_attention_int8_plain(
                   q, kq, vq, lengths, scale, ks, vs)),
               _time_ms(lib), _bound(nbytes, 4 * D * nh * visible),
               main=(B, S, nkv) == (8, 1, 32) or chunk,
               variant="chunk" if chunk else None,
               extra=_c_extra(torch, kc, run, lib, q, kq))
        del q, kq, vq, ks, vs, kt, vt, qt, got
        torch.cuda.empty_cache()


def _paged_table(np, rng, lens, page_len: int, max_pages: int,
                 shared: int) -> tuple:
    """A block table over a shuffled pool: every slot's first ``shared``
    pages (fewer if it holds fewer) are one set of pages (a common prefix
    under every slot), the rest its own; the pool ids come in a random
    order and entries past a slot's pages are the NULL page 0. Returns
    (tables [B, max_pages] int32, pool pages, the rows each page must
    provide: {page: the most rows any slot reads from it})."""
    counts = [-(-L // page_len) for L in lens]
    n = min(shared, max(counts)) + sum(max(0, c - shared) for c in counts)
    ids = (rng.permutation(n) + 1).tolist()
    common = [ids.pop() for _ in range(min(shared, max(counts)))]
    tables = np.zeros((len(lens), max_pages), np.int32)
    need = {}
    for b, (L, c) in enumerate(zip(lens, counts)):
        for j in range(c):
            pid = common[j] if j < shared else ids.pop()
            tables[b, j] = pid
            need[pid] = max(need.get(pid, 0), min(page_len, L - j * page_len))
    return tables, n + 1, need


def _slot_rel_l2(name, got, want, lens) -> float:
    """The largest relative L2 distance of a live slot's kernel output from
    its plain version's; fails past ``PAGED_SLOT_REL_L2``. A slot is held
    as a whole, so a long slot's missing tile cannot hide under the
    per-entry tolerance."""
    worst = max(_rel_l2(got[b], want[b]) for b, L in enumerate(lens) if L)
    if worst > PAGED_SLOT_REL_L2:
        raise AssertionError(f"{name}: a slot's relative L2 {worst:.4g} "
                             f"past {PAGED_SLOT_REL_L2}")
    return worst


def _paged_kernel_checks(torch, F, randn, record) -> None:
    """Phase 2, C's paged variants: each against its plain version at the
    decode shape (head_dim 64 and 128), the chunk shape, a GQA shape and
    page lengths 8 and 128, with SDPA over the gathered window as the
    yardstick; and the three identities with the contiguous variants,
    which must hold bit for bit."""
    import numpy as np

    from picotron_tpu_torch.inference.kv_cache import quantize_kv
    from picotron_tpu_torch.ops.kernels import decode_attention as kc

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(SEED)
    T = 2048
    lens8 = [0, 1, 17, 128, 129, 700, 1500, 2048]
    # (B, S, H, Hkv, D, page_len, lengths, main, variant): decode at D 64
    # and 128; the chunk (S = 512 over 300 cached tokens; rows on the
    # tensor cores) at D 64 and 128, GQA, and at a ragged S x g (400 rows)
    # whose first slot's leading rows see no key; GQA decode; page lengths
    # 8 and 128
    for B, S, nh, nkv, D, pl, lens, main, variant in (
            (8, 1, 32, 32, 64, PAGE_LEN, lens8, True, None),
            (8, 1, 32, 32, 128, PAGE_LEN, lens8, True, "d128"),
            (1, 512, 32, 32, 64, PAGE_LEN, [300 + 512], True, "chunk"),
            (1, 512, 32, 32, 128, PAGE_LEN, [300 + 512], False, None),
            (1, 512, 32, 8, 64, PAGE_LEN, [300 + 512], False, None),
            (2, 100, 32, 8, 64, PAGE_LEN, [60, 1100], False, None),
            (8, 1, 32, 8, 64, PAGE_LEN, lens8, False, None),
            (8, 1, 32, 32, 64, 8, lens8, False, None),
            (8, 1, 32, 32, 64, 128, lens8, False, None)):
        maxp = T // pl
        tables, P, need = _paged_table(np, rng, lens, pl, maxp,
                                       shared=max(1, 128 // pl))
        bt = torch.tensor(tables, device=dev)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        q = randn(B, S, nh, D)
        k, v = randn(P, pl, nkv, D), randn(P, pl, nkv, D)
        kq, ks = quantize_kv(randn(P, pl, nkv, D))
        vq, vs = quantize_kv(randn(P, pl, nkv, D))
        flags = rng.integers(0, 2, P).astype(np.int32)
        flags[0] = 0
        pq = torch.tensor(flags, device=dev)
        scale = D ** -0.5
        live = lengths > 0
        shape = {"B": B, "S": S, "H": nh, "Hkv": nkv, "D": D,
                 "page_len": pl, "max_pages": maxp, "pool_pages": P,
                 "lengths": lens}
        name = f"B={B} S={S} H={nh} Hkv={nkv} D={D} page_len={pl}"

        # the identities, bit for bit
        paged = kc.flash_decode_attention(q, k, v, lengths, scale,
                                          block_tables=bt)
        paged8 = kc.flash_decode_attention(q, kq, vq, lengths, scale, ks, vs,
                                           block_tables=bt)
        gk, gv = kc.gather_window(k, bt), kc.gather_window(v, bt)
        same = {
            "paged == contiguous C": (paged, kc.flash_decode_attention(
                q, gk, gv, lengths, scale)),
            "paged int8 == C-int8": (paged8, kc.flash_decode_attention(
                q, kc.gather_window(kq, bt), kc.gather_window(vq, bt),
                lengths, scale, kc.gather_window(ks, bt),
                kc.gather_window(vs, bt))),
        }
        for flag, want in ((0, paged), (1, paged8)):
            same[f"mixed, flags {flag} == paged{' int8' if flag else ''}"] = (
                kc.flash_decode_attention(
                    q, k, v, lengths, scale, ks, vs, block_tables=bt,
                    k_quant=kq, v_quant=vq,
                    page_quant=torch.full_like(pq, flag)), want)
        diffs = {key: float((a.float() - b.float()).abs().max())
                 for key, (a, b) in same.items()}
        print(json.dumps({"identities": name, "max_abs_diff": diffs}),
              flush=True)
        if any(d != 0.0 for d in diffs.values()):
            raise AssertionError(f"paged identities broken at {name}: "
                                 f"{diffs}")
        del same, gk, gv

        # the yardstick's window: gathered (and dequantized) outside the
        # timing, GQA heads repeated, masked by position
        g = nh // nkv
        pos_q = lengths[:, None] - S + torch.arange(S, device=dev)[None]
        amask = (torch.arange(maxp * pl, device=dev)[None, None]
                 <= pos_q[:, :, None])[:, None]  # [B, 1, S, T]
        qt = q.transpose(1, 2).contiguous()
        rowflag = pq[bt.long()].repeat_interleave(pl, 1)[..., None, None]

        def sdpa_of(kw, vw):
            kt, vt = (t.to(torch.bfloat16).repeat_interleave(g, 2)
                      .transpose(1, 2).contiguous() for t in (kw, vw))
            return lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=amask, scale=scale)

        deq_k = kc.gather_window(kq, bt).float() * kc.gather_window(
            ks, bt)[..., None]
        deq_v = kc.gather_window(vq, bt).float() * kc.gather_window(
            vs, bt)[..., None]
        visible = sum(max(0, min(L - S + s + 1, maxp * pl)) for L in lens
                      for s in range(S))
        io_bytes = 2 * B * S * nh * D * 2 + B * maxp * 4 + B * 4

        def kv_bytes(row_bytes):  # each needed pool row read once
            return sum(rows * nkv * row_bytes(pid)
                       for pid, rows in need.items())

        for kern, run, plain, lib, row_bytes in (
                (kc.KERNEL_PAGED,
                 lambda: kc.flash_decode_attention(q, k, v, lengths, scale,
                                                   block_tables=bt),
                 lambda: kc.flash_decode_attention_paged_plain(
                     q, k, v, lengths, scale, bt),
                 sdpa_of(kc.gather_window(k, bt), kc.gather_window(v, bt)),
                 lambda pid: 2 * D * 2),
                (kc.KERNEL_PAGED_INT8,
                 lambda: kc.flash_decode_attention(q, kq, vq, lengths, scale,
                                                   ks, vs, block_tables=bt),
                 lambda: kc.flash_decode_attention_paged_int8_plain(
                     q, kq, vq, lengths, scale, ks, vs, bt),
                 sdpa_of(deq_k, deq_v),
                 lambda pid: 2 * (D + 4)),
                (kc.KERNEL_MIXED,
                 lambda: kc.flash_decode_attention(
                     q, k, v, lengths, scale, ks, vs, block_tables=bt,
                     k_quant=kq, v_quant=vq, page_quant=pq),
                 lambda: kc.flash_decode_attention_mixed_plain(
                     q, k, v, lengths, scale, kq, vq, ks, vs, bt, pq),
                 sdpa_of(torch.where(rowflag != 0, deq_k,
                                     kc.gather_window(k, bt).float()),
                         torch.where(rowflag != 0, deq_v,
                                     kc.gather_window(v, bt).float())),
                 lambda pid: 2 * (D + 4) if flags[pid] else 2 * D * 2)):
            got, want = run(), plain()
            err = _check(f"{kern.name} {name}", got, want, mask=live,
                         atol=PAGED_ATOL, rtol=PAGED_RTOL)
            _empty_rows_zero(f"{kern.name} {name}", got, lens, S)
            rel = _slot_rel_l2(f"{kern.name} {name}", got, want, lens)
            record(kern, shape, err, _time_ms(run), _time_ms(plain),
                   _time_ms(lib),
                   _bound(kv_bytes(row_bytes) + io_bytes,
                          4 * D * nh * visible),
                   main=main, variant=variant,
                   library="F.scaled_dot_product_attention over the "
                           "gathered window",
                   extra={"max_slot_rel_l2": rel,
                          **_c_extra(torch, kc, run, lib, q, k, bt),
                          "tolerance": {"atol": PAGED_ATOL,
                                        "rtol": PAGED_RTOL,
                                        "slot_rel_l2": PAGED_SLOT_REL_L2}})
            del got, want
            del lib
        del q, k, v, kq, vq, ks, vs, deq_k, deq_v, amask, qt, rowflag
        torch.cuda.empty_cache()


def _c_verify_row(torch, F, kc, kernel, name, shape, q, k, v, lengths,
                  scale, record, variant, main=True, k_scale=None,
                  v_scale=None, block_tables=None, k_quant=None,
                  v_quant=None, page_quant=None, plain=None,
                  windows=None, kv_bytes=None) -> None:
    """One C row at the verify shape: the kernel against its plain version
    (every live slot; rows that see no key exactly 0), one launch a call
    and the same bits twice (``_c_extra``), SDPA over the (gathered,
    dequantized) window as the yardstick, and the bound: each key a slot
    reads once (``kv_bytes``, or the window's), q and the output once, the
    products of the visible (query, key) pairs."""
    B, S, nh, D = q.shape
    nkv = k.shape[-2]
    g = nh // nkv
    lens = lengths.tolist()
    run = lambda: kc.flash_decode_attention(  # noqa: E731
        q, k, v, lengths, scale, k_scale=k_scale, v_scale=v_scale,
        block_tables=block_tables, k_quant=k_quant, v_quant=v_quant,
        page_quant=page_quant)
    got, want = run(), plain()
    live = lengths > 0
    tol = ({"atol": PAGED_ATOL, "rtol": PAGED_RTOL}
           if block_tables is not None else {})
    err = _check(f"{kernel.name} {name}", got, want, mask=live, **tol)
    _empty_rows_zero(f"{kernel.name} {name}", got, lens, S)
    kw, vw = windows
    T = kw.shape[1]
    pos_q = lengths[:, None] - S + torch.arange(S, device=q.device)[None]
    amask = (torch.arange(T, device=q.device)[None, None]
             <= pos_q[:, :, None])[:, None]  # [B, 1, S, T]
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (t.to(torch.bfloat16).repeat_interleave(g, 2).transpose(1, 2)
              .contiguous() for t in (kw, vw))
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=amask, scale=scale)
    visible = sum(max(0, min(L - S + s + 1, T)) for L in lens
                  for s in range(S))
    if kv_bytes is None:
        row = 2 * (D + 4) if k.dtype == torch.int8 else 2 * D * 2
        kv_bytes = sum(min(L, T) for L in lens) * nkv * row
    nbytes = kv_bytes + 2 * B * S * nh * D * 2
    record(kernel, {**shape, "lengths": lens}, err, _time_ms(run),
           _time_ms(plain), _time_ms(lib), _bound(nbytes, 4 * D * nh * visible),
           main=main, variant=variant,
           library="F.scaled_dot_product_attention over the "
                   + ("gathered window" if block_tables is not None
                      else "window"),
           extra=_c_extra(torch, kc, run, lib, q, k, block_tables))


def _verify_kernel_checks(torch, F, randn, record) -> None:
    """Phase 2 at the verify shape of speculative decoding (spec_len 4:
    8 slots of S = 5 rows, each at its own offset): C in its five
    variants at the decode windows (T 2048, C-int8 4096), head_dim 64 and
    128, lengths that leave a slot free and cross a 128-key tile (the
    decode tile, S x g = 5); one GQA row (g = 4: S x g = 20 rows, the
    chunk rows on wgmma); G at M 40 (8 x 5 rows: its wgmma path) on
    Llama-2-7B's w_up and lm_head shapes. H's verify rows (B 8, S 5) run
    with its other rows (``_lora_kernel_checks``)."""
    import numpy as np

    from picotron_tpu_torch.inference.kv_cache import quantize_kv
    from picotron_tpu_torch.ops.kernels import decode_attention as kc

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(SEED + 2)
    S, T = VERIFY_S, 2048
    # contiguous bf16, D 64 and 128, and the GQA row
    for D, nh, nkv, variant in ((64, 32, 32, "verify"),
                                (128, 32, 32, "verify_d128"),
                                (64, 32, 8, "verify_gqa")):
        q = randn(8, S, nh, D)
        k, v = randn(8, T, nkv, D), randn(8, T, nkv, D)
        lengths = torch.tensor(VERIFY_LENS, dtype=torch.int32, device=dev)
        scale = D ** -0.5
        _c_verify_row(
            torch, F, kc, kc.KERNEL, f"verify B=8 S={S} Hkv={nkv} D={D}",
            {"B": 8, "S": S, "H": nh, "Hkv": nkv, "T": T, "D": D}, q, k, v,
            lengths, scale, record, variant,
            plain=lambda: kc.flash_decode_attention_plain(
                q, k, v, lengths, scale), windows=(k, v))
        del q, k, v
    # C-int8 at Llama-2-7B's window and head dim, and at D 64
    T8 = 4096
    for D, variant in ((128, "verify"), (64, "verify_d64")):
        q = randn(8, S, 32, D)
        kq, ks = quantize_kv(randn(8, T8, 32, D))
        vq, vs = quantize_kv(randn(8, T8, 32, D))
        lengths = torch.tensor(VERIFY_LENS_INT8, dtype=torch.int32,
                               device=dev)
        scale = D ** -0.5
        deq = [(t.float() * sc[..., None]) for t, sc in ((kq, ks), (vq, vs))]
        _c_verify_row(
            torch, F, kc, kc.KERNEL_INT8, f"verify B=8 S={S} D={D}",
            {"B": 8, "S": S, "H": 32, "Hkv": 32, "T": T8, "D": D}, q, kq,
            vq, lengths, scale, record, variant, k_scale=ks, v_scale=vs,
            plain=lambda: kc.flash_decode_attention_int8_plain(
                q, kq, vq, lengths, scale, ks, vs), windows=deq)
        del q, kq, vq, ks, vs, deq
        torch.cuda.empty_cache()
    # the paged variants over a shuffled pool of 16-row pages
    maxp = T // PAGE_LEN
    for D, variant in ((64, "verify"), (128, "verify_d128")):
        tables, P, need = _paged_table(np, rng, VERIFY_LENS, PAGE_LEN, maxp,
                                       shared=128 // PAGE_LEN)
        bt = torch.tensor(tables, device=dev)
        lengths = torch.tensor(VERIFY_LENS, dtype=torch.int32, device=dev)
        q = randn(8, S, 32, D)
        k, v = randn(P, PAGE_LEN, 32, D), randn(P, PAGE_LEN, 32, D)
        kq, ks = quantize_kv(randn(P, PAGE_LEN, 32, D))
        vq, vs = quantize_kv(randn(P, PAGE_LEN, 32, D))
        flags = rng.integers(0, 2, P).astype(np.int32)
        flags[0] = 0
        pq = torch.tensor(flags, device=dev)
        scale = D ** -0.5
        shape = {"B": 8, "S": S, "H": 32, "Hkv": 32, "D": D,
                 "page_len": PAGE_LEN, "max_pages": maxp, "pool_pages": P}
        gk, gv = kc.gather_window(k, bt), kc.gather_window(v, bt)
        dk = (kc.gather_window(kq, bt).float()
              * kc.gather_window(ks, bt)[..., None])
        dv = (kc.gather_window(vq, bt).float()
              * kc.gather_window(vs, bt)[..., None])
        rowflag = pq[bt.long()].repeat_interleave(PAGE_LEN, 1)[..., None,
                                                                None]
        io = 8 * maxp * 4 + 8 * 4  # the tables and the lengths

        def kv_bytes(row_bytes):  # each needed pool row read once
            return io + sum(rows * 32 * row_bytes(pid)
                            for pid, rows in need.items())

        name = f"verify B=8 S={S} D={D} page_len={PAGE_LEN}"
        _c_verify_row(
            torch, F, kc, kc.KERNEL_PAGED, name, shape, q, k, v, lengths,
            scale, record, variant, block_tables=bt,
            plain=lambda: kc.flash_decode_attention_paged_plain(
                q, k, v, lengths, scale, bt), windows=(gk, gv),
            kv_bytes=kv_bytes(lambda pid: 2 * D * 2))
        _c_verify_row(
            torch, F, kc, kc.KERNEL_PAGED_INT8, name, shape, q, kq, vq,
            lengths, scale, record, variant, k_scale=ks, v_scale=vs,
            block_tables=bt,
            plain=lambda: kc.flash_decode_attention_paged_int8_plain(
                q, kq, vq, lengths, scale, ks, vs, bt), windows=(dk, dv),
            kv_bytes=kv_bytes(lambda pid: 2 * (D + 4)))
        _c_verify_row(
            torch, F, kc, kc.KERNEL_MIXED, name, shape, q, k, v, lengths,
            scale, record, variant, k_scale=ks, v_scale=vs, block_tables=bt,
            k_quant=kq, v_quant=vq, page_quant=pq,
            plain=lambda: kc.flash_decode_attention_mixed_plain(
                q, k, v, lengths, scale, kq, vq, ks, vs, bt, pq),
            windows=(torch.where(rowflag != 0, dk, gk.float()),
                     torch.where(rowflag != 0, dv, gv.float())),
            kv_bytes=kv_bytes(lambda pid: 2 * (D + 4) if flags[pid]
                              else 2 * D * 2))
        del q, k, v, kq, vq, ks, vs, gk, gv, dk, dv, rowflag
        torch.cuda.empty_cache()
    _counters_zero(torch, kc)
    # G at the verify's 40 rows: Llama-2-7B's w_up and lm_head
    from picotron_tpu_torch.ops.kernels import quant_matmul as kg

    for N, variant in ((11008, "verify"), (32000, "verify_lm_head")):
        _g_row(torch, randn, record, VERIFY_M, 4096, N, main=True,
               variant=variant)
    torch.cuda.synchronize()
    for d, (_, counters) in kg.SCRATCH.items():
        if bool(counters.any()):
            raise AssertionError(f"G's split-K counters on {d} are not all "
                                 f"zero: {int((counters != 0).sum())} set")
    torch.cuda.empty_cache()


def _launches_a_call(torch, name, fn, mark, per_call=1) -> tuple:
    """The device side of ``fn`` from a profiler trace of 10 calls, which
    must hold ``per_call`` device kernels a call, exactly one of whose
    names holds ``mark`` (a trace may come back one event short, as C's
    rows allow): (device ms of a call, events a call, kernel names)."""
    iters = 10
    ms, got, names = _device_trace(torch, fn, iters, per_call=per_call)
    if sum(mark in n for n in names) != 1 or len(names) != per_call \
            or not (per_call * iters - 1) / iters <= got <= per_call:
        raise AssertionError(f"{name}: {got} device launches a call, not "
                             f"{per_call} with one {mark}: {names}")
    return ms * per_call / got, got, names


def _fused_check(name, got, want, resid, bf16: bool) -> float:
    """H's fused mode against its plain version: |d| <= LORA_ATOL +
    LORA_RTOL * |plain|, and for a bf16 base one bf16 rounding step more
    of the output and of the cast residual (2^-7 of |plain| + |residual|):
    the kernel's residual and the plain one differ by ~1e-6, which may
    move either rounding by a step."""
    import torch

    got, want, resid = got.float(), want.float(), resid.float()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    bound = LORA_ATOL + LORA_RTOL * want.abs()
    if bf16:
        bound = bound + 2.0 ** -7 * (want.abs() + resid.abs())
    err = (got - want).abs()
    bad = err > bound
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} entries outside tolerance, max abs "
            f"err {float(err.max()):.4g}")
    return float(err.max())


def _lora_kernel_checks(torch, randn, record) -> None:
    """Phase 2, kernel H in both modes: the segmented LoRA residual
    (``segmented_lora``) and the residual added into a base output in
    place (``segmented_lora_add_``, what the model's seam runs), at the
    SmolLM-1.7B projections' shapes at decode (8 rows, null rows among
    them, one adapter of rank 4 in the rank-16 pack) and at a prefill
    chunk (1 row, S = 512), Llama-2-7B's at decode, and a ragged shape
    with bf16 and fp32 x. Residual mode: against its plain version at
    ``LORA_ATOL``, null rows exactly 0. Fused mode: bit for bit residual
    mode + PyTorch's cast and add, null rows bit for bit the base, and
    against its plain version (``_fused_check``). Both: the same bits when
    called twice, one device kernel a call in a trace. Yardsticks: two
    ``torch.bmm`` over the rows' adapters gathered outside the timing
    (and, fused, PyTorch's cast and add after them). At the SmolLM decode
    shape the seam ``llama.matmul`` over an adapter leaf on a bf16 base
    must run two device kernels a call: the base product and H."""
    from picotron_tpu_torch.models import llama
    from picotron_tpu_torch.ops.kernels import lora_matmul as kh

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)

    def pack(K, N):
        a = torch.zeros(H_SLOTS, K, H_RANK, device=dev)
        b = torch.zeros(H_SLOTS, H_RANK, N, device=dev)
        for slot, r in H_ADAPTERS:
            a[slot, :, :r] = 0.05 * torch.randn((K, r), generator=gen,
                                                device=dev)
            b[slot, :r] = 0.05 * torch.randn((r, N), generator=gen,
                                             device=dev)
        return a, b

    cases = ([(8, 1, K, N, H_DECODE_IDS, "bf16") for K, N in H_SMOL_SHAPES]
             + [(1, 512, K, N, (1,), "bf16") for K, N in H_SMOL_SHAPES]
             + [(8, VERIFY_S, 2048, 2048, H_DECODE_IDS, "bf16")]
             + [(8, 1, K, N, H_DECODE_IDS, "bf16") for K, N in H_7B_SHAPES]
             + [(3, 37, 1000, 1500, (2, 0, 3), x_dt)
                for x_dt in ("bf16", "fp32")])
    for B, S, K, N, id_list, x_dt in cases:
        a, b = pack(K, N)
        x = randn(B, S, K)
        if x_dt == "fp32":
            x = x.float()
        ids = torch.tensor(id_list, dtype=torch.int32, device=dev)
        name = f"lora_matmul B={B} S={S} K={K} N={N} x={x_dt}"
        got = kh.segmented_lora(x, a, b, ids)
        want = kh.lora_matmul_plain(x, a, b, ids)
        err = _check(name, got, want, atol=LORA_ATOL, rtol=LORA_RTOL)
        if not torch.equal(kh.segmented_lora(x, a, b, ids), got):
            raise AssertionError(f"{name}: two calls differ")
        null = ids == 0
        null_max = float(got[null].abs().max()) if bool(null.any()) else 0.0
        if null_max != 0.0:
            raise AssertionError(f"{name}: null rows not exactly 0 (max "
                                 f"|out| {null_max})")
        # fused mode on a base output of x's dtype
        base = randn(B, S, N).to(x.dtype)
        fused = kh.segmented_lora_add_(base.clone(), x, a, b, ids)
        if not torch.equal(fused, base + got.to(base.dtype)):
            raise AssertionError(f"{name}: fused mode is not residual mode "
                                 "+ cast + add bit for bit")
        if bool(null.any()) and not torch.equal(fused[null], base[null]):
            raise AssertionError(f"{name}: fused mode changed null rows")
        if not torch.equal(kh.segmented_lora_add_(base.clone(), x, a, b,
                                                  ids), fused):
            raise AssertionError(f"{name}: two fused calls differ")
        bf16 = base.dtype == torch.bfloat16
        err_f = _fused_check(name + " fused", fused,
                             kh.lora_add_plain(base, x, a, b, ids), want,
                             bf16)
        xf, ag, bg = x.float(), a[ids.long()], b[ids.long()]
        live = sum(i != 0 for i in id_list)
        adapters = {i for i in id_list if i != 0}
        common = (live * S * K * x.element_size() + B * 4
                  + len(adapters) * (K + N) * H_RANK * 4)
        flops = 2 * live * S * (K + N) * H_RANK
        shape = {"B": B, "S": S, "K": K, "N": N, "R": H_RANK,
                 "slots": H_SLOTS, "ids": list(id_list), "x": x_dt,
                 "plan": kh.plan(B, S, K, N, H_RANK)}
        decode = (B, S, K, N) == (8, 1, 2048, 2048)
        chunk = (B, S, K, N) == (1, 512, 2048, 2048)
        verify = (B, S, K, N) == (8, VERIFY_S, 2048, 2048)
        run = lambda: kh.segmented_lora(x, a, b, ids)  # noqa: E731
        lib = lambda: torch.bmm(torch.bmm(xf, ag), bg)  # noqa: E731
        ms, per, names = _launches_a_call(torch, name, run, "lora_kernel")
        record(kh.KERNEL, {**shape, "mode": "residual"}, err, _time_ms(run),
               _time_ms(lambda: kh.lora_matmul_plain(x, a, b, ids)),
               _time_ms(lib), _bound(common + B * S * N * 4, flops),
               main=decode or chunk or verify,
               variant=("residual" if decode else "residual_verify"
                        if verify else "residual_chunk"),
               library="torch.bmm twice over a[ids], b[ids] gathered "
                       "outside the timing",
               extra={"null_rows_max_abs": null_max,
                      "tolerance": {"atol": LORA_ATOL, "rtol": LORA_RTOL},
                      "device_ms": ms, "device_kernels": names,
                      "device_events_per_call": per,
                      "library_device_ms": _device_ms(torch, lib)})
        work = base.clone()
        run_f = lambda: kh.segmented_lora_add_(  # noqa: E731
            work, x, a, b, ids)
        lib_f = lambda: base + lib().to(base.dtype)  # noqa: E731
        ms_f, per_f, names_f = _launches_a_call(torch, name + " fused",
                                                run_f, "lora_kernel")
        extra = {"fused_equals_residual_cast_add": True,
                 "null_rows_equal_base": True,
                 "tolerance": {"atol": LORA_ATOL, "rtol": LORA_RTOL,
                               "bf16_steps": 2.0 ** -7 if bf16 else 0.0},
                 "device_ms": ms_f, "device_kernels": names_f,
                 "device_events_per_call": per_f,
                 "library_device_ms": _device_ms(torch, lib_f)}
        if decode:
            extra.update(_seam_check(torch, llama, x, a, b, ids, K, N,
                                     randn))
        record(kh.KERNEL, {**shape, "mode": "fused"}, err_f, _time_ms(run_f),
               _time_ms(lambda: kh.lora_add_plain(base, x, a, b, ids)),
               _time_ms(lib_f),
               _bound(common + 2 * live * S * N * base.element_size(),
                      flops),
               main=decode or chunk or verify,
               variant=("chunk" if chunk else "verify" if verify
                        else None),
               library="torch.bmm twice over a[ids], b[ids] gathered "
                       "outside the timing, then the cast and the add",
               extra=extra)
        del a, b, x, xf, ag, bg, got, want, base, fused, work
    torch.cuda.empty_cache()


def _seam_check(torch, llama, x, a, b, ids, K, N, randn) -> dict:
    """The model's seam on the card: ``llama.matmul`` over an adapter leaf
    on a bf16 base weight is the base product + H added in place, bit for
    bit, and two device kernels a call (no cast, no add)."""
    from picotron_tpu_torch.ops.kernels import lora_matmul as kh

    w = randn(K, N) * 0.02
    leaf = {"w": w, "a": a, "b": b, "ids": ids}
    got = llama.matmul(x, leaf)
    want = (x @ w) + kh.segmented_lora(x, a, b, ids).to(x.dtype)
    if not torch.equal(got, want):
        raise AssertionError("the seam is not base + H's residual cast and "
                             "added, bit for bit")
    ms, per, names = _launches_a_call(
        torch, "llama.matmul over an adapter leaf",
        lambda: llama.matmul(x, leaf), "lora_kernel", per_call=2)
    return {"seam_device_ms": ms, "seam_events_per_call": per,
            "seam_kernels": names}


def _fwd_bwd_calls(torch, fwd, inputs, grad_out) -> tuple:
    """(forward + backward, forward alone) of a library call under
    autograd, for ``inputs`` that require gradients."""
    def both():
        for t in inputs:
            t.grad = None
        fwd().backward(grad_out)

    def fwd_only():
        with torch.no_grad():
            fwd()

    return both, fwd_only


def _fwd_bwd_less_fwd_ms(torch, fwd, inputs, grad_out) -> float:
    """A library call's backward time: forward + backward less forward
    (CUDA events around the calls)."""
    both, fwd_only = _fwd_bwd_calls(torch, fwd, inputs, grad_out)
    return _time_ms(both) - _time_ms(fwd_only)


def _fwd_bwd_less_fwd_device_ms(torch, fwd, inputs, grad_out) -> float:
    """The same from profiler traces: the device time of forward +
    backward less the forward's."""
    both, fwd_only = _fwd_bwd_calls(torch, fwd, inputs, grad_out)
    return _device_ms(torch, both) - _device_ms(torch, fwd_only)


def _training_kernel_checks(torch, F, randn, record) -> None:
    """Phase 2, training kernels: D (RMSNorm backward), B with its LSE, E
    (dQ) and F (dK/dV) at the training shapes, a ragged shape and a GQA
    shape."""
    from picotron_tpu_torch.ops.kernels import flash_attention as kb
    from picotron_tpu_torch.ops.kernels import rmsnorm as ka

    # D: RMSNorm backward at D_SHAPES, each one device kernel a call, the
    # same bits when called twice
    eps = 1e-5
    for rows, H in D_SHAPES:
        x, dy = randn(rows, H), randn(rows, H)
        w = (1.0 + 0.1 * randn(H).float()).to(torch.bfloat16)
        run = lambda: ka.rms_norm_bwd(x, w, dy, eps)  # noqa: E731
        name = f"rmsnorm_bwd rows={rows} H={H}"
        (dx, dw), (dx2, dw2) = run(), run()
        if not (torch.equal(dx, dx2) and torch.equal(dw, dw2)):
            raise AssertionError(f"{name}: two calls on the same inputs "
                                 "differ")
        pdx, pdw = ka.rms_norm_bwd_plain(x, w, dy, eps)
        err = max(_check(f"{name} dx", dx, pdx),
                  _check(f"{name} dw", dw, pdw))
        ms, _, names = _launches_a_call(torch, name, run, "rmsnorm_bwd")
        lib = lib_dev = None
        if hasattr(F, "rms_norm"):
            xl = x.clone().requires_grad_(True)
            wl = w.clone().requires_grad_(True)
            fwd = lambda: F.rms_norm(xl, (H,), wl, eps)  # noqa: E731
            lib = _fwd_bwd_less_fwd_ms(torch, fwd, (xl, wl), dy)
            lib_dev = _fwd_bwd_less_fwd_device_ms(torch, fwd, (xl, wl), dy)
            del xl, wl
        record(ka.KERNEL_BWD, {"rows": rows, "H": H}, err, _time_ms(run),
               _time_ms(lambda: ka.rms_norm_bwd_plain(x, w, dy, eps)),
               lib, _bound((3 * rows * H + 2 * H) * 2, 0.0),
               main=(rows, H) == (8192, 2048) or (rows, H) in D_VARIANTS,
               variant=D_VARIANTS.get((rows, H)),
               extra={"device_ms": ms, "library_device_ms": lib_dev,
                      "device_kernels": names,
                      "plan": ka.plan_bwd(rows, H,
                                          ka.sm_count(x.device.index))})
        del x, dy, dx, dw, dx2, dw2, pdx, pdw

    # B with its LSE, E and F: [4, 2048, 32, 64] (the training shape), a
    # ragged S, one GQA shape (g = 4), and the GQA shape at head_dim 128
    for B, S, nh, nkv, D in ((4, 2048, 32, 32, 64), (2, 130, 32, 32, 64),
                             (1, 1024, 32, 8, 64), (1, 1024, 32, 8, 128)):
        scale = D ** -0.5
        q, k, v = randn(B, S, nh, D), randn(B, S, nkv, D), randn(B, S, nkv, D)
        do = randn(B, S, nh, D)
        shape = {"B": B, "S": S, "H": nh, "Hkv": nkv, "D": D}
        main = (B, S, nkv) == (4, 2048, 32)
        pairs = B * nh * S * (S + 1) / 2  # causal (query, key) pairs
        qo_bytes = B * S * nh * D * 2
        kv_bytes = B * S * nkv * D * 2
        row_bytes = B * nh * S * 4  # an fp32 [B, H, S] array

        o, lse = kb.flash_attention_fwd(q, k, v, scale, return_lse=True)
        po, plse = kb.flash_attention_plain(q, k, v, scale, return_lse=True)
        err = max(_check(f"flash_attention+lse out {shape}", o, po),
                  _check(f"flash_attention+lse lse {shape}", lse, plse))
        g = nh // nkv
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in
                      (q, k.repeat_interleave(g, 2), v.repeat_interleave(g, 2)))
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True, scale=scale)
        record(kb.KERNEL, {**shape, "lse": True}, err,
               _time_ms(lambda: kb.flash_attention_fwd(q, k, v, scale, True)),
               _time_ms(lambda: kb.flash_attention_plain(q, k, v, scale,
                                                         True)),
               _time_ms(sdpa),
               _bound(2 * qo_bytes + 2 * kv_bytes + row_bytes, 4 * D * pairs),
               main=main, variant="lse")

        # E: dq and delta; F: dk, dv from E's delta
        dq, delta = kb.flash_attention_bwd_dq(q, k, v, o, lse, do, scale)
        pdq, pdelta = kb.flash_attention_bwd_dq_plain(q, k, v, o, lse, do,
                                                      scale)
        err_e = max(_check(f"bwd_dq dq {shape}", dq, pdq),
                    _check(f"bwd_dq delta {shape}", delta, pdelta))
        dk, dv = kb.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale)
        pdk, pdv = kb.flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta,
                                                    scale)
        err_f = max(_check(f"bwd_dkv dk {shape}", dk, pdk),
                    _check(f"bwd_dkv dv {shape}", dv, pdv))
        leaves = [t.detach().clone().requires_grad_(True) for t in (qt, kt, vt)]
        lib = _fwd_bwd_less_fwd_ms(
            torch, lambda: F.scaled_dot_product_attention(
                *leaves, is_causal=True, scale=scale),
            leaves, do.transpose(1, 2).contiguous())
        del leaves
        record(kb.KERNEL_DQ, shape, err_e,
               _time_ms(lambda: kb.flash_attention_bwd_dq(q, k, v, o, lse, do,
                                                          scale)),
               _time_ms(lambda: kb.flash_attention_bwd_dq_plain(
                   q, k, v, o, lse, do, scale)),
               lib,
               _bound(4 * qo_bytes + 2 * kv_bytes + 2 * row_bytes,
                      6 * D * pairs), main=main)
        record(kb.KERNEL_DKV, shape, err_f,
               _time_ms(lambda: kb.flash_attention_bwd_dkv(
                   q, k, v, do, lse, delta, scale)),
               _time_ms(lambda: kb.flash_attention_bwd_dkv_plain(
                   q, k, v, do, lse, delta, scale)),
               lib,
               _bound(2 * qo_bytes + 4 * kv_bytes + 2 * row_bytes,
                      8 * D * pairs), main=main)
        torch.cuda.empty_cache()


def _greedy_gap(torch, llama, params, cfg, res) -> float:
    """The worst gap between a generated token's logit and the top logit
    of a full-sequence forward of ``params`` over prompt + generated
    tokens."""
    seq = res.prompt + res.tokens
    toks = torch.tensor([seq], dtype=torch.int64, device=DEVICE)
    logits = llama.forward_logits(params, toks, cfg)[0].float()
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{res.uid}: non-finite reference logits")
    n = len(res.prompt)
    rows = logits[n - 1: len(seq) - 1]
    picked = rows.gather(1, torch.tensor(res.tokens, device=DEVICE)[:, None])
    return float((rows.amax(dim=1) - picked[:, 0]).max())


def _greedy_agrees(torch, llama, params, cfg, res) -> float:
    """``_greedy_gap``, which must stay within ``LOGIT_MARGIN``: the
    KV-cache path (prefill, chunks, decode blocks) must reproduce the
    full-sequence model up to bf16 noise. A wrong cache position or mask
    would pick tokens far from the top (about two units below it for a
    random token of this model)."""
    gap = _greedy_gap(torch, llama, params, cfg, res)
    if gap > LOGIT_MARGIN:
        raise AssertionError(
            f"{res.uid}: a greedy token sits {gap:.3f} below the "
            f"full-sequence top logit (margin {LOGIT_MARGIN})")
    return gap


def _profile(torch, run, path: str, with_wall: bool = False):
    """Phases 4 to 7: ``run`` (a main path's work once more) under
    torch.profiler. Prints one ``{"profile": ...}`` line: the wall time,
    the summed device time of every kernel (one stream, so kernels do not
    overlap and the sum over the wall is the device's busy share), the
    kernels that took the most device time, and C's, A's and D's kernels.
    Returns every kernel's device milliseconds by name (and, with
    ``with_wall``, the wall milliseconds beside them)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the device's own events (kernels, copies) from the raw trace: the
    # per-operator tables of key_averages() take minutes to build over a
    # serving run's millions of host events
    calls, dev_ms = {}, {}
    for e in prof.profiler.kineto_results.events():
        name, ms = e.name(), e.duration_ns() / 1e6
        if str(e.device_type()).endswith("CUDA") and ms > 0:
            calls[name] = calls.get(name, 0) + 1
            dev_ms[name] = dev_ms.get(name, 0.0) + ms
    busy_ms = sum(dev_ms.values())
    top = sorted(dev_ms, key=dev_ms.get, reverse=True)[:15]
    print(json.dumps({"profile": {
        "path": path, "wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / (wall * 1e3),
        "device_kernels": sum(calls.values()),
        "top": [{"name": name[:90], "calls": calls[name],
                 "device_ms": dev_ms[name]} for name in top],
        # kernel C's launches (each a split walk with its merge folded
        # in) and A's and D's, whatever their rank
        **{key: [{"name": name[:90], "calls": calls[name],
                  "device_ms": dev_ms[name]}
                 for name in sorted(dev_ms) if mark in name]
           for key, mark in (("decode_attention", "flash_decode"),
                             ("rmsnorm", "rmsnorm"))}}}), flush=True)
    merge = [name for name in dev_ms if "flash_decode_merge" in name]
    if merge:
        raise AssertionError(f"{path}: a separate merge kernel ran: {merge}")
    return (dev_ms, wall * 1e3) if with_wall else dev_ms


# device kernels of a library (cuBLAS GEMMs, PyTorch's attention) that the
# int8 path must not run: every product there is G, every attend C-int8
LIBRARY_KERNEL_MARKS = ("gemm", "gemv", "nvjet", "cublas", "xmma", "cutlass",
                        "fmha", "pytorch_flash", "efficient_attention")


def _requests(np, vocab: int, tag: str) -> list:
    """The serving paths' 8 requests: prompts of ``PROMPT_LENS`` tokens
    from the seed, ``NEW_TOKENS`` each, ``SAMPLED`` at temperature 0.8 and
    top-p 0.9, the rest greedy."""
    from picotron_tpu_torch.inference.batcher import Request

    rng = np.random.default_rng(SEED)
    return [Request(f"{tag}{i}", rng.integers(0, vocab, n).tolist(),
                    max_new_tokens=NEW_TOKENS,
                    temperature=0.8 if i in SAMPLED else 0.0,
                    top_p=0.9 if i in SAMPLED else 1.0)
            for i, n in enumerate(PROMPT_LENS)]


def _serve_phase(torch, np, card, config: str, label: str, int8: bool,
                 path_kernels, all_kernels, keep=None) -> dict:
    """Phases 3, 4 and 7, one serving path: the model of ``config`` at full
    width and depth (random weights from a fixed seed; with ``int8``
    quantized on the card, int8 KV cache) behind InferenceEngine +
    ContinuousBatcher with ``attend_impl="flash"``, serving 8 requests.
    Every kernel's count is set to 0 just before the run and read just
    after; returns those counts. Every request must return its full
    budget of in-vocabulary tokens, only ``path_kernels`` may launch and
    each must, and each greedy stream must agree with a full-sequence
    forward of the same weights. Then the requests once more under the
    profiler (on the int8 path no library GEMM or attention kernel may
    appear), and the generate command line on the same config, on the
    card by default (its launches are not part of the counted run).
    ``keep`` (a dict) receives the run's decode figures and greedy streams
    for the speculation phase to print beside its own."""
    from picotron_tpu_torch.config import Config
    from picotron_tpu_torch.inference.batcher import ContinuousBatcher, Request
    from picotron_tpu_torch.inference.engine import InferenceEngine
    from picotron_tpu_torch.models import llama
    from picotron_tpu_torch.tools import generate

    cfg = Config.from_json(config)
    dtypes = []
    if int8:
        cfg.inference.weight_dtype = "int8"
        cfg.inference.kv_cache_dtype = "int8"
        dtypes = ["--weight-dtype", "int8", "--kv-cache-dtype", "int8"]
    m = cfg.model
    t0 = time.perf_counter()
    engine = InferenceEngine(cfg, DEVICE, slots=8, attend_impl="flash")
    params = llama.init_params(engine.cfg.model, seed=SEED,
                               device=engine.device)
    if int8:  # the dense tree lives only until quantize_params returns
        params = llama.quantize_params(params)
    torch.cuda.synchronize()
    print(f"engine: {m.name} L={m.num_hidden_layers} H={m.hidden_size} "
          f"heads={m.num_attention_heads}/{m.num_key_value_heads} "
          f"ffn={m.intermediate_size} vocab={m.vocab_size} {m.dtype}, "
          f"weights={engine.weight_dtype} "
          f"kv={str(engine.cache_dtype).removeprefix('torch.')} "
          f"window={engine.max_seq_len}, slots={engine.slots} "
          f"block={engine.decode_block_len} "
          f"prefill_chunk={engine.prefill_chunk} attend=flash, built in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    # warm-up (allocator and library set-up), outside the counted run
    ContinuousBatcher(engine, params, seed=SEED).run(
        [Request("warm", list(range(1, 25)), max_new_tokens=2)])
    requests = _requests(np, m.vocab_size, "r")
    batcher = ContinuousBatcher(engine, params, seed=SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kern in all_kernels:
        kern.launches = 0
    t0 = time.perf_counter()
    results = batcher.run(requests)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {kern.name: kern.launches for kern in all_kernels}
    launches = {kern.name: counts[kern.name] for kern in path_kernels}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    for r in requests:
        res = results[r.uid]
        if (len(res.tokens) != NEW_TOKENS or res.finish_reason != "length"
                or not all(0 <= t < m.vocab_size for t in res.tokens)):
            raise AssertionError(f"{r.uid}: {len(res.tokens)} tokens, "
                                 f"{res.finish_reason}")
    idle = [name for name, n in launches.items() if n == 0]
    if idle:
        raise AssertionError(
            f"kernels not launched on the {label} path: {idle}")
    stray = {k: n for k, n in counts.items() if n and k not in launches}
    if stray:
        raise AssertionError(f"kernels of another path launched on the "
                             f"{label} path: {stray}")
    stats = batcher.stats()
    ttft = sorted(results[r.uid].ttft_s for r in requests)
    decode_tokens = batcher.generated_tokens - len(requests)
    # the reference runs the same weights (int8 ones through G) and
    # full-precision attention through B: what it checks is the cache
    # (int8 or not) and the cached-path plumbing
    gaps = {r.uid: _greedy_agrees(torch, llama, params, engine.cfg,
                                  results[r.uid])
            for i, r in enumerate(requests) if i not in SAMPLED}
    print(json.dumps({
        "main_path": label, "card": card, "requests": len(requests),
        "prompt_lens": list(PROMPT_LENS), "new_tokens_each": NEW_TOKENS,
        "wall_s": wall,
        "ttft_p50_s": ttft[len(ttft) // 2], "ttft_max_s": ttft[-1],
        "decode_tokens_per_s": decode_tokens / batcher.decode_seconds,
        "tokens_per_s": batcher.generated_tokens / wall,
        "decode_dispatches": batcher.decode_dispatches,
        "prefill_dispatches": batcher.prefill_dispatches,
        **{k: stats[k] for k in ("weight_dtype", "weight_bytes",
                                 "kv_cache_dtype", "cache_bytes")},
        "peak_mem_gib": peak_gib, "launches": launches,
        "greedy_max_logit_gap": max(gaps.values()),
        "greedy_logit_gaps": gaps}), flush=True)
    if keep is not None:
        keep.update(_decode_figures(batcher, len(requests)),
                    streams={r.uid: results[r.uid].tokens
                             for i, r in enumerate(requests)
                             if i not in SAMPLED})

    names = _profile(torch, lambda: ContinuousBatcher(
        engine, params, seed=SEED).run(_requests(np, m.vocab_size, "p")),
        "serve_int8" if int8 else "serve")
    library = [n for n in names
               if any(mark in n.lower() for mark in LIBRARY_KERNEL_MARKS)]
    if int8 and library:
        raise AssertionError(f"library kernels on the {label} path: "
                             f"{library}")
    del engine, params, batcher, results
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    rc = generate.main(["--config", config, "--random-init", "--seed", "1",
                        "--prompt-ids", "5,276,388", "--prompt-ids",
                        ",".join(str(i) for i in range(1, 41)),
                        "--max-new-tokens", "8", "--slots", "2",
                        "--attend-impl", "flash", *dtypes])
    if rc != 0:
        raise AssertionError(f"generate CLI ({label}) exited {rc}")
    print(f"generate CLI ({label}) passed in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    torch.cuda.empty_cache()
    return counts


def _paged_requests(np, vocab: int, tag: str) -> list:
    """The paged phase's 8 requests: r0-r3 one ``SYSTEM_LEN``-token system
    prompt under suffixes of ``SUFFIX_LENS`` tokens, r4 r0's prompt again,
    r5-r7 prompts of ``UNRELATED_LENS`` tokens; ``NEW_TOKENS`` each,
    ``SAMPLED`` at temperature 0.8 and top-p 0.9. The suffixes start with
    four different tokens and the unrelated prompts with tokens no other
    prompt starts with, so the radix cache's matches are exactly the
    system prompt and the repeated prompt."""
    from picotron_tpu_torch.inference.batcher import Request

    rng = np.random.default_rng(SEED)
    system = rng.integers(1, vocab, SYSTEM_LEN).tolist()
    firsts = rng.choice(np.arange(1, vocab), 8, replace=False)
    firsts = [int(t) for t in firsts if t != system[0]][:7]
    prompts = [system + [firsts[i]]
               + rng.integers(1, vocab, n - 1).tolist()
               for i, n in enumerate(SUFFIX_LENS)]
    prompts.append(list(prompts[0]))
    prompts += [[firsts[4 + i]] + rng.integers(1, vocab, n - 1).tolist()
                for i, n in enumerate(UNRELATED_LENS)]
    return [Request(f"{tag}{i}", p, max_new_tokens=NEW_TOKENS,
                    temperature=0.8 if i in SAMPLED else 0.0,
                    top_p=0.9 if i in SAMPLED else 1.0)
            for i, p in enumerate(prompts)]


def _live_page_mix(torch, batcher, hot_bf16: bool, path: str) -> dict:
    """The pool while every slot is live (after the first scheduler round):
    the allocator's page counts, which must be ``LIVE_PAGES`` and
    ``LIVE_ONE_HOLDER``, and under ``hot_bf16`` the read flags of the pages
    inside the live slots' lengths in their device tables, as the last
    decode block's C-mixed launches read them: with a shared system prompt
    those must hold both bf16 (shared) and int8 (one holder) pages."""
    st = batcher.paged.stats()
    mix = {k: st[k] for k in ("kv_pages_live", "kv_pages_shared",
                              "kv_pages_quant")}
    if (mix["kv_pages_live"], mix["kv_pages_quant"]) != (LIVE_PAGES,
                                                         LIVE_ONE_HOLDER):
        raise AssertionError(
            f"{path}: {mix['kv_pages_live']} live pages, "
            f"{mix['kv_pages_quant']} with one holder, while the slots are "
            f"live (want {LIVE_PAGES} and {LIVE_ONE_HOLDER})")
    if not hot_bf16:
        return mix
    cache = batcher._cache
    bt = cache["block_tables"].long()
    first_row = torch.arange(bt.shape[1], device=bt.device) * \
        batcher.engine.page_len
    read = bt[first_row[None] < cache["lengths"].long()[:, None]]
    flags = cache["page_quant"][read]
    mix["table_pages_bf16"] = int((flags == 0).sum())
    mix["table_pages_int8"] = int((flags == 1).sum())
    if not (0 < mix["kv_pages_quant"] < mix["kv_pages_live"]
            and mix["kv_pages_shared"] > 0
            and mix["table_pages_bf16"] > 0 and mix["table_pages_int8"] > 0):
        raise AssertionError(f"{path}: no mix of bf16 and int8 pages while "
                             f"the slots are live: {mix}")
    return mix


def _paged_serve_phase(torch, np, card, paths, all_kernels,
                       keep=None) -> dict:
    """Phase 5: SmolLM-1.7B on the paged layout, one run per entry of
    ``PAGED_RUNS`` on one set of weights. Every kernel's count is set to 0
    just before each run and read just after; returns those counts by
    path. Each run must give every request its full budget of in-vocabulary
    tokens, launch each kernel of its path (``paths``) and no other, find
    the expected prefix hits, cached tokens and copy-on-writes, and pass
    the greedy gate. The hot_bf16 run goes once more under the profiler;
    then the generate command line serves the paged hot_bf16 layout.
    ``keep`` (a dict) receives each run's decode figures by path."""
    from picotron_tpu_torch.config import Config
    from picotron_tpu_torch.inference.batcher import ContinuousBatcher, Request
    from picotron_tpu_torch.inference.engine import InferenceEngine
    from picotron_tpu_torch.models import llama
    from picotron_tpu_torch.tools import generate

    base = Config.from_json(CONFIG)
    params = llama.init_params(base.model, seed=SEED,
                               device=torch.device(DEVICE))
    m = base.model
    by_path = {}
    for path, kv_dtype, policy in PAGED_RUNS:
        cfg = Config.from_json(CONFIG)
        cfg.inference.kv_layout = "paged"
        cfg.inference.kv_page_len = PAGE_LEN
        cfg.inference.kv_num_pages = 0
        cfg.inference.prefix_cache = True
        cfg.inference.kv_cache_dtype = kv_dtype
        cfg.inference.kv_page_policy = policy
        t0 = time.perf_counter()
        engine = InferenceEngine(cfg, DEVICE, slots=8, attend_impl="flash")
        print(f"engine ({path}): {m.name} L={m.num_hidden_layers} "
              f"H={m.hidden_size} window={engine.max_seq_len}, "
              f"slots={engine.slots} block={engine.decode_block_len} "
              f"prefill_chunk={engine.prefill_chunk} attend=flash, paged: "
              f"page_len={engine.page_len} pages={engine.num_pages} "
              f"kv={str(engine.cache_dtype).removeprefix('torch.')} "
              f"policy={engine.kv_page_policy}, built in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        ContinuousBatcher(engine, params, seed=SEED).run(
            [Request("warm", list(range(1, 25)), max_new_tokens=2)])
        requests = _paged_requests(np, m.vocab_size, "r")
        batcher = ContinuousBatcher(engine, params, seed=SEED)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for kern in all_kernels:
            kern.launches = 0
        t0 = time.perf_counter()
        for r in requests:
            batcher.submit(r)
        batcher.step()  # every request admitted, one decode block run
        t_mix = time.perf_counter()
        mix = _live_page_mix(torch, batcher, policy == "hot_bf16", path)
        t_mix = time.perf_counter() - t_mix
        while batcher.busy:
            batcher.step()
        results = batcher.take_results()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0 - t_mix
        counts = {kern.name: kern.launches for kern in all_kernels}
        launches = {kern.name: counts[kern.name] for kern in paths[path]}
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        by_path[path] = counts
        for r in requests:
            res = results[r.uid]
            if (len(res.tokens) != NEW_TOKENS
                    or res.finish_reason != "length"
                    or not all(0 <= t < m.vocab_size for t in res.tokens)):
                raise AssertionError(f"{path} {r.uid}: {len(res.tokens)} "
                                     f"tokens, {res.finish_reason}")
        idle = [name for name, n in launches.items() if n == 0]
        if idle:
            raise AssertionError(f"kernels not launched on {path}: {idle}")
        stray = {k: n for k, n in counts.items() if n and k not in launches}
        if stray:
            raise AssertionError(f"kernels of another path launched on "
                                 f"{path}: {stray}")
        st = batcher.stats()
        if (st["prefix_hits"], st["prefix_cached_tokens"]) != (
                PREFIX_HITS, PREFIX_CACHED) or st["cow_copies"] < MIN_COW:
            raise AssertionError(
                f"{path}: prefix hits {st['prefix_hits']} (want "
                f"{PREFIX_HITS}), cached tokens "
                f"{st['prefix_cached_tokens']} (want {PREFIX_CACHED}), "
                f"copy-on-writes {st['cow_copies']} (want >= {MIN_COW})")
        gaps = {r.uid: _greedy_agrees(torch, llama, params, engine.cfg,
                                      results[r.uid])
                for i, r in enumerate(requests) if i not in SAMPLED}
        ttft = sorted(results[r.uid].ttft_s for r in requests)
        decode_tokens = batcher.generated_tokens - len(requests)
        print(json.dumps({
            "main_path": f"SmolLM-1.7B {path}", "card": card,
            "requests": len(requests),
            "prompt_lens": [len(r.prompt) for r in requests],
            "new_tokens_each": NEW_TOKENS, "wall_s": wall,
            "ttft_p50_s": ttft[len(ttft) // 2], "ttft_max_s": ttft[-1],
            "decode_tokens_per_s": decode_tokens / batcher.decode_seconds,
            "tokens_per_s": batcher.generated_tokens / wall,
            "decode_dispatches": batcher.decode_dispatches,
            "prefill_dispatches": batcher.prefill_dispatches,
            **{k: st[k] for k in (
                "kv_cache_dtype", "cache_bytes", "kv_page_len",
                "kv_pages_total", "kv_pages_live", "kv_pages_shared",
                "kv_pages_quant", "prefix_queries", "prefix_hits",
                "prefix_hit_rate", "prefix_cached_tokens", "cow_copies",
                "radix_evictions")},
            "kv_page_policy": policy, "while_live": mix,
            "peak_mem_gib": peak_gib,
            "launches": launches,
            "greedy_max_logit_gap": max(gaps.values()),
            "greedy_logit_gaps": gaps}), flush=True)
        if keep is not None:
            keep[path] = _decode_figures(batcher, len(requests))
        if policy == "hot_bf16":
            _profile(torch, lambda: ContinuousBatcher(
                engine, params, seed=SEED).run(
                    _paged_requests(np, m.vocab_size, "p")), path)
        del engine, batcher, results
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    prompt = ",".join(str(i) for i in range(1, 41))
    rc = generate.main(["--config", CONFIG, "--random-init", "--seed", "1",
                        "--prompt-ids", prompt, "--prompt-ids",
                        prompt + ",5,27,38", "--max-new-tokens", "8",
                        "--slots", "2", "--attend-impl", "flash",
                        "--kv-layout", "paged",
                        "--kv-page-policy", "hot_bf16"])
    if rc != 0:
        raise AssertionError(f"generate CLI (paged hot_bf16) exited {rc}")
    print(f"generate CLI (paged hot_bf16) passed in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    torch.cuda.empty_cache()
    return by_path


def _decode_figures(batcher, n_requests: int) -> dict:
    """A serving run's decode figures: the tokens made after each request's
    first (which its prefill makes) over the host wall time of the decode
    and verify rounds, rounds per such token, and the accept rate (None
    without speculation)."""
    decode_tokens = batcher.generated_tokens - n_requests
    return {"decode_tokens_per_s": decode_tokens / batcher.decode_seconds,
            "dispatches_per_token": (batcher.decode_dispatches
                                     / max(decode_tokens, 1)),
            "accept_rate": batcher.accept_rate}


# the speculation phase's runs: (path, kv_layout, drafter, controller).
# "script" proposes the greedy streams of the serve_spec run (verify rows:
# a position's logits come out the same at any row of a verify block, so
# these drafts match unless the run's own greedy chain moves), gated at
# ORACLE_MIN_ACCEPT; "script_off" proposes phase 3's spec-off streams
# (decode blocks), whose bf16 rounding differs from a verify's, so a near
# tie can part the two chains: its accept rate is printed, not gated
SPEC_RUNS = (("serve_spec", "contiguous", "ngram", False),
             ("serve_spec_learned", "contiguous", "learned", True),
             ("serve_spec_paged", "paged", "ngram", False),
             ("serve_spec_oracle", "contiguous", "script", False),
             ("serve_spec_offscript", "contiguous", "script_off", False))
ORACLE_MIN_ACCEPT = 0.5


def _spec_serve_phase(torch, np, card, paths, all_kernels, spec_off) -> dict:
    """Phase 10: speculative decoding (``spec_len`` 4) on phase 3's model,
    one run per entry of ``SPEC_RUNS`` on one set of weights: contiguous
    bf16 with the n-gram drafter, with the learned drafter and the
    controller, paged bf16 with the n-gram drafter on phase 5's
    shared-prefix traffic, and two scripted drafters over the six greedy
    requests: one proposing the first run's greedy streams, one phase 3's
    spec-off streams. Every kernel's count is set to 0 just before each
    run and read just after; returns those counts by path. Each run must
    give every request its full budget, launch each kernel of its path
    (C's variant among them) and no other, and pass phase 3's greedy gate;
    the paged run must find phase 5's prefix hits and cached tokens, and
    the first scripted run accept more than ``ORACLE_MIN_ACCEPT`` of its
    drafts. Each run's line sets its decode figures beside the spec-off
    run's of the same call (``spec_off``); the scripted runs' lines also
    say where each greedy stream of the first run first parts from phase
    3's. Then the generate command line with ``--spec-len 4 --spec-ngram
    3``, on the card by default."""
    from picotron_tpu_torch.config import Config
    from picotron_tpu_torch.inference.batcher import ContinuousBatcher, Request
    from picotron_tpu_torch.inference.engine import InferenceEngine
    from picotron_tpu_torch.models import llama
    from picotron_tpu_torch.tools import generate

    class ScriptDrafter:
        """Proposes a request's script (prompt + phase 3's greedy stream)
        from the position its history has reached."""

        kind, stateful, needs_hidden = "ngram", True, False

        def __init__(self, scripts):
            self.scripts = scripts

        def begin(self, ctx):
            pass

        def forget(self, ctx):
            pass

        def propose(self, history, n, ctx=None):
            out = np.zeros(n, np.int32)
            tail = self.scripts[ctx][len(history): len(history) + n]
            out[: len(tail)] = tail
            return out

    base = Config.from_json(CONFIG)
    m = base.model
    params = llama.init_params(m, seed=SEED, device=torch.device(DEVICE))
    by_path, spec_streams = {}, {}
    for path, layout, drafter, controller in SPEC_RUNS:
        cfg = Config.from_json(CONFIG)
        inf = cfg.inference
        inf.spec_len = SPEC_LEN
        inf.drafter = "learned" if drafter == "learned" else "ngram"
        inf.spec_controller.enabled = controller
        off_path = "serve"
        if layout == "paged":
            inf.kv_layout, inf.kv_page_len = "paged", PAGE_LEN
            inf.kv_num_pages, inf.prefix_cache = 0, True
            off_path = "serve_paged"
        cfg.validate()
        t0 = time.perf_counter()
        engine = InferenceEngine(cfg, DEVICE, slots=8, attend_impl="flash")
        print(f"engine ({path}): {m.name} L={m.num_hidden_layers} "
              f"H={m.hidden_size} window={engine.max_seq_len}, "
              f"slots={engine.slots} spec_len={engine.spec_len} "
              f"drafter={drafter} controller={controller} "
              f"layout={engine.kv_layout} attend=flash, built in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        ContinuousBatcher(engine, params, seed=SEED).run(
            [Request("warm", list(range(1, 25)), max_new_tokens=6)])
        requests = (_paged_requests if layout == "paged" else _requests)(
            np, m.vocab_size, "r")
        script = parted = None
        if drafter.startswith("script"):
            requests = [r for r in requests if r.temperature == 0]
            off_streams = spec_off[off_path]["streams"]
            streams = off_streams if drafter == "script_off" else spec_streams
            script = ScriptDrafter({r.uid: r.prompt + streams[r.uid]
                                    for r in requests})
            parted = {u: next((i for i, (a, b) in enumerate(
                zip(spec_streams[u], off_streams[u])) if a != b), None)
                for u in spec_streams}
        batcher = ContinuousBatcher(engine, params, seed=SEED,
                                    drafter=script)
        torch.cuda.synchronize()
        for kern in all_kernels:
            kern.launches = 0
        t0 = time.perf_counter()
        results = batcher.run(requests)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {kern.name: kern.launches for kern in all_kernels}
        launches = {kern.name: counts[kern.name] for kern in paths[path]}
        by_path[path] = counts
        if path == "serve_spec":
            spec_streams = {r.uid: results[r.uid].tokens for r in requests
                            if r.temperature == 0}
        for r in requests:
            res = results[r.uid]
            if (len(res.tokens) != NEW_TOKENS
                    or res.finish_reason != "length"
                    or not all(0 <= t < m.vocab_size for t in res.tokens)):
                raise AssertionError(f"{path} {r.uid}: {len(res.tokens)} "
                                     f"tokens, {res.finish_reason}")
        idle = [name for name, n in launches.items() if n == 0]
        if idle:
            raise AssertionError(f"kernels not launched on {path}: {idle}")
        stray = {k: n for k, n in counts.items() if n and k not in launches}
        if stray:
            raise AssertionError(f"kernels of another path launched on "
                                 f"{path}: {stray}")
        st = batcher.stats()
        if layout == "paged" and (st["prefix_hits"],
                                  st["prefix_cached_tokens"]) != (
                PREFIX_HITS, PREFIX_CACHED):
            raise AssertionError(
                f"{path}: prefix hits {st['prefix_hits']} (want "
                f"{PREFIX_HITS}), cached tokens "
                f"{st['prefix_cached_tokens']} (want {PREFIX_CACHED})")
        if drafter == "script" and not (batcher.accept_rate or 0.0) \
                > ORACLE_MIN_ACCEPT:
            raise AssertionError(
                f"{path}: accept rate {batcher.accept_rate} of drafts that "
                f"are the spec-off greedy streams (want > "
                f"{ORACLE_MIN_ACCEPT})")
        gaps = {r.uid: _greedy_agrees(torch, llama, params, engine.cfg,
                                      results[r.uid])
                for r in requests if r.temperature == 0}
        figures = _decode_figures(batcher, len(requests))
        off = spec_off[off_path]
        print(json.dumps({
            "main_path": f"SmolLM-1.7B {path}", "card": card,
            "requests": len(requests), "new_tokens_each": NEW_TOKENS,
            "spec_len": SPEC_LEN, "drafter": drafter,
            "controller": controller, "kv_layout": layout, "wall_s": wall,
            **figures,
            "draft_proposed": batcher.draft_proposed,
            "draft_accepted": batcher.draft_accepted,
            "spec_controller": st.get("spec_controller"),
            "drafters_final": sorted({str(results[r.uid].drafter)
                                      for r in requests}),
            "decode_dispatches": batcher.decode_dispatches,
            "spec_off": {"path": off_path,
                         "decode_tokens_per_s": off["decode_tokens_per_s"],
                         "dispatches_per_token":
                             off["dispatches_per_token"]},
            **({"serve_spec_parts_from_spec_off_at": parted}
               if parted is not None else {}),
            **({k: st[k] for k in ("prefix_hits", "prefix_cached_tokens",
                                   "cow_copies")}
               if layout == "paged" else {}),
            "launches": launches,
            "greedy_max_logit_gap": max(gaps.values()),
            "greedy_logit_gaps": gaps}), flush=True)
        del engine, batcher, results
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    rc = generate.main(["--config", CONFIG, "--random-init", "--seed", "1",
                        "--prompt-ids", "5,276,388,5,276,388,5,276",
                        "--prompt-ids", ",".join(str(i) for i in range(1, 41)),
                        "--max-new-tokens", "16", "--slots", "2",
                        "--attend-impl", "flash", "--spec-len", "4",
                        "--spec-ngram", "3"])
    if rc != 0:
        raise AssertionError(f"generate CLI (spec) exited {rc}")
    print(f"generate CLI (spec) passed in {time.perf_counter() - t0:.1f}s",
          flush=True)
    torch.cuda.empty_cache()
    return by_path


# phase 11's fault injection (resilience.*): two attempts a dispatch, a
# raise at round 3, every dispatch with slot 5 active failing, a 0.05 s
# spike at round 2; and in a second run NaN logits at round 4. REQUEST_TIMEOUT
# is r0's deadline: far shorter than the first round, so r0 times out at
# the start of the second with its first round's tokens
CHAOS = {"dispatch_attempts": 2, "chaos_dispatch_raise_round": 3,
         "chaos_dispatch_fail_slot": 5, "chaos_latency_round": 2,
         "chaos_latency_s": 0.05}
POISON = {"dispatch_attempts": 2, "chaos_poison_logits_round": 4}
REQUEST_TIMEOUT = 0.01
KEYS_BLOCK = 4  # phase 11's decode_block_len (phase 3's is the config's 8)


def _dtoh_copies(torch, run) -> list:
    """The bytes of every device-to-host copy ``run`` makes, from the
    profiler's trace (the exported trace's copy events carry their size;
    the in-memory events do not)."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    sizes = []
    for e in events:
        name = e.get("name", "")
        if "Memcpy" in name and "DtoH" in name:
            n = e.get("args", {}).get("bytes")
            if n is None:
                raise AssertionError(f"no byte count on the copy {name!r}: "
                                     f"{e.get('args')}")
            sizes.append(int(n))
    return sizes


def _keys_and_faults_phase(torch, np, card, paths, all_kernels,
                           spec_off) -> dict:
    """Phase 11: the per-slot key schedule, sampling in the dispatch and the
    fault-tolerant serving round, on phase 3's model (SmolLM-1.7B at full
    width and depth, 8 slots, phase 3's prompts, ``NEW_TOKENS`` each).
    Every kernel's count is set to 0 just before each run and read just
    after, and each run must launch A, B and C and no other kernel;
    returns each path's counts.

    - ``serve_slot``: ``key_schedule: "slot"``, every request at
      temperature 0.8 (top-p 0.9), decode blocks of ``KEYS_BLOCK``: the
      streams at block length 1 must be the same bits, the traffic at
      temperature 0 must give phase 3's greedy streams bit for bit (and
      pass its greedy gate), and the slot draw of an [8, V] batch must be
      each row's draw alone; its decode rate beside the round schedule's
      on the same traffic, and the draw's time beside torch.multinomial's.
    - ``serve_slot_spec``: the slot schedule with ``spec_len`` 4 and the
      n-gram drafter on phase 3's traffic: full budgets and phase 3's
      greedy gate; where its sampled streams part from ``serve_slot``'s
      (printed, not gated: a verify's rows round otherwise), the accept
      rate.
    - ``sample_on_device``: phase 3's traffic and config with the first
      tokens drawn in the prefill dispatches: phase 3's greedy streams bit
      for bit; a profiled ``decode_step`` round copies no [8, V] array to
      the host.
    - ``serve_chaos``: the round schedule at ``KEYS_BLOCK`` with ``CHAOS``
      and r0's ``REQUEST_TIMEOUT``, greedy and at temperature 0.8: slot
      5's request (r5) ends "error", r0 "timeout", and every other request
      has its full budget and the fault-free run's stream bit for bit;
      the seconds of the round that retried and isolated beside a
      fault-free round's. Then ``POISON``: no crash, every request
      accounted for, every token in the vocabulary."""
    from picotron_tpu_torch.config import Config
    from picotron_tpu_torch.inference import prng, sampling
    from picotron_tpu_torch.inference.batcher import ContinuousBatcher, Request
    from picotron_tpu_torch.inference.engine import InferenceEngine
    from picotron_tpu_torch.models import llama
    from picotron_tpu_torch.resilience.chaos import ServingChaos

    base = Config.from_json(CONFIG)
    m = base.model
    V = m.vocab_size
    params = llama.init_params(m, seed=SEED, device=torch.device(DEVICE))
    greedy3 = spec_off["serve"]["streams"]  # phase 3's greedy streams
    by_path = {}

    def traffic(temp=None, tag="r"):
        """Phase 3's requests; ``temp`` sets every request's temperature
        (top-p 0.9 where it samples)."""
        reqs = _requests(np, V, tag)
        if temp is not None:
            for r in reqs:
                r.temperature, r.top_p = temp, (0.9 if temp > 0 else 1.0)
        return reqs

    def engine_for(path, hooks=None, **inf):
        cfg = Config.from_json(CONFIG)
        for k, v in inf.items():
            if k in CHAOS or k in POISON:
                setattr(cfg.resilience, k, v)
            else:
                setattr(cfg.inference, k, v)
        cfg.validate()
        engine = InferenceEngine(cfg, DEVICE, slots=8, attend_impl="flash",
                                 hooks=hooks)
        # a sampled request warms the draw's kernels too
        ContinuousBatcher(engine, params, seed=SEED).run(
            [Request("warm", list(range(1, 25)), max_new_tokens=6,
                     temperature=0.8)])
        return engine

    def run(path, engine, requests):
        """One counted run; returns (results, batcher, counts, wall, and
        for each step the seconds of its decode or verify round with the
        dispatches the hook saw in it)."""
        batcher = ContinuousBatcher(engine, params, seed=SEED)
        torch.cuda.synchronize()
        for kern in all_kernels:
            kern.launches = 0
        steps = []
        t0 = time.perf_counter()
        for r in requests:
            batcher.submit(r)
        while batcher.busy:
            r0 = getattr(engine.hooks, "round", 0)
            d0 = batcher.decode_seconds
            batcher.step()
            steps.append((batcher.decode_seconds - d0,
                          getattr(engine.hooks, "round", 0) - r0))
        results = batcher.take_results()
        wall = time.perf_counter() - t0
        counts = {kern.name: kern.launches for kern in all_kernels}
        launches = {kern.name: counts[kern.name] for kern in paths[path]}
        idle = [name for name, n in launches.items() if n == 0]
        if idle:
            raise AssertionError(f"kernels not launched on {path}: {idle}")
        stray = {k: n for k, n in counts.items() if n and k not in launches}
        if stray:
            raise AssertionError(f"kernels of another path launched on "
                                 f"{path}: {stray}")
        for r in requests:
            res = results[r.uid]
            if not all(0 <= t < V for t in res.tokens):
                raise AssertionError(f"{path} {r.uid}: a token outside the "
                                     f"vocabulary")
        return results, batcher, counts, wall, steps

    def full(path, requests, results, skip=()):
        for r in requests:
            res = results[r.uid]
            if r.uid not in skip and (len(res.tokens) != NEW_TOKENS
                                      or res.finish_reason != "length"):
                raise AssertionError(f"{path} {r.uid}: {len(res.tokens)} "
                                     f"tokens, {res.finish_reason}")

    def streams(results):
        return {u: r.tokens for u, r in results.items()}

    def parts(a, b):
        return {u: next((i for i, (x, y) in enumerate(zip(a[u], b[u]))
                         if x != y), None) for u in a}

    def figures(batcher, results, wall):
        ttft = sorted(r.ttft_s for r in results.values()
                      if r.ttft_s is not None)
        return {**_decode_figures(batcher, len(results)), "wall_s": wall,
                "ttft_p50_s": ttft[len(ttft) // 2] if ttft else None}

    # -- serve_slot -------------------------------------------------------
    slot = engine_for("serve_slot", key_schedule="slot",
                      decode_block_len=KEYS_BLOCK)
    round_eng = engine_for("serve_slot", decode_block_len=KEYS_BLOCK)
    res, b, counts, wall, _ = run("serve_slot", slot, traffic(0.8))
    full("serve_slot", traffic(0.8), res)
    by_path["serve_slot"] = counts
    slot_08 = streams(res)
    rates = {"slot": [figures(b, res, wall)], "round": []}
    round_08 = None
    # the two schedules' rates in turns (slot, round, round, slot), each
    # schedule's streams the same bits every time
    for eng, key in ((round_eng, "round"), (round_eng, "round"),
                     (slot, "slot")):
        resr, br, _, wallr, _ = run("serve_slot", eng, traffic(0.8))
        full("serve_slot", traffic(0.8), resr)
        rates[key].append(figures(br, resr, wallr))
        if key == "round" and round_08 is None:
            round_08 = streams(resr)
        if streams(resr) != (slot_08 if key == "slot" else round_08):
            raise AssertionError(f"serve_slot: a second {key} run gave "
                                 f"other streams")
    one = engine_for("serve_slot", key_schedule="slot", decode_block_len=1)
    res1, b1, *_ = run("serve_slot", one, traffic(0.8))
    if streams(res1) != slot_08:
        raise AssertionError(
            f"serve_slot: block 1 and block {KEYS_BLOCK} part at "
            f"{parts(streams(res1), slot_08)}")
    del one
    resg, *_ = run("serve_slot", slot, traffic(0.0))
    full("serve_slot", traffic(0.0), resg)
    slot_greedy = streams(resg)
    off_phase3 = {u: i for u, i in parts(
        {u: slot_greedy[u] for u in greedy3}, greedy3).items()
        if i is not None}
    if off_phase3:
        raise AssertionError(f"serve_slot greedy streams part from phase "
                             f"3's at {off_phase3}")
    gaps = {u: _greedy_agrees(torch, llama, params, slot.cfg, r)
            for u, r in resg.items()}
    del slot, round_eng
    # the draw: an [8, V] batch against each row alone, and its time
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    logits = 4.0 * torch.randn((8, V), generator=gen, device=DEVICE)
    keys = prng.fold_in(prng.split(prng.PRNGKey(SEED), 8).to(DEVICE),
                        torch.arange(100, 108, device=DEVICE))
    t = torch.full((8,), 0.8, device=DEVICE)
    k0 = torch.zeros(8, dtype=torch.int32, device=DEVICE)
    p9 = torch.full((8,), 0.9, device=DEVICE)
    batch = sampling.sample_rowkeys(logits, keys, t, k0, p9)
    alone = torch.cat([sampling.sample_rowkeys(
        logits[i:i + 1], keys[i:i + 1], t[:1], k0[:1], p9[:1])
        for i in range(8)])
    if not torch.equal(batch, alone):
        raise AssertionError(f"slot draw: batch {batch.tolist()} against "
                             f"rows alone {alone.tolist()}")
    filtered = sampling.filter_top_k_top_p(logits / 0.8, k0, p9)
    probs = torch.softmax(filtered, dim=-1)
    draw = {
        "slot_draw_ms": _time_ms(lambda: prng.categorical(keys, filtered)),
        "slot_draw_device_ms": _device_ms(
            torch, lambda: prng.categorical(keys, filtered)),
        "multinomial_ms": _time_ms(
            lambda: torch.multinomial(probs, 1, generator=gen)),
        "multinomial_device_ms": _device_ms(
            torch, lambda: torch.multinomial(probs, 1, generator=gen)),
        "sample_rowkeys_ms": _time_ms(
            lambda: sampling.sample_rowkeys(logits, keys, t, k0, p9,
                                            greedy_only=False)),
        "sample_ms": _time_ms(
            lambda: sampling.sample(logits, gen, t, k0, p9))}
    print(json.dumps({
        "main_path": "SmolLM-1.7B serve_slot", "card": card,
        "requests": len(res), "new_tokens_each": NEW_TOKENS,
        "decode_block_len": KEYS_BLOCK, "temperature": 0.8,
        "slot_runs": rates["slot"], "round_runs": rates["round"],
        **{f"{k}_decode_tokens_per_s_mean": statistics.mean(
            f["decode_tokens_per_s"] for f in v) for k, v in rates.items()},
        "block_1_same_bits": True, "greedy_is_phase_3s": True,
        "slot_parts_from_round_at": parts(slot_08, round_08),
        "draw_batch_equals_rows_alone": True, "draw_shape": [8, V],
        **draw,
        "launches": {k.name: counts[k.name] for k in paths["serve_slot"]},
        "greedy_max_logit_gap": max(gaps.values())}), flush=True)

    # -- serve_slot_spec --------------------------------------------------
    spec = engine_for("serve_slot_spec", key_schedule="slot",
                      spec_len=SPEC_LEN, drafter="ngram")
    reqs = traffic()
    res, b, counts, wall, _ = run("serve_slot_spec", spec, reqs)
    full("serve_slot_spec", reqs, res)
    by_path["serve_slot_spec"] = counts
    gaps = {r.uid: _greedy_agrees(torch, llama, params, spec.cfg,
                                  res[r.uid])
            for r in reqs if r.temperature == 0}
    sampled = [r.uid for r in reqs if r.temperature > 0]
    print(json.dumps({
        "main_path": "SmolLM-1.7B serve_slot_spec", "card": card,
        "spec_len": SPEC_LEN, "drafter": "ngram", **figures(b, res, wall),
        "draft_proposed": b.draft_proposed,
        "draft_accepted": b.draft_accepted,
        "sampled_parts_from_serve_slot_at": parts(
            {u: res[u].tokens for u in sampled}, slot_08),
        "launches": {k.name: counts[k.name]
                     for k in paths["serve_slot_spec"]},
        "greedy_max_logit_gap": max(gaps.values())}), flush=True)
    del spec

    # -- sample_on_device -------------------------------------------------
    sod = engine_for("sample_on_device", sample_on_device=True)
    reqs = traffic()
    res, b, counts, wall, _ = run("sample_on_device", sod, reqs)
    full("sample_on_device", reqs, res)
    by_path["sample_on_device"] = counts
    moved = {u: i for u, i in parts(
        {u: res[u].tokens for u in greedy3}, greedy3).items()
        if i is not None}
    if moved:
        raise AssertionError(f"sample_on_device: greedy streams part from "
                             f"phase 3's at {moved}")
    # one decode round of parked slots, profiled: what crosses to the host
    cache = sod.init_cache()
    sgen = torch.Generator(device=DEVICE).manual_seed(SEED)
    last = np.zeros(8, np.int32)
    for s, r in enumerate(reqs[:3]):
        out = sod.prefill(params, r.prompt[:64],
                          sample=(sgen, 0.0, 0, 1.0))
        cache = sod.insert(cache, out[0], s, min(len(r.prompt), 64))
        last[s] = int(out[1][0])
    zeros, ones = np.zeros(8, np.float32), np.ones(8, np.float32)
    holder = {}

    def decode_round():
        holder["out"] = sod.decode_step(params, cache, last, sgen, zeros,
                                        np.zeros(8, np.int32), ones)
        holder["tokens"] = holder["out"][1].cpu()

    decode_round()
    copies = _dtoh_copies(torch, decode_round)
    if holder["out"][2] is not None:
        raise AssertionError("sample_on_device: decode_step returned logits")
    if any(n >= 8 * V * 4 for n in copies) or not copies:
        raise AssertionError(f"sample_on_device: device-to-host copies of "
                             f"{copies} bytes in a decode round")
    print(json.dumps({
        "main_path": "SmolLM-1.7B sample_on_device", "card": card,
        **figures(b, res, wall), "greedy_is_phase_3s": True,
        "decode_round_dtoh_bytes": copies, "logits_bytes": 8 * V * 4,
        "launches": {k.name: counts[k.name]
                     for k in paths["sample_on_device"]}}), flush=True)
    del sod, cache, holder

    # -- serve_chaos ------------------------------------------------------
    chaos_fig = {}
    for temp, want in ((0.0, slot_greedy), (0.8, round_08)):
        hook = ServingChaos(Config.from_dict(
            {"resilience": CHAOS}).resilience)
        eng = engine_for("serve_chaos", hooks=None,
                         decode_block_len=KEYS_BLOCK, **CHAOS)
        eng.hooks = hook  # after the warm-up: its rounds count from here
        reqs = traffic(temp)
        reqs[0].timeout_s = REQUEST_TIMEOUT
        res, b, counts, wall, steps = run("serve_chaos", eng, reqs)
        if res["r0"].finish_reason != "timeout" or not res["r0"].tokens:
            raise AssertionError(f"serve_chaos: r0 {res['r0'].finish_reason}"
                                 f" with {len(res['r0'].tokens)} tokens")
        if res["r5"].finish_reason != "error":
            raise AssertionError(f"serve_chaos: r5 {res['r5'].finish_reason}")
        full("serve_chaos", reqs, res, skip=("r0", "r5"))
        bad = {u: parts({u: res[u].tokens}, want)[u] for u in res
               if u not in ("r0", "r5") and res[u].tokens != want[u]}
        if bad:
            raise AssertionError(f"serve_chaos at {temp}: survivors part "
                                 f"from the fault-free run at {bad}")
        if b.counters != {"admitted": 8, "completed": 6, "expired": 1,
                          "errored": 1, "shed": 0}:
            raise AssertionError(f"serve_chaos: counters {b.counters}")
        if hook._fired != {"raise", "latency"}:
            raise AssertionError(f"serve_chaos: fired {hook._fired}")
        by_path["serve_chaos"] = counts
        faulted = [(s, n) for s, n in steps if n > 1]
        clean_steps = sorted(s for s, n in steps if n == 1)
        chaos_fig[f"temperature_{temp}"] = {
            "wall_s": wall, "dispatches_seen": hook.round,
            "faulted_round_s_and_dispatches": faulted,
            "clean_round_median_s": clean_steps[len(clean_steps) // 2],
            "r0_tokens": len(res["r0"].tokens),
            "r5_tokens": len(res["r5"].tokens), "counters": b.counters}
        del eng
    hook = ServingChaos(Config.from_dict({"resilience": POISON}).resilience)
    eng = engine_for("serve_chaos", decode_block_len=KEYS_BLOCK, **POISON)
    eng.hooks = hook
    reqs = traffic()
    res, b, *_ = run("serve_chaos", eng, reqs)
    full("serve_chaos", reqs, res)
    if "poison" not in hook._fired:
        raise AssertionError("serve_chaos: the poison round never ran")
    print(json.dumps({
        "main_path": "SmolLM-1.7B serve_chaos", "card": card,
        "decode_block_len": KEYS_BLOCK, "faults": CHAOS,
        "timeout_s": REQUEST_TIMEOUT, **chaos_fig,
        "poison_round_counters": b.counters,
        "launches": {k.name: by_path["serve_chaos"][k.name]
                     for k in paths["serve_chaos"]}}), flush=True)
    del eng, params
    torch.cuda.empty_cache()
    return by_path


# phase 12: the two 1,400-token prompts of serve_lane_paged, submitted once
# LANE_DECODERS slots decode phase 5's traffic
LANE_LONG_LEN = 1400
LANE_LONGS = 2
LANE_DECODERS = 4


def _sync_gated(torch, batcher, path: str) -> dict:
    """Put ``batcher``'s issue stage under
    ``torch.cuda.set_sync_debug_mode("error")``: any call in
    ``_issue_round`` that waits for the card raises there, the issue falls
    back to the serial recovery, and the fallback is made to fail the
    phase. Returns the tally of gated issues."""
    issue = batcher._issue_round
    tally = {"issues": 0}

    def gated(budget):
        tally["issues"] += 1
        torch.cuda.set_sync_debug_mode("error")
        try:
            return issue(budget)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    def fallback(*args, **kwargs):
        raise AssertionError(
            f"{path}: an issue fell back to the serial round (a sync under "
            f"set_sync_debug_mode('error')? the log line above names it)")

    batcher._issue_round = gated
    batcher._round_fallback = fallback
    return tally


def _pipeline_phase(torch, np, card, paths, all_kernels) -> dict:
    """Phase 12: the overlap pipeline and the mixed prefill lane on phase
    3's model (SmolLM-1.7B at full width and depth, 8 slots, decode blocks
    of ``KEYS_BLOCK``, chunks of 512, the slot schedule). Every kernel's
    count is set to 0 just before each run and read just after, and each
    run must launch its path's kernels and no other; every run with overlap
    runs its issue stage under ``set_sync_debug_mode("error")``
    (``_sync_gated``). Returns each path's counts.

    - ``serve_overlap``: phase 3's prompts and budgets, contiguous, with
      overlap, at temperature 0.8 (in turns: serial, overlap, overlap,
      serial) and greedy: the serial slot-schedule runs' bits; decode
      tokens/s, the issue-to-issue gap p50 and (one profiled run each) the
      device's busy share of each mode.
    - ``serve_lane_paged``: paged bf16 with the prefix cache, phase 5's
      traffic, then ``LANE_LONGS`` prompts of ``LANE_LONG_LEN`` tokens
      submitted once ``LANE_DECODERS`` slots decode; serial, the lane, the
      lane with overlap: the serial bits, the serial run's prefill
      dispatches (a lane chunk counts as a serial chunk) and phase 5's
      prefix hits and cached tokens; each mode's decode stall, the
      decoders' TPOT p50/p95 and the long prompts' TTFT.
    - ``serve_lane_spec``: ``spec_len`` 4 with the n-gram drafter,
      contiguous, the lane with overlap, on phase 3's traffic: the serial
      slot-schedule spec run's bits, full budgets and phase 3's greedy
      gate."""
    from picotron_tpu_torch.config import Config
    from picotron_tpu_torch.inference.batcher import ContinuousBatcher, Request
    from picotron_tpu_torch.inference.engine import InferenceEngine
    from picotron_tpu_torch.models import llama

    m = Config.from_json(CONFIG).model
    V = m.vocab_size
    params = llama.init_params(m, seed=SEED, device=torch.device(DEVICE))
    by_path = {}

    def engine_for(paged=False, **inf):
        cfg = Config.from_json(CONFIG)
        cfg.inference.key_schedule = "slot"
        cfg.inference.decode_block_len = KEYS_BLOCK
        if paged:
            cfg.inference.kv_layout = "paged"
            cfg.inference.kv_page_len = PAGE_LEN
            cfg.inference.kv_num_pages = 0
            cfg.inference.prefix_cache = True
        for k, v in inf.items():
            setattr(cfg.inference, k, v)
        cfg.validate()
        engine = InferenceEngine(cfg, DEVICE, slots=8, attend_impl="flash")
        # warm-up outside the counted runs: a sampled short request and a
        # long one, so the lane's chunk and the draw have run once
        ContinuousBatcher(engine, params, seed=SEED).run(
            [Request("warm", list(range(1, 25)), max_new_tokens=6,
                     temperature=0.8),
             Request("warm_long", list(range(1, 601)), max_new_tokens=2)])
        return engine

    def counted(path, engine, drive):
        """One counted run: ``drive(batcher)`` serves it; returns
        (results, batcher, counts, wall, issues gated)."""
        batcher = ContinuousBatcher(engine, params, seed=SEED)
        tally = (_sync_gated(torch, batcher, path) if engine.overlap
                 else {"issues": None})
        torch.cuda.synchronize()
        for kern in all_kernels:
            kern.launches = 0
        t0 = time.perf_counter()
        results = drive(batcher)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {kern.name: kern.launches for kern in all_kernels}
        launches = {kern.name: counts[kern.name] for kern in paths[path]}
        idle = [name for name, n in launches.items() if n == 0]
        if idle:
            raise AssertionError(f"kernels not launched on {path}: {idle}")
        stray = {k: n for k, n in counts.items() if n and k not in launches}
        if stray:
            raise AssertionError(f"kernels of another path launched on "
                                 f"{path}: {stray}")
        if engine.overlap and not tally["issues"]:
            raise AssertionError(f"{path}: no issue ran under the gate")
        for uid, res in results.items():
            if not all(0 <= t < V for t in res.tokens):
                raise AssertionError(f"{path} {uid}: a token outside the "
                                     f"vocabulary")
        return results, batcher, counts, wall, tally["issues"]

    def run_all(requests):
        return lambda b: b.run(requests)

    def streams(results):
        return {u: r.tokens for u, r in results.items()}

    def same_bits(path, got, want):
        bad = {u: next((i for i, (x, y) in enumerate(zip(got[u], want[u]))
                        if x != y), min(len(got[u]), len(want[u])))
               for u in want if got[u] != want[u]}
        if bad:
            raise AssertionError(f"{path}: streams part from the serial "
                                 f"run's at {bad}")

    def full(path, requests, results):
        for r in requests:
            res = results[r.uid]
            if (len(res.tokens) != r.max_new_tokens
                    or res.finish_reason != "length"):
                raise AssertionError(f"{path} {r.uid}: {len(res.tokens)} "
                                     f"tokens, {res.finish_reason}")

    def traffic(temp, tag="r"):
        reqs = _requests(np, V, tag)
        for r in reqs:
            r.temperature, r.top_p = temp, (0.9 if temp > 0 else 1.0)
        return reqs

    def figures(batcher, results, wall):
        st = batcher.stats()
        return {**_decode_figures(batcher, len(results)), "wall_s": wall,
                "tokens_per_s": batcher.generated_tokens / wall,
                "dispatch_gap_p50_s": (st["overlap"]["dispatch_gap_s"]
                                       or {}).get("p50"),
                "host_work_p50_s": (st["overlap"]["host_work_s"]
                                    or {}).get("p50")}

    # -- serve_overlap ----------------------------------------------------
    serial = engine_for()
    overlap = engine_for(overlap=True)
    turns = {"serial": [], "overlap": []}
    want = None
    for mode in ("serial", "overlap", "overlap", "serial"):
        reqs = traffic(0.8)
        res, b, counts, wall, issues = counted(
            "serve_overlap", serial if mode == "serial" else overlap,
            run_all(reqs))
        full("serve_overlap", reqs, res)
        if want is None:
            want = streams(res)
        same_bits(f"serve_overlap ({mode}, 0.8)", streams(res), want)
        turns[mode].append({**figures(b, res, wall), "gated_issues": issues})
        if mode == "overlap":
            by_path["serve_overlap"] = counts
    greedy = {}
    for mode, eng in (("serial", serial), ("overlap", overlap)):
        reqs = traffic(0.0)
        res, b, counts, wall, _ = counted("serve_overlap", eng,
                                          run_all(reqs))
        full("serve_overlap", reqs, res)
        greedy[mode] = streams(res)
    same_bits("serve_overlap (greedy)", greedy["overlap"], greedy["serial"])
    busy = {}
    for mode, eng in (("serial", serial), ("overlap", overlap)):
        dev_ms, wall_ms = _profile(torch, lambda: ContinuousBatcher(
            eng, params, seed=SEED).run(traffic(0.8, "p")),
            f"serve_overlap ({mode})", with_wall=True)
        busy[mode] = sum(dev_ms.values()) / wall_ms
    print(json.dumps({
        "main_path": "SmolLM-1.7B serve_overlap", "card": card,
        "decode_block_len": KEYS_BLOCK, "temperature": 0.8,
        "runs_in_turns": turns,
        **{f"{k}_decode_tokens_per_s_mean": statistics.mean(
            f["decode_tokens_per_s"] for f in v) for k, v in turns.items()},
        "device_busy_share": busy, "same_bits_as_serial": True,
        "greedy_same_bits_as_serial": True,
        "launches": {k.name: by_path["serve_overlap"][k.name]
                     for k in paths["serve_overlap"]}}), flush=True)
    del serial, overlap

    # -- serve_lane_paged -------------------------------------------------
    rng = np.random.default_rng(SEED + 12)
    base = _paged_requests(np, V, "r")
    starts = {r.prompt[0] for r in base}
    longs = []
    for j in range(LANE_LONGS):
        prompt = rng.integers(1, V, LANE_LONG_LEN).tolist()
        while prompt[0] in starts:
            prompt[0] = int(rng.integers(1, V))
        starts.add(prompt[0])
        longs.append(Request(f"long{j}", prompt, max_new_tokens=NEW_TOKENS))

    def lane_drive(b):
        """Phase 5's traffic, then the long prompts once LANE_DECODERS slots
        decode; each request's finish time for its TPOT."""
        submit, finish = {}, {}
        for r in base:
            b.submit(Request(**vars(r)))
            submit[r.uid] = time.perf_counter()
        pending = [Request(**vars(r)) for r in longs]
        while b.busy or pending:
            if pending and sum(s is not None and not s.prefilling
                               for s in b._slots) >= LANE_DECODERS:
                for r in pending:
                    b.submit(r)
                    submit[r.uid] = time.perf_counter()
                pending = []
            b.step()
            now = time.perf_counter()
            for uid in b._results:
                finish.setdefault(uid, now)
        results = b.take_results()
        for uid, res in results.items():
            res.tpot_s = ((finish[uid] - submit[uid] - res.ttft_s)
                          / max(len(res.tokens) - 1, 1))
        return results

    lane_fig, lane_want, lane_counts = {}, None, None
    for mode, kw in (("serial", {}), ("lane", {"mixed_dispatch": True}),
                     ("lane_overlap", {"mixed_dispatch": True,
                                       "overlap": True})):
        eng = engine_for(paged=True, **kw)
        res, b, counts, wall, issues = counted("serve_lane_paged", eng,
                                               lane_drive)
        full("serve_lane_paged", base + longs, res)
        st = b.stats()
        if (st["prefix_hits"], st["prefix_cached_tokens"]) != (
                PREFIX_HITS, PREFIX_CACHED):
            raise AssertionError(
                f"serve_lane_paged ({mode}): prefix hits "
                f"{st['prefix_hits']}, cached tokens "
                f"{st['prefix_cached_tokens']} (want {PREFIX_HITS}, "
                f"{PREFIX_CACHED})")
        if lane_want is None:
            lane_want, serial_chunks = streams(res), b.prefill_dispatches
        same_bits(f"serve_lane_paged ({mode})", streams(res), lane_want)
        if b.prefill_dispatches != serial_chunks:
            raise AssertionError(
                f"serve_lane_paged ({mode}): {b.prefill_dispatches} prefill "
                f"dispatches, the serial run's {serial_chunks}")
        if mode != "serial" and not b.lane_tokens:
            raise AssertionError(f"serve_lane_paged ({mode}): the lane "
                                 f"never ran")
        tpot = sorted(res[r.uid].tpot_s for r in base)
        lane_fig[mode] = {
            **figures(b, res, wall), "gated_issues": issues,
            "prefill_dispatches": b.prefill_dispatches,
            "lane_tokens": b.lane_tokens,
            "decode_stall_s": b.decode_stall_s,
            "decode_stalls": b.decode_stalls,
            "tpot_p50_s": tpot[len(tpot) // 2],
            "tpot_p95_s": tpot[min(len(tpot) - 1,
                                   int(0.95 * len(tpot)))],
            "long_ttft_s": [res[r.uid].ttft_s for r in longs]}
        if mode == "lane_overlap":
            lane_counts = counts
        del eng
    by_path["serve_lane_paged"] = lane_counts
    print(json.dumps({
        "main_path": "SmolLM-1.7B serve_lane_paged", "card": card,
        "prompt_lens": [len(r.prompt) for r in base + longs],
        "long_prompts_after_decoders": LANE_DECODERS,
        "prefix_hits": PREFIX_HITS, "prefix_cached_tokens": PREFIX_CACHED,
        "same_bits_as_serial": True, "modes": lane_fig,
        "launches": {k.name: lane_counts[k.name]
                     for k in paths["serve_lane_paged"]}}), flush=True)

    # -- serve_lane_spec --------------------------------------------------
    spec_want = None
    for mode, kw in (("serial", {}), ("lane_overlap", {
            "mixed_dispatch": True, "overlap": True})):
        eng = engine_for(spec_len=SPEC_LEN, drafter="ngram", **kw)
        reqs = _requests(np, V, "r")
        res, b, counts, wall, issues = counted("serve_lane_spec", eng,
                                               run_all(reqs))
        full("serve_lane_spec", reqs, res)
        if spec_want is None:
            spec_want = streams(res)
            serial_fig = figures(b, res, wall)
            continue
        same_bits("serve_lane_spec", streams(res), spec_want)
        gaps = {r.uid: _greedy_agrees(torch, llama, params, eng.cfg,
                                      res[r.uid])
                for r in reqs if r.temperature == 0}
        by_path["serve_lane_spec"] = counts
        print(json.dumps({
            "main_path": "SmolLM-1.7B serve_lane_spec", "card": card,
            "spec_len": SPEC_LEN, "drafter": "ngram",
            "serial": serial_fig,
            "lane_overlap": {**figures(b, res, wall),
                             "gated_issues": issues,
                             "lane_tokens": b.lane_tokens,
                             "draft_proposed": b.draft_proposed,
                             "draft_accepted": b.draft_accepted},
            "same_bits_as_serial": True,
            "greedy_max_logit_gap": max(gaps.values()),
            "launches": {k.name: counts[k.name]
                         for k in paths["serve_lane_spec"]}}), flush=True)
        del eng
    del params
    torch.cuda.empty_cache()
    return by_path


# phase 13: the HTTP front end (tools/serve.py)
HTTP_STREAMED = (2, 6)  # request indices POSTed with "stream": true
HTTP_LONG_TOKENS = 256  # the CLI's request in flight at SIGTERM
# the tenant phase 13 hot-adds through POST /tenants (a free pack slot)
HTTP_TENANT = {"name": "hooli", "adapter_rank": 8, "adapter_seed": 4,
               "priority": 1}
HTTP_TIMEOUT_S = 300.0  # the bound on every wait of phase 13


def _http(port: int, method: str, path: str, body=None):
    """(status, parsed JSON or text) of one request to a local server."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port,
                                      timeout=HTTP_TIMEOUT_S)
    try:
        conn.request(method, path, None if body is None else json.dumps(body))
        resp = conn.getresponse()
        text = resp.read().decode()
        try:
            return resp.status, json.loads(text)
        except ValueError:
            return resp.status, text
    finally:
        conn.close()


def _http_client(port: int, spec: dict, out: dict) -> None:
    """POST ``spec`` to /generate and fill ``out``: the send, first-row
    and end times (host clock), the status and the result (a streamed
    one's token rows under ``"rows"``)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port,
                                      timeout=HTTP_TIMEOUT_S)
    try:
        out["t_send"] = time.perf_counter()
        conn.request("POST", "/generate", json.dumps(spec))
        resp = conn.getresponse()
        out["status"] = resp.status
        if not spec.get("stream"):
            out["result"] = json.loads(resp.read())
            return
        out["rows"] = []
        while True:
            line = resp.readline()
            if not line:
                break
            row = json.loads(line)
            if row["event"] == "token":
                out.setdefault("t_first", time.perf_counter())
                out["rows"].append(row["token"])
            else:
                out["result"] = row
    finally:
        out["t_end"] = time.perf_counter()
        conn.close()


def _child_lines(proc):
    """A queue fed with ``proc``'s output lines by a daemon thread."""
    import queue
    import threading

    lines = queue.Queue()

    def pump():
        for line in proc.stdout:
            lines.put(line)
        lines.put(None)

    threading.Thread(target=pump, daemon=True).start()
    return lines


def _http_phase(torch, np, card, paths, all_kernels) -> dict:
    """Phase 13: the HTTP front end (``tools/serve.py``) on the card.
    Every kernel's count is set to 0 just before each counted run and
    read just after; each must launch its path's kernels and no other.
    Returns each path's counts.

    - ``serve_http``: phase 3's model and requests (SmolLM-1.7B at full
      width and depth, 8 slots, window 2048, ``key_schedule: "slot"``,
      decode blocks of ``KEYS_BLOCK``) behind ``Server(engine, params,
      port=0)``; each request POSTed on its own connection once the one
      before it is registered with the front end (so both runs admit in
      one order), ``HTTP_STREAMED`` of them streamed. In turns with
      ``ContinuousBatcher.run`` on the same engine (direct, HTTP, HTTP,
      direct): every HTTP stream must be bit for bit the direct one, a
      stream's token rows its result, and /metrics must agree with /statz.
      Printed: decode tokens/s both ways, TTFT p50/max through HTTP, and
      each streamed request's front-end host seconds (send to its first
      row, less the batcher's own TTFT).
    - ``serve_http_tenants``: phase 6's tenancy config (paged bf16, three
      tenants in an 8-slot rank-16 pack) behind a Server with its
      registry; ``HTTP_TENANT`` is hot-added by ``POST /tenants`` (pack
      slot 4), a base, an acme and a hooli request run together, then
      ``DELETE /tenants/hooli`` and a request naming it must be a 400.
      Gates: full budgets, A, B, C-paged and H launch and no other kernel,
      hooli's greedy tokens within ``LOGIT_MARGIN`` of its merged tree.
    - the CLI in a subprocess at full width: ``python -m
      picotron_tpu_torch.tools.serve --config <phase 3's config>
      --random-init --port 0``; its "serving" line gives the port and the
      start-up seconds; one POST is served; a streamed request of
      ``HTTP_LONG_TOKENS`` is in flight at SIGTERM and must be served
      (200, "length"), and the process must exit 0 (the seconds from
      SIGTERM to exit printed).
    - ``--smoke`` and ``--smoke --overlap``, two subprocesses side by side
      on the card: exit 0 and ``serve-smoke: PASS``."""
    by_path, figures = _http_serve_runs(torch, np, paths, all_kernels)
    figures.update(_http_cli_run())
    smokes = {name: subprocess.Popen(
        [sys.executable, "-m", "picotron_tpu_torch.tools.serve", "--smoke",
         *extra], cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for name, extra in (("smoke", []),
                                       ("smoke_overlap", ["--overlap"]))}
    try:
        for name, proc in smokes.items():
            out, _ = proc.communicate(timeout=HTTP_TIMEOUT_S)
            if proc.returncode != 0 or "serve-smoke: PASS" not in out:
                raise AssertionError(f"serve {name} exited "
                                     f"{proc.returncode}:\n{out[-4000:]}")
            figures[f"{name}_checks_ok"] = sum(
                line.endswith(": ok") for line in out.splitlines())
    finally:
        for proc in smokes.values():
            proc.kill()
            proc.wait(timeout=60)
    print(json.dumps({"main_path": "SmolLM-1.7B serve_http", "card": card,
                      **figures,
                      "launches": {
                          path: {k.name: by_path[path][k.name]
                                 for k in paths[path]}
                          for path in ("serve_http", "serve_http_tenants")}}),
          flush=True)
    return by_path


def _http_serve_runs(torch, np, paths, all_kernels) -> tuple:
    """Phase 13's in-process runs: ``serve_http`` in turns with the direct
    batcher, then ``serve_http_tenants``. Returns (counts by path, the
    figures for the phase's line)."""
    import threading

    from picotron_tpu_torch.config import Config
    from picotron_tpu_torch.inference import tenancy
    from picotron_tpu_torch.inference.batcher import (
        ContinuousBatcher,
        GenerationResult,
        Request,
    )
    from picotron_tpu_torch.inference.engine import InferenceEngine
    from picotron_tpu_torch.models import llama
    from picotron_tpu_torch.obs import Obs, parse_prometheus
    from picotron_tpu_torch.tools import serve

    cfg = Config.from_json(CONFIG)
    cfg.inference.key_schedule = "slot"
    cfg.inference.decode_block_len = KEYS_BLOCK
    cfg.inference.attend_impl = "flash"
    cfg.validate()
    V = cfg.model.vocab_size
    engine = InferenceEngine(cfg, DEVICE, slots=8)
    params = llama.init_params(cfg.model, seed=SEED, device=engine.device)
    ContinuousBatcher(engine, params, seed=SEED).run(
        [Request("warm", list(range(1, 25)), max_new_tokens=6,
                 temperature=0.8)])
    by_path = {}

    def check_launches(path, counts):
        launches = {k.name: counts[k.name] for k in paths[path]}
        idle = [name for name, n in launches.items() if n == 0]
        if idle:
            raise AssertionError(f"kernels not launched on {path}: {idle}")
        stray = {k: n for k, n in counts.items() if n and k not in launches}
        if stray:
            raise AssertionError(f"kernels of another path launched on "
                                 f"{path}: {stray}")

    def direct():
        requests = _requests(np, V, "r")
        batcher = ContinuousBatcher(engine, params, seed=SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = batcher.run(requests)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return ([res[r.uid].tokens for r in requests],
                {"wall_s": wall,
                 "decode_tokens_per_s": (batcher.generated_tokens
                                         - len(requests))
                 / batcher.decode_seconds,
                 "tokens_per_s": batcher.generated_tokens / wall})

    def over_http(count: bool):
        requests = _requests(np, V, "r")
        # a fresh registry for this server: the engine's earlier batchers
        # counted into the one it has
        engine.obs = Obs.from_config(engine.cfg.obs)
        srv = serve.Server(engine, params, seed=SEED, log=lambda *a, **k: None)
        outs = [{} for _ in requests]
        try:
            srv.start()
            torch.cuda.synchronize()
            if count:
                for kern in all_kernels:
                    kern.launches = 0
            threads = []
            for i, r in enumerate(requests):
                spec = {"prompt": r.prompt, "uid": r.uid,
                        "max_new_tokens": r.max_new_tokens,
                        "temperature": r.temperature, "top_p": r.top_p,
                        "stream": i in HTTP_STREAMED}
                t = threading.Thread(target=_http_client,
                                     args=(srv.port, spec, outs[i]))
                t.start()
                threads.append(t)
                deadline = time.monotonic() + HTTP_TIMEOUT_S
                # the next request waits for this one's admission to the
                # queue (or its result), so both runs admit in one order
                while (r.uid not in srv.front._waiters
                       and "t_end" not in outs[i]):
                    if time.monotonic() > deadline:
                        raise AssertionError(f"serve_http: {r.uid} never "
                                             f"reached the front end")
                    time.sleep(0.001)
            for t in threads:
                t.join(HTTP_TIMEOUT_S)
                if t.is_alive():
                    raise AssertionError("serve_http: a client hung")
            torch.cuda.synchronize()
            counts = {kern.name: kern.launches for kern in all_kernels}
            st, stats = _http(srv.port, "GET", "/statz")
            mst, text = _http(srv.port, "GET", "/metrics")
            prom = parse_prometheus(text)
            if not (st == mst == 200 and stats["completed"] == len(requests)
                    and prom['picotron_requests_total{state="completed"}']
                    == stats["completed"]
                    and prom["picotron_generated_tokens_total"]
                    == stats["generated_tokens"]):
                raise AssertionError(f"serve_http: /metrics and /statz "
                                     f"disagree ({stats})")
            b = srv.front._batcher
            decode_rate = ((b.generated_tokens - len(requests))
                           / b.decode_seconds)
        finally:
            srv.drain_and_join(timeout=HTTP_TIMEOUT_S)
        for i, (r, out) in enumerate(zip(requests, outs)):
            res = out.get("result") or {}
            if (out.get("status") != 200 or res.get("finish_reason")
                    != "length" or len(res.get("tokens", ())) != NEW_TOKENS
                    or not all(0 <= t < V for t in res["tokens"])):
                raise AssertionError(f"serve_http {r.uid}: "
                                     f"{out.get('status')} {res}")
            if i in HTTP_STREAMED and out["rows"] != res["tokens"]:
                raise AssertionError(f"serve_http {r.uid}: the token rows "
                                     f"are not the result's tokens")
        wall = (max(o["t_end"] for o in outs)
                - min(o["t_send"] for o in outs))
        ttft = sorted(o["result"]["ttft_s"] for o in outs)
        host = {requests[i].uid: (outs[i]["t_first"] - outs[i]["t_send"]
                                  - outs[i]["result"]["ttft_s"])
                for i in HTTP_STREAMED}
        fig = {"wall_s": wall, "decode_tokens_per_s": decode_rate,
               "tokens_per_s": len(requests) * NEW_TOKENS / wall,
               "ttft_p50_s": ttft[len(ttft) // 2], "ttft_max_s": ttft[-1],
               "front_end_host_s": host}
        return ([o["result"]["tokens"] for o in outs], fig,
                counts if count else None)

    turns = {"direct": [], "http": []}
    want = None
    for mode in ("direct", "http", "http", "direct"):
        if mode == "direct":
            got, fig = direct()
        else:
            got, fig, counts = over_http(count=not turns["http"])
            if counts is not None:
                check_launches("serve_http", counts)
                by_path["serve_http"] = counts
        if want is None:
            want = got
        bad = {i: next((j for j, (x, y) in enumerate(zip(g, w)) if x != y),
                       min(len(g), len(w)))
               for i, (g, w) in enumerate(zip(got, want)) if g != w}
        if bad:
            raise AssertionError(f"serve_http ({mode}): streams part from "
                                 f"the direct run's at {bad}")
        turns[mode].append(fig)
    del engine, params
    torch.cuda.empty_cache()

    # -- serve_http_tenants -------------------------------------------------
    tcfg = _tenancy_config()
    pack, registry = tenancy.build_tenancy(tcfg)
    engine = InferenceEngine(tcfg, DEVICE, slots=8, adapters=pack)
    params = llama.init_params(tcfg.model, seed=SEED, device=engine.device)
    ContinuousBatcher(engine, params, seed=SEED).run(
        [Request("warm", list(range(1, 25)), max_new_tokens=2,
                 tenant="acme", adapter_slot=1)])
    srv = serve.Server(engine, params, seed=SEED, tenants=registry,
                       log=lambda *a, **k: None)
    rng = np.random.default_rng(SEED + 13)
    specs = [{"prompt": rng.integers(1, V, n).tolist(), "uid": uid,
              "max_new_tokens": NEW_TOKENS, **({"tenant": t} if t else {})}
             for uid, t, n in (("t_base", None, 130), ("t_acme", "acme", 260),
                               ("t_hooli", "hooli", 400))]
    outs = [{} for _ in specs]
    try:
        srv.start()
        st, body = _http(srv.port, "POST", "/tenants", HTTP_TENANT)
        if st != 200 or body.get("adapter_slot") != 4:
            raise AssertionError(f"serve_http_tenants: POST /tenants {st} "
                                 f"{body}")
        st, listed = _http(srv.port, "GET", "/tenants")
        names = {t["name"]: t["adapter_slot"] for t in listed["tenants"]}
        if names.get("hooli") != 4:
            raise AssertionError(f"serve_http_tenants: GET /tenants {listed}")
        torch.cuda.synchronize()
        for kern in all_kernels:
            kern.launches = 0
        threads = [threading.Thread(target=_http_client,
                                    args=(srv.port, spec, out))
                   for spec, out in zip(specs, outs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(HTTP_TIMEOUT_S)
            if t.is_alive():
                raise AssertionError("serve_http_tenants: a client hung")
        torch.cuda.synchronize()
        counts = {kern.name: kern.launches for kern in all_kernels}
        st, body = _http(srv.port, "DELETE", "/tenants/hooli")
        st2, gone = _http(srv.port, "POST", "/generate",
                          {"prompt": [1, 2, 3], "tenant": "hooli"})
        if st != 200 or st2 != 400 or "unknown tenant" not in gone["error"]:
            raise AssertionError(f"serve_http_tenants: DELETE {st} {body}, "
                                 f"then {st2} {gone}")
    finally:
        srv.drain_and_join(timeout=HTTP_TIMEOUT_S)
    check_launches("serve_http_tenants", counts)
    for spec, out in zip(specs, outs):
        res = out.get("result") or {}
        if (out.get("status") != 200 or res.get("finish_reason") != "length"
                or len(res.get("tokens", ())) != NEW_TOKENS):
            raise AssertionError(f"serve_http_tenants {spec['uid']}: "
                                 f"{out.get('status')} {res}")
    merged = llama.merge_adapter(params, pack.random_leaves(
        HTTP_TENANT["adapter_rank"], HTTP_TENANT["adapter_seed"]))
    hooli = outs[2]["result"]
    gap = _greedy_agrees(torch, llama, merged, engine.cfg, GenerationResult(
        "t_hooli", specs[2]["prompt"], hooli["tokens"], "length"))
    del merged, engine, params, srv
    torch.cuda.empty_cache()
    by_path["serve_http_tenants"] = counts
    return by_path, {
        "decode_block_len": KEYS_BLOCK,
        "streamed": [f"r{i}" for i in HTTP_STREAMED],
        "runs_in_turns": turns,
        **{f"{k}_decode_tokens_per_s_mean": statistics.mean(
            f["decode_tokens_per_s"] for f in v) for k, v in turns.items()},
        "same_bits_as_direct": True,
        "tenants_hot_added_greedy_gap": gap}


def _http_cli_run() -> dict:
    """Phase 13's CLI run: ``python -m picotron_tpu_torch.tools.serve`` on
    phase 3's config at full width with random weights, one POST, then
    SIGTERM with a streamed request in flight. Returns its figures."""
    import signal
    import tempfile
    import threading

    with open(CONFIG) as f:
        raw = json.load(f)
    raw["inference"] = {"attend_impl": "flash", "key_schedule": "slot",
                        "decode_block_len": KEYS_BLOCK}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "config.json")
        with open(path, "w") as f:
            json.dump(raw, f)
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "picotron_tpu_torch.tools.serve",
             "--config", path, "--random-init", "--port", "0"], cwd=HERE,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        lines, log = _child_lines(proc), []
        try:
            port = None
            while port is None:
                line = lines.get(timeout=HTTP_TIMEOUT_S)
                if line is None:
                    raise AssertionError(
                        f"serve CLI exited {proc.wait(60)} before serving:\n"
                        + "".join(log[-40:]))
                log.append(line)
                if line.startswith("{"):
                    evt = json.loads(line)
                    if evt.get("evt") == "serving":
                        port = evt["port"]
            startup = time.perf_counter() - t0
            st, res = _http(port, "POST", "/generate",
                            {"prompt": list(range(1, 25)),
                             "max_new_tokens": 16})
            if (st, res.get("finish_reason"), len(res.get("tokens", ()))) \
                    != (200, "length", 16):
                raise AssertionError(f"serve CLI: POST {st} {res}")
            out = {}
            client = threading.Thread(target=_http_client, args=(
                port, {"prompt": list(range(1, 33)), "stream": True,
                       "max_new_tokens": HTTP_LONG_TOKENS}, out))
            client.start()
            deadline = time.monotonic() + HTTP_TIMEOUT_S
            while "t_first" not in out and "t_end" not in out:
                if time.monotonic() > deadline:
                    raise AssertionError("serve CLI: no first token")
                time.sleep(0.005)
            at_signal = len(out.get("rows", ()))
            t_sig = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=HTTP_TIMEOUT_S)
            t_exit = time.perf_counter()
            client.join(HTTP_TIMEOUT_S)
        finally:
            proc.kill()
            proc.wait(timeout=60)
    res = out.get("result") or {}
    if rc != 0 or out.get("status") != 200 \
            or res.get("finish_reason") != "length" \
            or len(res.get("tokens", ())) != HTTP_LONG_TOKENS \
            or out["rows"] != res["tokens"]:
        raise AssertionError(f"serve CLI: exit {rc} after SIGTERM, the "
                             f"request in flight {out.get('status')} "
                             f"{res.get('finish_reason')} "
                             f"{len(res.get('tokens', ()))} tokens")
    return {"cli_startup_s": startup, "cli_sigterm_to_exit_s": t_exit - t_sig,
            "cli_tokens_after_sigterm": HTTP_LONG_TOKENS - at_signal}


# phase 14: prefill/decode disaggregation (inference/page_transport.py)
# (path, kv_cache_dtype, kv_page_policy) of its three runs, phase 5's pages
DISAGG_RUNS = (("serve_disagg", "auto", "uniform"),
               ("serve_disagg_int8", "int8", "uniform"),
               ("serve_disagg_mixed", "auto", "hot_bf16"))
# phase 5's repeat of r0: its prefill recomputes only its last row, which
# the prefill side's radix does not keep (r0's page holds that row), so its
# payload carries r0's pages and the decode side reads r0's last row where
# the colocated run reads its own. Every other greedy request's payload is
# its own prefill's bytes
REPEAT = 4
MIGRATE_FROM, MIGRATE_TO = 0, 5  # migrate_slot's slots
MIGRATE_TOKENS = 32  # the moved slot's greedy stream
HTTP_PROMPT_LEN = PAGE_LEN  # one bf16 page at full width: under the cap


def _disagg_engine(torch, path_cfg, role: str):
    """An engine of phase 5's paged layout (8 slots, flash attend) in
    ``role``, warmed up outside every counted run."""
    from picotron_tpu_torch.config import Config
    from picotron_tpu_torch.inference.batcher import ContinuousBatcher, Request
    from picotron_tpu_torch.inference.engine import InferenceEngine

    kv_dtype, policy, params = path_cfg
    cfg = Config.from_json(CONFIG)
    inf = cfg.inference
    inf.kv_layout, inf.kv_page_len, inf.kv_num_pages = "paged", PAGE_LEN, 0
    inf.prefix_cache = True
    inf.kv_cache_dtype, inf.kv_page_policy = kv_dtype, policy
    inf.role = role
    cfg.validate()
    engine = InferenceEngine(cfg, DEVICE, slots=8, attend_impl="flash")
    ContinuousBatcher(engine, params, seed=SEED).run(
        [Request("warm", list(range(1, 25)), max_new_tokens=2)])
    torch.cuda.synchronize()
    return engine


def _greedy_stream(torch, np, engine, params, cache, first: int, slot: int,
                   n: int) -> list:
    """``n`` greedy tokens of ``slot`` alone from ``first``, through
    ``decode_block``."""
    out, tok = [], first
    gen = torch.Generator(device=engine.device).manual_seed(SEED)
    S = engine.slots
    while len(out) < n:
        tokens = np.zeros(S, np.int32)
        tokens[slot] = tok
        budget = np.zeros(S, np.int32)
        budget[slot] = n - len(out)
        cache, toks, counts = engine.decode_block(
            params, cache, tokens, gen, np.full(S, -1, np.int32), budget,
            np.zeros(S, np.float32), np.zeros(S, np.int32),
            np.ones(S, np.float32))[:3]
        row = toks[slot][: int(counts[slot])].tolist()
        out += row
        tok = row[-1]
    return out


def _migrate_run(torch, np, engine, params, prompt) -> dict:
    """``migrate_slot`` on the card: ``prompt`` prefilled into slot
    ``MIGRATE_FROM``, moved to the empty slot ``MIGRATE_TO``, then decoded
    there; the stream must be the unmoved slot's bit for bit and the bytes
    moved its pages x ``_page_bytes()``."""
    streams, fig = [], {}
    for move in (False, True):
        cache = engine.init_cache()
        cache, logits = engine.prefill_paged(params, cache, prompt,
                                             MIGRATE_FROM)[:2]
        slot = MIGRATE_FROM
        if move:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cache, moved = engine.migrate_slot(cache, MIGRATE_FROM,
                                               MIGRATE_TO, prompt_ids=prompt)
            torch.cuda.synchronize()
            fig = {"migrate_s": time.perf_counter() - t0,
                   "migrate_bytes": moved,
                   "migrate_pages": engine.paged.pages_for(len(prompt))}
            slot = MIGRATE_TO
            if moved != fig["migrate_pages"] * engine._page_bytes():
                raise AssertionError(f"migrate_slot moved {moved} bytes")
        streams.append(_greedy_stream(torch, np, engine, params, cache,
                                      int(torch.argmax(logits[0])), slot,
                                      MIGRATE_TOKENS))
        del cache
    if streams[0] != streams[1]:
        raise AssertionError(f"migrate_slot: the moved stream parts from "
                             f"the unmoved one: {streams}")
    return fig


def _pages_equal(torch, pre, pcache, dec, dcache, prompt) -> int:
    """Every page of ``prompt``'s cached prefix on the decode side equals
    the prefill side's in every storage leaf (``torch.equal``); returns
    the pages compared."""
    from picotron_tpu_torch.inference.paged_kv import slice_page

    src, m_src = pre.paged.acquire_prefix(prompt)
    dst, m_dst = dec.paged.acquire_prefix(prompt)
    try:
        if m_src != len(prompt) or m_dst != len(prompt) \
                or len(src) != len(dst):
            raise AssertionError(f"a prompt of {len(prompt)} tokens is "
                                 f"cached to {m_src} and {m_dst}")
        for a, b in zip(src, dst):
            pa, pb = slice_page(pcache, a), slice_page(dcache, b)
            bad = [k for k in pa if not torch.equal(pa[k], pb[k])]
            if bad:
                raise AssertionError(f"page {b} differs from exported page "
                                     f"{a} in {bad}")
    finally:
        pre.paged.release_pages(src)
        dec.paged.release_pages(dst)
    return len(src)


def _p50_max(xs) -> dict:
    xs = sorted(xs)
    return {"p50": xs[len(xs) // 2], "max": xs[-1]}


def _disagg_phase(torch, np, card, paths, all_kernels) -> dict:
    """Phase 14: prefill/decode disaggregation on phase 5's model and
    traffic (SmolLM-1.7B at full width and depth, 8 slots, 16-row pages,
    the prefix cache, flash attend), once per entry of ``DISAGG_RUNS``.
    Each run: a colocated run (``role: "both"``) of the requests; then a
    prefill engine (``role: "prefill"``) prefills them with a budget of 1,
    each is exported with its first token, goes through ``json.dumps`` and
    ``json.loads``, and is seated on a decode engine's batcher (``role:
    "decode"``) as ``Request(kv_import=payload)``. Every kernel's count is
    set to 0 before the prefill side and read after the decode side (the
    path's counts), and read between them. Gates: the decode side runs no
    prefill dispatch and seats all 8; each greedy stream is the colocated
    one bit for bit (the repeat, ``REPEAT``, within phase 3's logit margin
    when not); every imported page equals its exported page in every leaf;
    the decode side launches A and its C variant and no B, the prefill
    side A and B; a payload with a flipped CRC self-prefills, finishes
    "length" and counts one drop; after the requests the decode pool's
    pages are held by the cache alone. The bf16 run then moves a parked
    slot (``_migrate_run``) and serves the HTTP plane (``_disagg_http``).
    Returns the counts by path."""
    from picotron_tpu_torch.config import Config
    from picotron_tpu_torch.inference.batcher import ContinuousBatcher, Request
    from picotron_tpu_torch.models import llama

    base = Config.from_json(CONFIG)
    V = base.model.vocab_size
    params = llama.init_params(base.model, seed=SEED,
                               device=torch.device(DEVICE))
    by_path = {}
    for path, kv_dtype, policy in DISAGG_RUNS:
        path_cfg = (kv_dtype, policy, params)
        names = {k.name for k in paths[path]}
        c_name = next(n for n in names if n.startswith("flash_decode"))
        colo = _disagg_engine(torch, path_cfg, "both")
        requests = _paged_requests(np, V, "r")
        cb = ContinuousBatcher(colo, params, seed=SEED)
        colo_res = cb.run(requests)
        colo_fig = _decode_figures(cb, len(requests))
        if path == "serve_disagg":
            mig = _migrate_run(torch, np, colo, params,
                               requests[len(requests) - 3].prompt)
            http_want = ContinuousBatcher(colo, params, seed=SEED).run(
                [Request("h", list(range(7, 7 + HTTP_PROMPT_LEN)),
                         max_new_tokens=16)])["h"].tokens
        del cb, colo
        torch.cuda.empty_cache()

        pre = _disagg_engine(torch, path_cfg, "prefill")
        dec = _disagg_engine(torch, path_cfg, "decode")
        pb = ContinuousBatcher(pre, params, seed=SEED)
        db = ContinuousBatcher(dec, params, seed=SEED)
        import_s = []
        import_prefix = dec.import_prefix

        def timed_import(cache, payload):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = import_prefix(cache, payload)
            torch.cuda.synchronize()
            import_s.append(time.perf_counter() - t0)
            return out

        dec.import_prefix = timed_import
        torch.cuda.synchronize()
        for kern in all_kernels:
            kern.launches = 0
        t0 = time.perf_counter()
        firsts = pb.run([Request(r.uid, r.prompt, max_new_tokens=1,
                                 temperature=r.temperature, top_p=r.top_p)
                         for r in requests])
        pre_counts = {k.name: k.launches for k in all_kernels}
        export_s, raw, wire, handoffs = [], [], [], []
        for r in requests:
            t1 = time.perf_counter()
            payload = pb.export_prefix(r.prompt,
                                       first_token=firsts[r.uid].tokens[0])
            export_s.append(time.perf_counter() - t1)
            text = json.dumps(payload)
            raw.append(payload["bytes_total"])
            wire.append(len(text))
            handoffs.append(Request(r.uid, r.prompt,
                                    max_new_tokens=r.max_new_tokens,
                                    temperature=r.temperature,
                                    top_p=r.top_p,
                                    kv_import=json.loads(text)))
        t_dec = time.perf_counter()
        res = db.run(handoffs)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        counts = {k.name: k.launches for k in all_kernels}
        dec_counts = {k: counts[k] - pre_counts[k] for k in counts}
        dec.import_prefix = import_prefix
        by_path[path] = counts

        for r in requests:
            got = res[r.uid]
            if (len(got.tokens) != NEW_TOKENS or got.finish_reason != "length"
                    or not all(0 <= t < V for t in got.tokens)):
                raise AssertionError(f"{path} {r.uid}: {len(got.tokens)} "
                                     f"tokens, {got.finish_reason}")
        st = db.stats()
        if (db.prefill_dispatches, db.handoff_seated,
                st["handoff_seated"]) != (0, len(requests), len(requests)):
            raise AssertionError(
                f"{path}: decode side {db.prefill_dispatches} prefill "
                f"dispatches, {db.handoff_seated} seated")
        stray = {k: n for k, n in counts.items() if n and k not in names}
        if (stray or not pre_counts["rmsnorm"]
                or not pre_counts["flash_attention"]
                or not dec_counts["rmsnorm"] or not dec_counts[c_name]
                or dec_counts["flash_attention"]):
            raise AssertionError(f"{path}: prefill side {pre_counts}, "
                                 f"decode side {dec_counts}")
        parted = {}
        for i, r in enumerate(requests):
            if i in SAMPLED:
                continue
            got, want = res[r.uid].tokens, colo_res[r.uid].tokens
            if got != want:
                parted[r.uid] = next(j for j, (x, y) in
                                     enumerate(zip(got, want)) if x != y)
        if set(parted) - {requests[REPEAT].uid}:
            raise AssertionError(f"{path}: greedy streams part from the "
                                 f"colocated run's at {parted}")
        repeat_gap = None
        if parted:
            repeat_gap = _greedy_agrees(torch, llama, params, dec.cfg,
                                        res[requests[REPEAT].uid])
        pages = sum(_pages_equal(torch, pre, pb._cache, dec, db._cache,
                                 r.prompt) for r in requests)
        pool = dec.paged.pool
        refs = pool.refs[1:]
        if not (np.all(refs[refs > 0] == 1)
                and dec.paged.radix.evictable_count() == pool.live_count):
            raise AssertionError(f"{path}: decode pool after the requests: "
                                 f"{pool.live_count} live, refs "
                                 f"{np.bincount(refs)}")
        # a torn payload: dropped and counted, the request self-prefills
        drops = db.obs.registry.counter("picotron_handoff_dropped_total")
        d0 = drops.value
        bad = dict(handoffs[0].kv_import,
                   crc32=handoffs[0].kv_import["crc32"] ^ 1)
        torn = db.run([Request("torn", requests[0].prompt,
                               max_new_tokens=8, kv_import=bad)])["torn"]
        if (torn.finish_reason, len(torn.tokens), drops.value - d0) != (
                "length", 8, 1) or db.handoff_seated != len(requests):
            raise AssertionError(f"{path}: a torn payload gave "
                                 f"{torn.finish_reason} "
                                 f"{len(torn.tokens)} tokens, "
                                 f"{drops.value - d0} drops")
        seat_ttft = [res[r.uid].ttft_s for r in requests]
        colo_ttft = [colo_res[r.uid].ttft_s for r in requests]
        line = {
            "main_path": f"SmolLM-1.7B {path}", "card": card,
            "kv_cache_dtype": kv_dtype, "kv_page_policy": policy,
            "requests": len(requests), "new_tokens_each": NEW_TOKENS,
            "prefill_side_s": t_dec - t0, "decode_side_s": t_end - t_dec,
            "export_s": _p50_max(export_s), "import_s": _p50_max(import_s),
            "raw_bytes": _p50_max(raw), "json_bytes": _p50_max(wire),
            "raw_bytes_total": sum(raw), "json_bytes_total": sum(wire),
            "page_bytes": dec._page_bytes(),
            "decode_tokens_per_s": _decode_figures(
                db, len(requests))["decode_tokens_per_s"],
            "colocated_decode_tokens_per_s": colo_fig["decode_tokens_per_s"],
            "seat_ttft_s": _p50_max(seat_ttft),
            "colocated_ttft_s": _p50_max(colo_ttft),
            "prefill_side_dispatches": pb.prefill_dispatches,
            "decode_side_prefill_dispatches": 0,
            "handoff_seated": len(requests),
            "prefix_remote_hits": st["prefix_remote_hits"],
            "pages_compared_equal": pages,
            "greedy_same_bits_as_colocated": [
                r.uid for i, r in enumerate(requests)
                if i not in SAMPLED and r.uid not in parted],
            "greedy_parted_at": parted, "repeat_logit_gap": repeat_gap,
            "launches_prefill_side": {n: pre_counts[n] for n in names},
            "launches_decode_side": {n: dec_counts[n] for n in names}}
        del pb, db, res, handoffs
        torch.cuda.empty_cache()
        if path == "serve_disagg":
            line.update(mig)
            line.update(_disagg_http(torch, np, pre, dec, params, http_want))
        print(json.dumps(line), flush=True)
        del pre, dec
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return by_path


def _http_declared(port: int, path: str, nbytes: int) -> int:
    """The status a POST of ``nbytes`` gets: the request declares its
    length and the server answers from it before reading a byte (a body
    over the cap is refused unread, and writing it after the refusal would
    meet a closed socket)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port,
                                      timeout=HTTP_TIMEOUT_S)
    try:
        conn.putrequest("POST", path)
        conn.putheader("Content-Type", "application/json")
        conn.putheader("Content-Length", str(nbytes))
        conn.endheaders()
        return conn.getresponse().status
    finally:
        conn.close()


def _disagg_http(torch, np, pre, dec, params, want) -> dict:
    """Phase 14's HTTP plane at full width: ``Server``s over the prefill
    and decode engines. A ``HTTP_PROMPT_LEN``-token prompt through POST
    /kv/export, then POST /generate with its ``"kv"``: ``want`` (the
    colocated tokens), ``/statz`` ``handoff_seated`` 1 and
    ``prefill_dispatches`` 0; the prefill server's /generate and the
    decode server's /kv/export answer 503; GET /kv/pages and /kv/prefixes
    answer; a two-page payload to /kv/import answers 413 (the body cap).
    Returns the figures."""
    from picotron_tpu_torch.tools import serve

    quiet = lambda *a, **k: None  # noqa: E731
    servers = [serve.Server(eng, params, seed=SEED, log=quiet)
               for eng in (pre, dec)]
    prompt = list(range(7, 7 + HTTP_PROMPT_LEN))
    try:
        for srv in servers:
            srv.start()
        ps, ds = servers[0].port, servers[1].port
        t0 = time.perf_counter()
        st, out = _http(ps, "POST", "/kv/export", {"prompt": prompt})
        t_export = time.perf_counter() - t0
        if st != 200 or len(out["kv"]["pages"]) != 1:
            raise AssertionError(f"/kv/export: {st}")
        body = json.dumps({"prompt": prompt, "max_new_tokens": 16,
                           "kv": out["kv"]})
        t0 = time.perf_counter()
        st, got = _http(ds, "POST", "/generate", json.loads(body))
        t_generate = time.perf_counter() - t0
        stz = _http(ds, "GET", "/statz")[1]
        if (st, got.get("tokens"), stz["handoff_seated"],
                stz["prefill_dispatches"]) != (200, want, 1, 0):
            raise AssertionError(f"/generate with kv: {st} {got} against "
                                 f"{want}, statz {stz.get('handoff_seated')}"
                                 f" seated")
        roles = (_http(ps, "POST", "/generate", {"prompt": prompt})[0],
                 _http(ds, "POST", "/kv/export", {"prompt": prompt})[0])
        ids = ",".join(str(t) for t in prompt)
        look = _http(ps, "GET", f"/kv/pages?ids={ids}")
        pref = _http(ps, "GET", "/kv/prefixes")
        st, two = _http(ps, "POST", "/kv/export",
                        {"prompt": list(range(7, 7 + 2 * HTTP_PROMPT_LEN))})
        big = len(json.dumps({"kv": two["kv"]}).encode())
        if big <= serve.MAX_BODY_BYTES:
            raise AssertionError(f"a two-page body of {big} bytes is under "
                                 f"the cap")
        capped = _http_declared(ds, "/kv/import", big)
        if (roles != (503, 503) or look[0] != 200
                or look[1]["matched"] != len(prompt) or pref[0] != 200
                or st != 200 or capped != 413):
            raise AssertionError(f"http plane: roles {roles}, /kv/pages "
                                 f"{look[0]}, /kv/prefixes {pref[0]}, "
                                 f"two-page export {st}, import {capped}")
    finally:
        for srv in servers:
            srv.drain_and_join(timeout=HTTP_TIMEOUT_S)
    return {"http_export_s": t_export, "http_generate_with_kv_s": t_generate,
            "http_generate_body_bytes": len(body),
            "http_same_tokens_as_colocated": True,
            "http_role_statuses": list(roles),
            "http_two_page_body_bytes": big,
            "http_two_page_import_status": capped,
            "max_body_bytes": serve.MAX_BODY_BYTES}


def _tenant_requests(np, vocab: int, tag: str, registry) -> list:
    """The tenancy phase's 10 requests in ``TENANT_TRAFFIC``'s order, each
    under its tenant's priority and adapter slot (``registry.resolve``),
    ``NEW_TOKENS`` each, ``TENANT_SAMPLED`` at temperature 0.8 and top-p
    0.9. As in the paged phase, every suffix and unrelated prompt starts
    with a token no other prompt starts with, so the radix cache can match
    only the system prompt and the repeated prompt."""
    from picotron_tpu_torch.inference.batcher import Request

    rng = np.random.default_rng(SEED)
    system = rng.integers(1, vocab, SYSTEM_LEN).tolist()
    n = len(TENANT_TRAFFIC)
    firsts = rng.choice(np.arange(1, vocab), n + 1, replace=False)
    firsts = [int(t) for t in firsts if t != system[0]][:n]
    prompts, reqs = {}, []
    for j, (uid, tenant, kind, length) in enumerate(TENANT_TRAFFIC):
        if kind == "repeat":
            prompts[uid] = list(prompts["r0"])
        else:
            head = system if kind == "system" else []
            prompts[uid] = (head + [firsts[j]]
                            + rng.integers(1, vocab, length - 1).tolist())
        t, slot = registry.resolve(tenant)
        sampled = uid in TENANT_SAMPLED
        reqs.append(Request(
            f"{tag}{uid}", prompts[uid], max_new_tokens=NEW_TOKENS,
            temperature=0.8 if sampled else 0.0,
            top_p=0.9 if sampled else 1.0, tenant=tenant,
            priority=t.priority, adapter_slot=slot,
            ttft_slo_ms=t.ttft_slo_ms, tpot_slo_ms=t.tpot_slo_ms))
    return reqs


def _tenancy_config():
    """Config #2's SmolLM-1.7B on paged bf16 pages with the radix prefix
    cache and ``TENANTS`` in an ``H_SLOTS``-slot, rank-``H_RANK`` pack."""
    from picotron_tpu_torch.config import Config

    with open(CONFIG) as f:
        raw = json.load(f)
    raw["inference"] = {
        "kv_layout": "paged", "kv_page_len": PAGE_LEN, "kv_num_pages": 0,
        "prefix_cache": True, "attend_impl": "flash",
        "tenancy": {"tenants": [dict(t) for t in TENANTS],
                    "adapter_slots": H_SLOTS, "adapter_rank": H_RANK}}
    return Config.from_dict(raw)


def _tenant_serve_phase(torch, np, card, path_kernels, all_kernels) -> dict:
    """Phase 6: several tenants in one batch. SmolLM-1.7B at full width and
    depth on paged bf16 pages (8 slots, the radix prefix cache on) with
    ``TENANTS``' adapters in one pack (``tenancy.build_tenancy``), serving
    ``TENANT_TRAFFIC``. Every kernel's count is set to 0 just before the
    run and read just after; returns those counts. Gates: every request
    gets its full budget of in-vocabulary tokens; the eight requests of
    higher classes are seated before initech's two, which were submitted
    first; only ``path_kernels`` launch and each does, H 168 times for
    every 49 launches of A (7 projections of 24 layers per model step,
    against 2 norms per layer and the final one); the prefix counters are
    the allocator's for this traffic, with the system prompt cached once
    in each of acme's, globex's and the base tenant's domains and not in
    initech's; each greedy token within ``LOGIT_MARGIN`` of the top
    logit of a full-sequence forward over its tenant's merged tree
    (``llama.merge_adapter``; the base tree for base rows); and at least
    two tenants' greedy streams leave the base model's (a token more than
    ``LOGIT_MARGIN`` below the base forward's top logit). Then the run
    once more under the profiler (H's share of device time), and the
    generate command line with ``--adapter 16:1 --check-adapter-parity``,
    on the card by default."""
    from picotron_tpu_torch.inference import tenancy
    from picotron_tpu_torch.inference.batcher import ContinuousBatcher, Request
    from picotron_tpu_torch.inference.engine import InferenceEngine
    from picotron_tpu_torch.models import llama
    from picotron_tpu_torch.ops.kernels import lora_matmul as kh
    from picotron_tpu_torch.ops.kernels import rmsnorm as ka
    from picotron_tpu_torch.tools import generate

    cfg = _tenancy_config()
    m = cfg.model
    t0 = time.perf_counter()
    pack, registry = tenancy.build_tenancy(cfg)
    engine = InferenceEngine(cfg, DEVICE, slots=8, adapters=pack)
    params = llama.init_params(m, seed=SEED, device=engine.device)
    pack.device_leaves(engine.device)
    torch.cuda.synchronize()
    print(f"engine (serve_tenants): {m.name} L={m.num_hidden_layers} "
          f"H={m.hidden_size} window={engine.max_seq_len}, "
          f"slots={engine.slots} block={engine.decode_block_len} "
          f"prefill_chunk={engine.prefill_chunk} attend=flash, paged: "
          f"page_len={engine.page_len} pages={engine.num_pages}; pack "
          f"{pack.slots} slots x rank {pack.rank}, {pack.nbytes()} bytes, "
          f"tenants {registry.snapshot()}; built in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    ContinuousBatcher(engine, params, seed=SEED).run(
        [Request("warm", list(range(1, 25)), max_new_tokens=2,
                 tenant="acme", adapter_slot=1)])
    requests = _tenant_requests(np, m.vocab_size, "", registry)
    batcher = ContinuousBatcher(engine, params, seed=SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kern in all_kernels:
        kern.launches = 0
    t0 = time.perf_counter()
    for r in requests:
        batcher.submit(r)
    batcher.step()  # the first round: every free slot seated
    seated_first = sorted(s.req.uid for s in batcher._slots if s is not None)
    while batcher.busy:
        batcher.step()
    results = batcher.take_results()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {kern.name: kern.launches for kern in all_kernels}
    launches = {kern.name: counts[kern.name] for kern in path_kernels}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    for r in requests:
        res = results[r.uid]
        if (len(res.tokens) != NEW_TOKENS or res.finish_reason != "length"
                or not all(0 <= t < m.vocab_size for t in res.tokens)):
            raise AssertionError(f"serve_tenants {r.uid}: "
                                 f"{len(res.tokens)} tokens, "
                                 f"{res.finish_reason}")
    higher = sorted(r.uid for r in requests if r.tenant != "initech")
    if seated_first != higher:
        raise AssertionError(f"serve_tenants: the first round seated "
                             f"{seated_first}, not the higher classes "
                             f"{higher}")
    idle = [name for name, n in launches.items() if n == 0]
    if idle:
        raise AssertionError(f"kernels not launched on serve_tenants: "
                             f"{idle}")
    stray = {k: n for k, n in counts.items() if n and k not in launches}
    if stray:
        raise AssertionError(f"kernels of another path launched on "
                             f"serve_tenants: {stray}")
    # per model step: H on 7 projections of every layer, A on 2 norms of
    # every layer and the final one (168 and 49 at 24 layers)
    n_a, n_h = counts[ka.KERNEL.name], counts[kh.KERNEL.name]
    h_step, a_step = 7 * m.num_hidden_layers, 2 * m.num_hidden_layers + 1
    if n_h * a_step != n_a * h_step:
        raise AssertionError(f"serve_tenants: H launched {n_h} times for "
                             f"{n_a} launches of A (want {h_step} per "
                             f"{a_step})")
    st = batcher.stats()
    got = (st["prefix_queries"], st["prefix_hits"],
           st["prefix_cached_tokens"], st["cow_copies"])
    want = (TENANT_PREFIX_QUERIES, TENANT_PREFIX_HITS, TENANT_PREFIX_CACHED,
            TENANT_COW)
    if got != want:
        raise AssertionError(f"serve_tenants: prefix queries, hits, cached "
                             f"tokens, copy-on-writes {got} (want {want})")
    system = requests[2].prompt[:SYSTEM_LEN]
    domains = {name or "base": engine.paged.radix.match(system, salt=name)[1]
               for name in ("acme", "globex", "", "initech")}
    if (min(domains["acme"], domains["globex"], domains["base"])
            < SYSTEM_LEN or domains["initech"] != 0):
        raise AssertionError(f"serve_tenants: system prompt tokens cached "
                             f"per tenant domain {domains}")
    per_tenant = {}
    for r in requests:
        per_tenant.setdefault(r.tenant or "base", []).append(r)
    for name, rs in per_tenant.items():
        tally = st["tenants"][name]
        if (tally["requests"], tally["tokens"]) != (
                len(rs), len(rs) * NEW_TOKENS):
            raise AssertionError(f"serve_tenants: tenant {name} tally "
                                 f"{tally}")

    # the greedy gate against each tenant's merged tree, and how far each
    # tenant's greedy streams sit from the base model's
    t_gate = time.perf_counter()
    gaps, base_gaps = {}, {}
    for name, rs in per_tenant.items():
        greedy = [r for r in rs if r.temperature == 0.0]
        if name == "base":
            gaps.update({r.uid: _greedy_agrees(torch, llama, params,
                                               engine.cfg, results[r.uid])
                         for r in greedy})
            continue
        t = next(t for t in TENANTS if t["name"] == name)
        merged = llama.merge_adapter(params, pack.random_leaves(
            t["adapter_rank"], t["adapter_seed"]))
        gaps.update({r.uid: _greedy_agrees(torch, llama, merged, engine.cfg,
                                           results[r.uid]) for r in greedy})
        del merged
        base_gaps[name] = max(_greedy_gap(torch, llama, params, engine.cfg,
                                          results[r.uid]) for r in greedy)
    bitten = sorted(n for n, g in base_gaps.items() if g > LOGIT_MARGIN)
    if len(bitten) < 2:
        raise AssertionError(f"serve_tenants: adapters left the base "
                             f"model's greedy streams for {bitten} only "
                             f"(base-model logit gaps {base_gaps})")
    ttft = sorted(results[r.uid].ttft_s for r in requests)
    decode_tokens = batcher.generated_tokens - len(requests)
    print(json.dumps({
        "main_path": "SmolLM-1.7B serve_tenants", "card": card,
        "requests": len(requests),
        "tenants": {r.uid: r.tenant or "base" for r in requests},
        "prompt_lens": [len(r.prompt) for r in requests],
        "new_tokens_each": NEW_TOKENS, "wall_s": wall,
        "seated_first": seated_first,
        "ttft_p50_s": ttft[len(ttft) // 2], "ttft_max_s": ttft[-1],
        "ttft_s": {r.uid: results[r.uid].ttft_s for r in requests},
        "decode_tokens_per_s": decode_tokens / batcher.decode_seconds,
        "tokens_per_s": batcher.generated_tokens / wall,
        "decode_dispatches": batcher.decode_dispatches,
        "prefill_dispatches": batcher.prefill_dispatches,
        **{k: st[k] for k in (
            "cache_bytes", "weight_bytes", "kv_pages_total",
            "prefix_queries", "prefix_hits", "prefix_cached_tokens",
            "cow_copies", "tenants")},
        "system_prompt_cached_by_domain": domains,
        "pack_bytes": pack.nbytes(),
        "pack_bytes_per_token": pack.bytes_per_token(),
        "peak_mem_gib": peak_gib, "launches": launches,
        "greedy_max_logit_gap": max(gaps.values()),
        "greedy_logit_gaps": gaps,
        "base_model_logit_gaps": base_gaps,
        "gate_s": time.perf_counter() - t_gate}), flush=True)

    t_prof = time.perf_counter()
    prof = _profile(torch, lambda: ContinuousBatcher(
        engine, params, seed=SEED).run(
            _tenant_requests(np, m.vocab_size, "p", registry)),
        "serve_tenants")
    lora_ms = sum(ms for name, ms in prof.items() if "lora_" in name)
    print(json.dumps({"profile_lora_matmul": {
        "path": "serve_tenants", "device_ms": lora_ms,
        "kernels": sorted(name[:90] for name in prof if "lora_" in name),
        "share_of_device_time": lora_ms / sum(prof.values()),
        "seconds": time.perf_counter() - t_prof}}), flush=True)
    del engine, params, batcher, results, pack
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    rc = generate.main(["--config", CONFIG, "--random-init", "--seed", "1",
                        "--prompt-ids", "5,276,388", "--prompt-ids",
                        ",".join(str(i) for i in range(1, 41)),
                        "--max-new-tokens", "8", "--slots", "2",
                        "--attend-impl", "flash", "--adapter", "16:1",
                        "--check-adapter-parity"])
    if rc != 0:
        raise AssertionError(f"generate CLI (--adapter) exited {rc}")
    print(f"generate CLI (--adapter 16:1 --check-adapter-parity) passed in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    torch.cuda.empty_cache()
    return counts


def _rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _training_agrees(torch, ts, llama, cfg, params, batch, device) -> dict:
    """Phase 8's gate: one micro-batch's loss and gradients through the
    kernels against the plain path (sdpa attention, plain RMSNorm with
    torch autograd) from the same parameters and batch."""
    from picotron_tpu_torch.config import Config

    raw = cfg.to_dict()
    raw["model"].update(attention_impl="sdpa", use_pallas_rmsnorm=False)
    plain_cfg = Config.from_dict(raw)
    cos, sin = (t.to(device) for t in llama.rope_tables(cfg))
    tokens = torch.as_tensor(batch["input_ids"][0], device=device)
    targets = torch.as_tensor(batch["target_ids"][0], device=device)
    loss_k, grads_k = ts.loss_and_grads(params, tokens, targets, cos, sin,
                                        cfg)
    loss_p, grads_p = ts.loss_and_grads(params, tokens, targets, cos, sin,
                                        plain_cfg)
    loss_k, loss_p = float(loss_k), float(loss_p)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    rel = [_rel_l2(a, b) for a, b in zip(grads_k, grads_p)]
    del grads_k, grads_p
    torch.cuda.empty_cache()
    if not (loss_rel <= LOSS_RTOL and max(rel) <= GRAD_REL_L2):
        raise AssertionError(
            f"kernel path != plain path: loss {loss_k} vs {loss_p} (rel "
            f"{loss_rel:.3g}, tol {LOSS_RTOL}); gradient rel L2 per leaf "
            f"{[round(r, 5) for r in rel]} (tol {GRAD_REL_L2})")
    return {"loss_kernels": loss_k, "loss_plain": loss_p,
            "loss_rel_err": loss_rel, "grad_rel_l2_max": max(rel),
            "grad_rel_l2": rel, "loss_rtol": LOSS_RTOL,
            "grad_rel_l2_tol": GRAD_REL_L2}


def _train_phase(torch, card: str, path_kernels, all_kernels) -> dict:
    """Phase 8: the training main path. Every kernel's count is set to 0
    just before the timed steps and read just after; returns those counts.
    ``path_kernels`` must each have launched."""
    from picotron_tpu_torch import train as train_cli
    from picotron_tpu_torch import train_step as ts
    from picotron_tpu_torch import utils
    from picotron_tpu_torch.config import Config
    from picotron_tpu_torch.data import MicroBatchDataLoader
    from picotron_tpu_torch.models import llama

    with open(CONFIG) as f:
        raw = json.load(f)
    raw["distributed"] = {}  # one of config #2's eight dp ranks
    cfg = Config.from_dict(raw)
    m, t = cfg.model, cfg.training
    device = torch.device(DEVICE)
    t0 = time.perf_counter()
    loader = MicroBatchDataLoader(cfg)
    params, opt_state = ts.init_state(cfg, device=device, seed=SEED)
    step_fn = ts.build_train_step(cfg)
    torch.cuda.synchronize()
    print(f"trainer: {m.name} L={m.num_hidden_layers} H={m.hidden_size} "
          f"heads={m.num_attention_heads}/{m.num_key_value_heads} "
          f"ffn={m.intermediate_size} vocab={m.vocab_size} {m.dtype}, seq "
          f"{t.seq_length} x micro-batch {t.micro_batch_size} x grad-acc "
          f"{t.gradient_accumulation_steps}, remat={t.remat}, set up in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    batch = next(loader)
    t0 = time.perf_counter()
    agree = _training_agrees(torch, ts, llama, cfg, params, batch, device)
    print(json.dumps({"train_gate": agree,
                      "seconds": time.perf_counter() - t0}), flush=True)

    def one_step(b):
        nonlocal params, opt_state
        params, opt_state, loss = step_fn(params, opt_state,
                                          b["input_ids"], b["target_ids"])
        return float(loss)

    losses = [one_step(batch)]
    for _ in range(WARMUP_STEPS - 1):
        losses.append(one_step(next(loader)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kern in all_kernels:
        kern.launches = 0
    times = []
    for _ in range(TIMED_STEPS):
        b = next(loader)
        t0 = time.perf_counter()
        losses.append(one_step(b))  # float() waits for the step
        times.append(time.perf_counter() - t0)
    counts = {kern.name: kern.launches for kern in all_kernels}
    launches = {kern.name: counts[kern.name] for kern in path_kernels}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    idle = [name for name, n in launches.items() if n == 0]
    if idle:
        raise AssertionError(f"kernels not launched on the training path: "
                             f"{idle}")
    step_s = statistics.median(times)
    tok_s = cfg.tokens_per_step / step_s
    n_params = llama.num_params(m)
    print(json.dumps({
        "main_path": "SmolLM-1.7B train", "card": card,
        "n_params": n_params, "tokens_per_step": cfg.tokens_per_step,
        "warmup_steps": WARMUP_STEPS, "timed_steps": TIMED_STEPS,
        "losses": losses, "step_s": times, "median_step_s": step_s,
        "tokens_per_s": tok_s,
        "mfu_pct": utils.get_mfu(tok_s, n_params, m.num_hidden_layers,
                                 m.hidden_size, t.seq_length,
                                 BF16_FLOP_PER_S),
        "peak_mem_gib": peak_gib, "launches": launches,
        "launches_per_step": {k: n / TIMED_STEPS
                              for k, n in launches.items()}}), flush=True)

    # the trainer's command line, on the card by default (its launches are
    # not part of the counted run)
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = train_cli.main(["--config", CONFIG_1, "--max-steps", "3"])
    print(out.getvalue(), end="", flush=True)
    steps = [ln for ln in out.getvalue().splitlines()
             if ln.startswith("Step:")]
    if rc != 0 or len(steps) != 3:
        raise AssertionError(f"train CLI exited {rc} with {len(steps)} "
                             f"step lines")
    print(f"train CLI passed in {time.perf_counter() - t0:.1f}s", flush=True)

    _profile(torch, lambda: one_step(next(loader)), "train")
    return counts


def _cli(fn, argv) -> tuple:
    """Run a command line's ``main`` in this process with its standard
    output captured (and printed after it): (exit code, output)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(argv)
    print(out.getvalue(), end="", flush=True)
    return rc, out.getvalue()


def _streams_of(out: str) -> list:
    """The generate command line's ``[uid] prompt=[...] -> [...]`` lines as
    (uid, prompt, tokens)."""
    return [(uid, json.loads(p), json.loads(t)) for uid, p, t in re.findall(
        r"^\[(\S+)\] prompt=(\[.*?\]) -> (\[.*?\]) \(", out, re.M)]


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, n))
               for root, _, names in os.walk(path) for n in names)


def _sigterm_child(config: str, save_dir: str, timeout: float) -> dict:
    """Phase 9's SIGTERM check: ``python -m picotron_tpu_torch.train`` in a
    child process, on the card by default, sent SIGTERM after its first
    ``Step:`` line. It must exit ``EXIT_PREEMPTED`` within ``timeout``
    seconds, having flushed a checkpoint at the step it reached."""
    import signal

    from picotron_tpu_torch.resilience.preemption import EXIT_PREEMPTED

    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "picotron_tpu_torch.train", "--config",
         config], cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=dict(os.environ, PYTHONUNBUFFERED="1"))
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("Step:"):
                proc.send_signal(signal.SIGTERM)
                t_sig = time.perf_counter()
                break
        else:
            raise AssertionError("the child trainer printed no Step: line")
        rest, _ = proc.communicate(timeout=max(timeout - (t_sig - t0), 1))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out = "".join(lines) + rest
    print(out, end="", flush=True)
    flushed = re.search(r"flushed emergency checkpoint at step (\d+)", out)
    if proc.returncode != EXIT_PREEMPTED or not flushed:
        raise AssertionError(f"SIGTERM: the child trainer exited "
                             f"{proc.returncode} (want {EXIT_PREEMPTED}) "
                             f"with{'' if flushed else ' no'} flush")
    return {"exit": proc.returncode, "step": int(flushed.group(1)),
            "seconds_to_exit_after_signal": time.perf_counter() - t_sig,
            "seconds": time.perf_counter() - t0}


def _checkpoint_phase(torch, card: str, path_kernels, all_kernels) -> dict:
    """Phase 9: checkpoints on config #1's model (full-width SmolLM-1.7B,
    5 layers, seq 128 x micro-batch 4, bf16), in a temporary directory
    that the phase deletes. Every kernel's count is set to 0 just before
    the phase and read just after; returns those counts, of which each of
    ``path_kernels`` must be above 0."""
    import shutil
    import tempfile

    from picotron_tpu_torch import checkpoint as ckpt
    from picotron_tpu_torch import train as train_cli
    from picotron_tpu_torch import train_step as ts
    from picotron_tpu_torch.config import Config
    from picotron_tpu_torch.models import llama
    from picotron_tpu_torch.tools import generate

    with open(CONFIG_1) as f:
        base = json.load(f)
    cfg = Config.from_dict(base)
    m = cfg.model
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    run_dir = os.path.join(tmp, "run")

    def config(name: str, **sections) -> str:
        raw = json.loads(json.dumps(base))
        for section, kv in sections.items():
            raw.setdefault(section, {}).update(kv)
        path = os.path.join(tmp, f"{name}.json")
        with open(path, "w") as f:
            json.dump(raw, f)
        return path

    def counted(fn) -> dict:
        for kern in all_kernels:
            kern.launches = 0
        fn()
        torch.cuda.synchronize()
        return {kern.name: kern.launches for kern in all_kernels}

    totals = {kern.name: 0 for kern in all_kernels}
    stages, t_stage = {}, [time.perf_counter()]

    def stage(name: str) -> None:
        now = time.perf_counter()
        stages[name] = now - t_stage[0]
        t_stage[0] = now

    def add(counts: dict) -> dict:
        for k, n in counts.items():
            totals[k] += n
        return counts

    try:
        # 1. four steps saving every two, the command line resuming at step
        # 4 to step 6, and an uninterrupted six-step run: the same losses
        four, resumed, whole = [], [], []
        add(counted(lambda: train_cli.train(
            Config.from_json(config("four", training={"total_train_steps": 4},
                                    checkpoint={"save_dir": run_dir,
                                                "save_frequency": 2})),
            loss_history=four)))
        if ckpt.CheckpointManager(run_dir).all_steps() != [2, 4]:
            raise AssertionError(f"saved steps: "
                                 f"{ckpt.CheckpointManager(run_dir).all_steps()}")
        resume_cfg = config("resume", training={"total_train_steps": 6},
                            checkpoint={"save_dir": run_dir,
                                        "save_frequency": 2,
                                        "load_path": "auto"})
        out = {}

        def run_resume():
            out["rc"], out["text"] = _cli(
                lambda argv: train_cli.main(argv, loss_history=resumed),
                ["--config", resume_cfg])

        add(counted(run_resume))
        if out["rc"] != 0 or f"resumed from {run_dir} at step 4 " not in \
                out["text"] or [s for s, _ in resumed] != [5, 6]:
            raise AssertionError(f"resume: exit {out['rc']}, steps "
                                 f"{[s for s, _ in resumed]}")
        add(counted(lambda: train_cli.train(
            Config.from_json(config("whole", training={"total_train_steps": 6},
                                    checkpoint={"save_dir": os.path.join(
                                        tmp, "unused")})),
            loss_history=whole)))
        got = [x for _, x in four + resumed]
        want = [x for _, x in whole]
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        resume = {"losses_resumed": got, "losses_whole": want,
                  "bit_identical": got == want, "max_rel_diff": rel}
        print(json.dumps({"checkpoint_resume": resume}), flush=True)
        if got != want:
            raise AssertionError(f"resumed losses {got} != uninterrupted "
                                 f"{want} (max rel {rel:.3g})")
        for old in (2, 4):  # step 6 is the one served below
            shutil.rmtree(ckpt.CheckpointManager(run_dir).step_dir(old))
        stage("save_and_resume")

        # 2. a full restore (parameters and moments) of step 6 into a
        # fresh state, a save of it, and the HF export of its parameters
        params, opt_state = ts.init_state(cfg, device=DEVICE, seed=SEED + 1)
        mgr = ckpt.CheckpointManager(run_dir)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, step, _ = mgr.load(params, opt_state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        restore_bytes = _dir_bytes(mgr.step_dir(step))
        if step != 6 or opt_state["count"] != 6:
            raise AssertionError(f"restored step {step}, count "
                                 f"{opt_state['count']}")
        t0 = time.perf_counter()
        save_bytes = ckpt.CheckpointManager(os.path.join(tmp, "save")).save(
            step, params, opt_state, 6 * cfg.tokens_per_step)
        save_s = time.perf_counter() - t0
        shutil.rmtree(os.path.join(tmp, "save"))
        del opt_state
        hf_path = os.path.join(tmp, "hf", "model.safetensors")
        t0 = time.perf_counter()
        export_bytes = ckpt.save_hf_safetensors(params, hf_path)
        export_s = time.perf_counter() - t0
        for p in ts.param_leaves(params):
            p.requires_grad_(False)
        torch.cuda.empty_cache()

        loads = {}
        for wdt in ("bf16", "int8"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tree = ckpt.load_hf_safetensors(hf_path, m, weight_dtype=wdt,
                                            device=DEVICE)
            torch.cuda.synchronize()
            loads[wdt] = time.perf_counter() - t0
            if wdt == "bf16":
                for a, b in zip(ts.param_leaves(tree),
                                ts.param_leaves(params)):
                    if not torch.equal(a, b):
                        raise AssertionError("the HF export does not load "
                                             "back to the same bits")
            del tree
        torch.cuda.empty_cache()
        stage("restore_save_export_load")

        # 3. SIGTERM: a child trainer flushes and exits 75
        sig_dir = os.path.join(tmp, "sigterm")
        sig = _sigterm_child(config("sigterm", training={
            "total_train_steps": 1000},
            checkpoint={"save_dir": sig_dir, "save_frequency": 1000},
            resilience={"handle_signals": True}), sig_dir, timeout=240)
        _, sig_step, _ = ckpt.CheckpointManager(sig_dir).load_params(
            m, device=DEVICE)
        if sig_step != sig["step"]:
            raise AssertionError(f"SIGTERM: flushed step {sig['step']}, "
                                 f"restored {sig_step}")
        shutil.rmtree(sig_dir)
        stage("sigterm")

        # 4. serve the export and the checkpoint: the same greedy tokens,
        # each stream within the margin of the loaded weights' top logit
        prompts = ["--prompt-ids", "5,276,388", "--prompt-ids",
                   ",".join(str(i) for i in range(1, 41))]
        common = ["--config", CONFIG_1, *prompts, "--max-new-tokens", "16",
                  "--slots", "2", "--attend-impl", "flash"]
        streams, serve_launches = {}, {}
        for source, arg in (("hf", ["--hf-path", hf_path]),
                            ("load", ["--load-path", run_dir])):
            def serve(arg=arg, source=source):
                out["rc"], out["text"] = _cli(generate.main, [*arg, *common])
                streams[source] = _streams_of(out["text"])

            serve_launches[source] = add(counted(serve))
            if out["rc"] != 0 or len(streams[source]) != 2:
                raise AssertionError(f"generate --{source}: exit "
                                     f"{out['rc']}")
        if streams["hf"] != streams["load"]:
            raise AssertionError(f"--hf-path and --load-path streams "
                                 f"differ: {streams}")
        gaps = {}
        for uid, prompt, tokens in streams["hf"]:
            res = type("Result", (), {"uid": uid, "prompt": prompt,
                                      "tokens": tokens})
            gaps[uid] = _greedy_agrees(torch, llama, params, cfg, res)

        def serve_int8():
            out["rc"], out["text"] = _cli(generate.main, [
                "--hf-path", hf_path, *common, "--weight-dtype", "int8",
                "--kv-cache-dtype", "int8", "--check-weight-parity"])

        serve_launches["hf_int8"] = add(counted(serve_int8))
        if out["rc"] != 0:
            raise AssertionError(f"generate --hf-path --weight-dtype int8: "
                                 f"exit {out['rc']}")
        need = {"hf": ("rmsnorm", "flash_attention", "flash_decode"),
                "load": ("rmsnorm", "flash_attention", "flash_decode"),
                "hf_int8": ("quant_matmul", "flash_decode_int8")}
        for source, names in need.items():
            idle = [n for n in names if not serve_launches[source].get(n)]
            if idle:
                raise AssertionError(f"generate ({source}) launched no "
                                     f"{idle}")
        stage("serve")
        idle = [k.name for k in path_kernels if totals[k.name] == 0]
        if idle:
            raise AssertionError(f"kernels not launched on the checkpoint "
                                 f"path: {idle}")
        print(json.dumps({"checkpoint": {
            "card": card, "model": f"{m.name} L={m.num_hidden_layers} "
                                   f"H={m.hidden_size} {m.dtype}",
            "n_params": llama.num_params(m),
            "save_s": save_s, "save_bytes": save_bytes,
            "restore_s": restore_s, "restore_bytes": restore_bytes,
            "hf_export_s": export_s, "hf_export_bytes": export_bytes,
            "hf_load_s_bf16": loads["bf16"], "hf_load_s_int8": loads["int8"],
            "resume": {"bit_identical": resume["bit_identical"],
                       "max_rel_diff": resume["max_rel_diff"]},
            "sigterm": sig, "greedy_max_logit_gap": max(gaps.values()),
            "serve_launches": serve_launches, "stage_s": stages,
            "launches": {k.name: totals[k.name] for k in path_kernels}}}),
            flush=True)
        return totals
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "picotron_tpu_torch")):
        raise RuntimeError("run chip_smoke.py from a checkout of the repo")
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    # full-precision fp32 products in the plain versions (PyTorch's
    # defaults for matmul; cuDNN's default is TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)

    from picotron_tpu_torch.ops.kernels import (
        KERNELS,
        SERVING_INT8_KERNELS,
        SERVING_KERNELS,
        SERVING_MIXED_KERNELS,
        SERVING_PAGED_INT8_KERNELS,
        SERVING_PAGED_KERNELS,
        SERVING_TENANT_KERNELS,
        TRAINING_KERNELS,
        build,
    )
    # the checkpoint phase trains and resumes (A, B, D, E, F), then serves
    # the loaded weights in bf16 (A, B, C) and int8 (A, B, G, C-int8)
    CHECKPOINT_KERNELS = tuple({k.name: k for k in TRAINING_KERNELS
                                + SERVING_KERNELS
                                + SERVING_INT8_KERNELS}.values())

    # 1. build
    build_s = build.timed_library()
    print(f"kernels built from {build.CSRC} in {build_s:.2f}s", flush=True)
    log = os.path.join(build.BUILD_ROOT, build.source_hash(), "build.log")
    with open(log) as f:
        for line in _ptxas_summary(f.read()):
            print("  ptxas: " + line, flush=True)
    print(json.dumps({"sass_flash_decode": _sass_check(build.build())}),
          flush=True)
    print(json.dumps({"sass_quant_matmul": _sass_quant_check(
        build.build())}), flush=True)

    # 2. kernels against their plain versions
    t0 = time.perf_counter()
    records = _kernel_checks(torch, F)
    from picotron_tpu_torch.ops.kernels import decode_attention as kc
    _counters_zero(torch, kc)
    torch.cuda.empty_cache()
    print(f"kernel checks passed in {time.perf_counter() - t0:.1f}s",
          flush=True)

    def timed(label, fn):
        t0 = time.perf_counter()
        out = fn()
        print(f"phase {label} passed in {time.perf_counter() - t0:.1f}s",
              flush=True)
        return out

    # 3 and 4. the serving path and where its device time goes
    # the spec-off figures and streams of phases 3 and 5, for phase 10
    spec_off = {"serve": {}}
    by_path = {"serve": timed("serve", lambda: _serve_phase(
        torch, np, card, CONFIG, "SmolLM-1.7B serve", False,
        SERVING_KERNELS, KERNELS, keep=spec_off["serve"]))}
    # 5. the paged serving path, three page storages
    paths = {"serve": SERVING_KERNELS,
             "serve_paged": SERVING_PAGED_KERNELS,
             "serve_paged_int8": SERVING_PAGED_INT8_KERNELS,
             "serve_mixed": SERVING_MIXED_KERNELS,
             "serve_tenants": SERVING_TENANT_KERNELS,
             "serve_int8": SERVING_INT8_KERNELS,
             "train": TRAINING_KERNELS,
             "serve_spec": SERVING_KERNELS,
             "serve_spec_learned": SERVING_KERNELS,
             "serve_spec_paged": SERVING_PAGED_KERNELS,
             "serve_spec_oracle": SERVING_KERNELS,
             "serve_spec_offscript": SERVING_KERNELS,
             "serve_slot": SERVING_KERNELS,
             "serve_slot_spec": SERVING_KERNELS,
             "sample_on_device": SERVING_KERNELS,
             "serve_chaos": SERVING_KERNELS,
             "serve_overlap": SERVING_KERNELS,
             "serve_lane_paged": SERVING_PAGED_KERNELS,
             "serve_lane_spec": SERVING_KERNELS,
             "serve_http": SERVING_KERNELS,
             "serve_http_tenants": SERVING_TENANT_KERNELS,
             "serve_disagg": SERVING_PAGED_KERNELS,
             "serve_disagg_int8": SERVING_PAGED_INT8_KERNELS,
             "serve_disagg_mixed": SERVING_MIXED_KERNELS}
    by_path.update(timed("serve_paged", lambda: _paged_serve_phase(
        torch, np, card, paths, KERNELS, keep=spec_off)))
    # 6. several tenants in one batch: the multi-LoRA path through H
    by_path["serve_tenants"] = timed("serve_tenants", lambda: (
        _tenant_serve_phase(torch, np, card, SERVING_TENANT_KERNELS,
                            KERNELS)))
    # 7. the int8 serving path: Llama-2-7B, int8 weights and KV cache
    by_path["serve_int8"] = timed("serve_int8", lambda: _serve_phase(
        torch, np, card, CONFIG_7B, "Llama-2-7B serve int8", True,
        SERVING_INT8_KERNELS, KERNELS))
    # 8. the training path at full width and depth
    by_path["train"] = timed("train", lambda: _train_phase(
        torch, card, TRAINING_KERNELS, KERNELS))
    # 9. checkpoints: save, resume, the SIGTERM flush, export and serving
    # the loaded weights (bf16, then int8)
    by_path["checkpoint"] = timed("checkpoint", lambda: _checkpoint_phase(
        torch, card, CHECKPOINT_KERNELS, KERNELS))
    # 10. speculative decoding on phase 3's model: n-gram, learned with the
    # controller, paged, and drafts that are phase 3's own streams
    by_path.update(timed("serve_spec", lambda: _spec_serve_phase(
        torch, np, card, paths, KERNELS, spec_off)))
    # 11. the per-slot key schedule, sampling in the dispatch and the
    # fault-tolerant serving round on phase 3's model
    by_path.update(timed("serve_keys", lambda: _keys_and_faults_phase(
        torch, np, card, paths, KERNELS, spec_off)))
    # 12. the overlap pipeline and the mixed prefill lane on phase 3's model
    by_path.update(timed("serve_pipeline", lambda: _pipeline_phase(
        torch, np, card, paths, KERNELS)))
    # 13. the HTTP front end: in process, tenants, the CLI, --smoke
    by_path.update(timed("serve_http", lambda: _http_phase(
        torch, np, card, paths, KERNELS)))
    # 14. prefill/decode disaggregation: the page transport, migrate_slot
    # and the serve /kv plane
    by_path.update(timed("serve_disagg", lambda: _disagg_phase(
        torch, np, card, paths, KERNELS)))

    # 15. the closing lines: each kernel's launches on its own path (the
    # first path that runs it: serving for A, B, C; each paged run for its
    # variant of C; the tenancy run for H; int8 serving for C-int8 and G;
    # training for D, E, F), and on each path
    own = {}
    for path, path_kernels in paths.items():
        for k in path_kernels:
            own.setdefault(k.name, path)
    kernels = [{"name": k.name, "route": k.route, "source": k.source,
                "replaces": k.replaces,
                "launches": by_path[own[k.name]][k.name],
                "launches_by_path": {path: counts[k.name]
                                     for path, counts in by_path.items()},
                **{key: records[k.name].get(key) for key in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "shape", *DEVICE_KEYS, "lse", "d128",
                    "chunk", "residual", "residual_chunk", "prefill",
                    "lm_head", "train", "h4096", "verify", "verify_d128",
                    "verify_d64", "verify_gqa", "verify_lm_head",
                    "residual_verify")}}
               for k in KERNELS]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as e:  # noqa: BLE001 - any failed phase fails the run
        import traceback

        traceback.print_exc()
        print(f"chip_smoke FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        sys.exit(1)
