"""Chip smoke test of the PyTorch port (picotron_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each of which must pass:

1. the card's name and power limit (nvidia-smi), then the CUDA kernels
   built from this checkout's sources (build seconds printed, and each
   kernel's registers and spills as ptxas reports them);
2. every kernel against its plain PyTorch version on the card, in bf16, at
   the main paths' shapes plus a ragged and a GQA shape (B and C at
   head_dim 64 and 128; G at every projection shape of Llama-2-7B; C's
   int8 variant at its decode and chunk shapes): one JSON line per shape
   with the kernel's time, the plain version's, one library call's (a
   yardstick only; the port never calls it) and the card's lower bound.
   The backward kernels' library yardstick is F.rms_norm and
   F.scaled_dot_product_attention under autograd, timed as forward +
   backward less forward; G's is aten's int8-weight matmul (or cuBLAS on a
   bf16 copy of the weight), C-int8's SDPA over a dequantized copy;
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
   time went, and the device's busy share of the wall time;
5. the int8 serving path: config #4's model (Llama-2-7B at full width and
   depth, random weights from a fixed seed quantized on the card) with
   ``weight_dtype`` and ``kv_cache_dtype`` "int8", serving the same 8
   requests, under the same checks; every product runs through G and every
   cache attend through C's int8 variant, and its profile must show no
   library GEMM or attention kernel; then the generate command line with
   ``--weight-dtype int8 --kv-cache-dtype int8``;
6. the training path: config #2's ``model`` and ``training`` sections on a
   single device (full-width, 24-layer SmolLM-1.7B, seq 2048 x micro-batch
   4, remat "full", AdamW) from a fixed seed over the synthetic loader.
   First the gate: one step's loss and gradients through the kernels must
   agree with the plain path (``attention_impl: "sdpa"``,
   ``use_pallas_rmsnorm: false``) from the same parameters and batch. Then
   warm-up steps and timed steps: every loss finite, every training
   kernel launched. Then the ``picotron_tpu_torch.train`` command line on
   config #1, on the card by default, and one training step under
   torch.profiler;
7. a ``{"kernels": [...]}`` line with each kernel's launches on its own
   path (and on each path: ``serve``, ``serve_int8``, ``train``), then
   ``{"ok": true, "device": {...}}`` as the last line.

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
SAMPLED = (3, 6)  # request indices drawn at temperature 0.8, top-p 0.9
LOGIT_MARGIN = 0.3  # greedy token vs the reference's top logit (see phase 3)
RTOL = ATOL = 2e-2  # kernel vs plain version in bf16 (see _check)
# G's (K, N) on the Llama-2-7B path: wq/wk/wv/wo, w_gate/w_up, w_down,
# lm_head
G_SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000))
WARMUP_STEPS = 2  # training steps before the timed ones
TIMED_STEPS = 8
# kernel path vs plain path, one training step in bf16 (phase 6): the two
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


def _ptxas_summary(log: str) -> list:
    """One line per compiled kernel from ``nvcc -Xptxas -v`` output: its
    name with template arguments, registers, and spill bytes."""
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
            out.append(f"{name}: {regs.group(1) if regs else '?'} registers, "
                       f"{spill}")
    return out


def _bound(nbytes: float, flops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _check(name, got, want, mask=None) -> float:
    """Max |kernel - plain| over the compared entries; fails past
    |d| <= ATOL + RTOL * |plain|. Both sides are bf16 outputs of fp32
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
    bad = err > ATOL + RTOL * want.abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} entries outside tolerance, max abs "
            f"err {float(err.max()):.4g}")
    return float(err.max())


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
               variant=None, library=None):
        """One shape's JSON line; the main-path shape's numbers go to the
        closing line, and a variant's (B with its LSE, B and C at
        head_dim 128) beside them, under the variant's name."""
        line = {"kernel": kernel.name, "shape": shape, "max_abs_err": err,
                "kernel_ms": ms, "plain_ms": plain_ms,
                "library_ms": library_ms, "bound_ms": bound[0],
                "bound_by": bound[1]}
        if library is not None:
            line["library"] = library
        print(json.dumps(line), flush=True)
        rec = records.setdefault(kernel.name, {"max_abs_err": 0.0})
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        if main:
            (rec.setdefault(variant, {}) if variant else rec).update(
                shape=shape, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound[0], bound_by=bound[1])

    # A: RMSNorm over [rows, 2048] (decode: rows = slots; prefill: bucket)
    H, eps = 2048, 1e-5
    for rows in (8, 512):
        x, w = randn(rows, H), (1.0 + 0.1 * randn(H).float()).to(bf)
        err = _check(f"rmsnorm rows={rows}", ka.rms_norm(x, w, eps),
                     ka.rms_norm_plain(x, w, eps))
        record(ka.KERNEL, {"rows": rows, "H": H}, err,
               _time_ms(lambda: ka.rms_norm(x, w, eps)),
               _time_ms(lambda: ka.rms_norm_plain(x, w, eps)),
               (_time_ms(lambda: F.rms_norm(x, (H,), w, eps))
                if hasattr(F, "rms_norm") else None),
               _bound((2 * rows * H + H) * 2, 0.0), main=rows == 8)

    # B: causal prefill attention, [1, S, 32, D]; one GQA shape (g = 4);
    # D = 64 (SmolLM) and D = 128 (Llama-2-7B)
    for D, S, nh, nkv in ((D, S, nh, nkv) for D in (64, 128)
                          for S, nh, nkv in ((16, 32, 32), (48, 32, 32),
                                             (512, 32, 32), (2048, 32, 32),
                                             (512, 32, 8))):
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
    # 16-wide block), one slot empty; the 512-wide chunked-prefill shape;
    # one GQA shape (g = 4); D = 64 and D = 128
    T = 2048
    lens8 = [0, 1, 17, 128, 129, 700, 1500, 2048]
    for D, B, S, nh, nkv, lens in (
            (D, *shape) for D in (64, 128)
            for shape in ((8, 1, 32, 32, lens8), (8, 16, 32, 32, lens8),
                          (1, 512, 32, 32, [1536]), (8, 1, 32, 8, lens8))):
        q = randn(B, S, nh, D)
        k, v = randn(B, T, nkv, D), randn(B, T, nkv, D)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        scale = D ** -0.5
        live = lengths > 0  # an empty slot's rows are not compared
        err = _check(f"flash_decode B={B} S={S} H={nh} Hkv={nkv}",
                     kc.flash_decode_attention(q, k, v, lengths, scale),
                     kc.flash_decode_attention_plain(q, k, v, lengths,
                                                     scale), mask=live)
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
        record(kc.KERNEL, {"B": B, "S": S, "H": nh, "Hkv": nkv, "T": T,
                           "D": D, "lengths": lens}, err,
               _time_ms(lambda: kc.flash_decode_attention(q, k, v, lengths,
                                                          scale)),
               _time_ms(lambda: kc.flash_decode_attention_plain(
                   q, k, v, lengths, scale)),
               _time_ms(lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, attn_mask=amask, scale=scale)),
               _bound(nbytes, 4 * D * nh * visible),
               main=(B, S, nkv) == (8, 1, 32),
               variant="d128" if D == 128 else None)
    _int8_kernel_checks(torch, F, randn, record)
    _training_kernel_checks(torch, F, randn, record)
    return records


def _int8_kernel_checks(torch, F, randn, record) -> None:
    """Phase 2, the int8 serving path's kernels: G at each projection
    shape of Llama-2-7B with M in {1, 8, 512}, plus ragged shapes; C's int8
    variant at the decode and chunk shapes (T = 4096, D = 128), ragged
    lengths with one slot empty, and one GQA shape."""
    from picotron_tpu_torch.inference.kv_cache import quantize_kv
    from picotron_tpu_torch.ops.kernels import decode_attention as kc
    from picotron_tpu_torch.ops.kernels import quant_matmul as kg
    from picotron_tpu_torch.ops.quant_matmul import quantize_weight

    dev = torch.device(DEVICE)
    int8mm = getattr(torch.ops.aten, "_weight_int8pack_mm", None)
    for M, K, N in [(M, K, N) for K, N in G_SHAPES for M in (1, 8, 512)] \
            + [(37, 4100, 1000), (5, 4100, 1000)]:
        x = randn(M, K)
        w = quantize_weight(randn(K, N).float() * 0.02)
        q, s = w["q"], w["s"]
        err = _check(f"quant_matmul M={M} K={K} N={N}",
                     kg.quant_matmul_2d(x, q, s),
                     kg.quant_matmul_plain(x, q, s))
        # the yardstick: aten's int8-weight matmul where this torch has it
        # for CUDA, else cuBLAS on a bf16 copy of the weight made here,
        # outside the timing
        lib_name, lib_ms = None, None
        if int8mm is not None:
            qt, sb = q.t().contiguous(), s.to(torch.bfloat16)
            try:
                int8mm(x, qt, sb)
                lib_ms = _time_ms(lambda: int8mm(x, qt, sb))
                lib_name = "aten._weight_int8pack_mm"
            except (RuntimeError, NotImplementedError):
                pass
            del qt, sb
        if lib_ms is None:
            wb, sb = q.to(torch.bfloat16), s.to(torch.bfloat16)
            lib_ms = _time_ms(lambda: (x @ wb) * sb)
            lib_name = "matmul on a bf16 copy, times s"
            del wb, sb
        record(kg.KERNEL, {"M": M, "K": K, "N": N}, err,
               _time_ms(lambda: kg.quant_matmul_2d(x, q, s)),
               _time_ms(lambda: kg.quant_matmul_plain(x, q, s)), lib_ms,
               _bound(M * K * 2 + K * N + N * 4 + M * N * 2, 2 * M * K * N),
               main=(M, K, N) == (8, 4096, 11008), library=lib_name)
        del x, w, q, s
    torch.cuda.empty_cache()

    T, D = 4096, 128
    lens8 = [0, 1, 130, 257, 700, 964, 2000, 4096]
    for B, S, nh, nkv, lens in ((8, 1, 32, 32, lens8),
                                (1, 512, 32, 32, [1024]),
                                (1, 512, 32, 32, [900]),
                                (8, 1, 32, 8, lens8)):
        q = randn(B, S, nh, D)
        kq, ks = quantize_kv(randn(B, T, nkv, D))
        vq, vs = quantize_kv(randn(B, T, nkv, D))
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        scale = D ** -0.5
        live = lengths > 0
        err = _check(f"flash_decode_int8 B={B} S={S} H={nh} Hkv={nkv}",
                     kc.flash_decode_attention(q, kq, vq, lengths, scale,
                                               ks, vs),
                     kc.flash_decode_attention_int8_plain(
                         q, kq, vq, lengths, scale, ks, vs), mask=live)
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
        record(kc.KERNEL_INT8, {"B": B, "S": S, "H": nh, "Hkv": nkv, "T": T,
                                "D": D, "lengths": lens}, err,
               _time_ms(lambda: kc.flash_decode_attention(
                   q, kq, vq, lengths, scale, ks, vs)),
               _time_ms(lambda: kc.flash_decode_attention_int8_plain(
                   q, kq, vq, lengths, scale, ks, vs)),
               _time_ms(lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, attn_mask=amask, scale=scale)),
               _bound(nbytes, 4 * D * nh * visible),
               main=(B, S, nkv) == (8, 1, 32))
        del q, kq, vq, ks, vs, kt, vt, qt
        torch.cuda.empty_cache()


def _fwd_bwd_less_fwd_ms(torch, fwd, inputs, grad_out) -> float:
    """A library call's backward time: forward + backward less forward,
    under autograd, for ``inputs`` that require gradients."""
    def both():
        for t in inputs:
            t.grad = None
        fwd().backward(grad_out)

    def fwd_only():
        with torch.no_grad():
            fwd()

    return _time_ms(both) - _time_ms(fwd_only)


def _training_kernel_checks(torch, F, randn, record) -> None:
    """Phase 2, training kernels: D (RMSNorm backward), B with its LSE, E
    (dQ) and F (dK/dV) at the training shapes, a ragged shape and a GQA
    shape."""
    from picotron_tpu_torch.ops.kernels import flash_attention as kb
    from picotron_tpu_torch.ops.kernels import rmsnorm as ka

    # D: RMSNorm backward over [rows, 2048]; 8192 rows = seq 2048 x
    # micro-batch 4, and one ragged row count
    H, eps = 2048, 1e-5
    for rows in (8192, 1000):
        x, dy = randn(rows, H), randn(rows, H)
        w = (1.0 + 0.1 * randn(H).float()).to(torch.bfloat16)
        dx, dw = ka.rms_norm_bwd(x, w, dy, eps)
        pdx, pdw = ka.rms_norm_bwd_plain(x, w, dy, eps)
        err = max(_check(f"rmsnorm_bwd dx rows={rows}", dx, pdx),
                  _check(f"rmsnorm_bwd dw rows={rows}", dw, pdw))
        xl, wl = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        lib = (_fwd_bwd_less_fwd_ms(
            torch, lambda: F.rms_norm(xl, (H,), wl, eps), (xl, wl), dy)
               if hasattr(F, "rms_norm") else None)
        record(ka.KERNEL_BWD, {"rows": rows, "H": H}, err,
               _time_ms(lambda: ka.rms_norm_bwd(x, w, dy, eps)),
               _time_ms(lambda: ka.rms_norm_bwd_plain(x, w, dy, eps)),
               lib, _bound((3 * rows * H + 2 * H) * 2, 0.0),
               main=rows == 8192)

    # B with its LSE, E and F: [4, 2048, 32, 64] (the training shape), a
    # ragged S, and one GQA shape (g = 4)
    for B, S, nh, nkv in ((4, 2048, 32, 32), (2, 130, 32, 32),
                          (1, 1024, 32, 8)):
        D = 64
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


def _greedy_agrees(torch, llama, params, cfg, res) -> float:
    """The worst gap between a generated token's logit and the top logit
    of a full-sequence forward over prompt + generated tokens: the
    KV-cache path (prefill, chunks, decode blocks) must reproduce the
    full-sequence model up to bf16 noise. A wrong cache position or mask
    would pick tokens far from the top (about two units below it for a
    random token of this model)."""
    seq = res.prompt + res.tokens
    toks = torch.tensor([seq], dtype=torch.int64, device=DEVICE)
    logits = llama.forward_logits(params, toks, cfg)[0].float()
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{res.uid}: non-finite reference logits")
    n = len(res.prompt)
    rows = logits[n - 1: len(seq) - 1]
    picked = rows.gather(1, torch.tensor(res.tokens, device=DEVICE)[:, None])
    gap = float((rows.amax(dim=1) - picked[:, 0]).max())
    if gap > LOGIT_MARGIN:
        raise AssertionError(
            f"{res.uid}: a greedy token sits {gap:.3f} below the "
            f"full-sequence top logit (margin {LOGIT_MARGIN})")
    return gap


def _profile(torch, run, path: str) -> list:
    """Phases 4, 5 and 6: ``run`` (a main path's work once more) under
    torch.profiler. Prints one ``{"profile": ...}`` line: the wall time,
    the summed device time of every kernel (one stream, so kernels do not
    overlap and the sum over the wall is the device's busy share), and the
    kernels that took the most device time. Returns every kernel's name."""
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        t = getattr(e, "self_device_time_total", None)
        return t if t is not None else e.self_cuda_time_total

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # kernels only: an operator's row repeats the time of the kernels it
    # launched
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA") and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    top = sorted(events, key=dev_us, reverse=True)[:15]
    print(json.dumps({"profile": {
        "path": path, "wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / (wall * 1e3),
        "top": [{"name": e.key[:90], "calls": e.count,
                 "device_ms": dev_us(e) / 1e3} for e in top]}}), flush=True)
    return [e.key for e in events]


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
                 path_kernels, all_kernels) -> dict:
    """Phases 3 to 5, one serving path: the model of ``config`` at full
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
    card by default (its launches are not part of the counted run)."""
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


def _rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _training_agrees(torch, ts, llama, cfg, params, batch, device) -> dict:
    """Phase 6's gate: one micro-batch's loss and gradients through the
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
    """Phase 6: the training main path. Every kernel's count is set to 0
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
        TRAINING_KERNELS,
        build,
    )

    # 1. build
    build_s = build.timed_library()
    print(f"kernels built from {build.CSRC} in {build_s:.2f}s", flush=True)
    log = os.path.join(build.BUILD_ROOT, build.source_hash(), "build.log")
    with open(log) as f:
        for line in _ptxas_summary(f.read()):
            print("  ptxas: " + line, flush=True)

    # 2. kernels against their plain versions
    t0 = time.perf_counter()
    records = _kernel_checks(torch, F)
    torch.cuda.empty_cache()
    print(f"kernel checks passed in {time.perf_counter() - t0:.1f}s",
          flush=True)

    # 3 and 4. the serving path and where its device time goes
    by_path = {"serve": _serve_phase(torch, np, card, CONFIG,
                                     "SmolLM-1.7B serve", False,
                                     SERVING_KERNELS, KERNELS)}
    # 5. the int8 serving path: Llama-2-7B, int8 weights and KV cache
    by_path["serve_int8"] = _serve_phase(torch, np, card, CONFIG_7B,
                                         "Llama-2-7B serve int8", True,
                                         SERVING_INT8_KERNELS, KERNELS)

    # 6. the training path at full width and depth
    by_path["train"] = _train_phase(torch, card, TRAINING_KERNELS,
                                    KERNELS)

    # 7. the closing lines: each kernel's launches on its own path (the
    # first path that runs it: serving for A, B, C; int8 serving for
    # C-int8 and G; training for D, E, F), and on each path
    own = {}
    for path, path_kernels in (("serve", SERVING_KERNELS),
                               ("serve_int8", SERVING_INT8_KERNELS),
                               ("train", TRAINING_KERNELS)):
        for k in path_kernels:
            own.setdefault(k.name, path)
    kernels = [{"name": k.name, "route": k.route, "source": k.source,
                "replaces": k.replaces,
                "launches": by_path[own[k.name]][k.name],
                "launches_by_path": {path: counts[k.name]
                                     for path, counts in by_path.items()},
                **{key: records[k.name].get(key) for key in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "shape", "lse", "d128")}}
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
