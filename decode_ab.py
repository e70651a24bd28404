"""Device time of kernel C (flash decode) in its five variants, of kernel G
(the int8-weight matmul), of the model's LoRA seam (kernel H) and of kernels
A and D (RMSNorm forward and backward), for two trees in one run on one
CUDA card.

    python3 decode_ab.py --root OLD --root NEW [--only A --only D ...]

Each ``--root`` is a checkout of the repo (its ``picotron_tpu_torch``). The
trees run in the order OLD, NEW, NEW, OLD, each run in a process of its
own with that root first on ``sys.path`` (its kernels built from its own
sources), so a drift of the card over the run falls on both trees alike.
Each run calls C's wrapper on the same inputs, made on the card from a
fixed seed, at ``chip_smoke.py`` phase 2's main shapes:

- decode (S = 1): 8 slots with lengths 0 to the window, 32 kv heads; C and
  the paged variants at head_dim 64 and 128 over a 2048-key window,
  C-int8 at 128 over 4096;
- chunk (S = 512): C over 1536 keys at head_dim 64 and 128, C-int8 over
  1024 at 128, the paged variants over 812 (300 cached) at 64;
- G through ``quant_matmul_2d`` at M 8 on Llama-2-7B's projections
  (K x N 4096 x 4096, 4096 x 11008, 11008 x 4096) and its head (4096 x
  32000), and at M 512 on 4096 x 11008;
- H through each tree's own ``models.llama.matmul`` over an adapter leaf
  (a bf16 base weight, the chip smoke's rank-16 pack of 8 slots with
  adapters of rank 16, 8 and 4, null rows among the 8 decode rows): the
  interface both trees share, so a row is the base product, H and
  whatever the seam adds around it; at SmolLM-1.7B's projections at
  decode and at a 512-row chunk, and Llama-2-7B's at decode;
- A through ``rms_norm`` at rows 8, 512 and 8192 x H 2048, rows 8 x H 4096
  and a ragged rows 37 x H 1000; D through ``rms_norm_bwd`` at rows 8192,
  1000 x H 2048, rows 4096 x H 4096 and rows 37 x H 1000 (``chip_smoke.py``
  phase 2's shapes). These rows also carry the wrapper's time (CUDA events
  over 20 calls after 3, host cost included).

``--only`` keeps the rows of the named kernels (A, C, D, G, H; C takes its
five variants). A row's time is the device time of one wrapper call,
every kernel it launches summed from a torch.profiler trace of 20 calls
(the median of three traces that lost no event), so a wrapper's host cost
does not hide its kernels. Prints one JSON line per run (with the seam rows' device
kernels a call), then one summary line with each row's median per tree
and NEW / OLD.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

KERNELS = ("A", "C", "D", "G", "H")
ITERS = 20  # wrapper calls a trace
TRACES = 3  # complete traces a row


EVENTS = {}  # row -> device kernels a call, from its last complete trace


def _device_ms(torch, fn, row=None) -> float:
    """The median over ``TRACES`` profiler traces of ``ITERS`` calls of the
    device time of one call; a trace that lost an event (its count is no
    multiple of the calls) is taken again. With ``row``, the device kernels
    a call go to ``EVENTS[row]``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(5 * TRACES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(ITERS):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.profiler.kineto_results.events()
                  if str(e.device_type()).endswith("CUDA")]
        if events and len(events) % ITERS == 0:
            times.append(sum(e.duration_ns() for e in events) / 1e6 / ITERS)
            if row is not None:
                EVENTS[row] = len(events) // ITERS
            if len(times) == TRACES:
                return statistics.median(times)
    raise RuntimeError("no complete profiler trace")


def _wrapper_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """One call's time from CUDA events around ``iters`` calls."""
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


def _child(root: str, only: set) -> None:
    """One process's rows of the kernels in ``only``, on the tree at
    ``root``."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from picotron_tpu_torch.inference.kv_cache import quantize_kv
    from picotron_tpu_torch.ops.kernels import decode_attention as kc

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def lengths(lens):
        return torch.tensor(lens, dtype=torch.int32, device=dev)

    rows, wrapper = {}, {}
    decode8 = [0, 1, 17, 128, 129, 700, 1500, 2048]
    if "A" in only or "D" in only:
        _rmsnorm_rows(torch, randn, only, rows, wrapper)
    for D in ((64, 128) if "C" in only else ()):
        for B, S, lens in ((8, 1, decode8), (1, 512, [1536])):
            q, k, v = randn(B, S, 32, D), randn(B, 2048, 32, D), \
                randn(B, 2048, 32, D)
            L = lengths(lens)
            rows[f"C D{D} S{S}"] = _device_ms(
                torch, lambda: kc.flash_decode_attention(q, k, v, L,
                                                         D ** -0.5))
    for B, S, lens in (((8, 1, [0, 1, 130, 257, 700, 964, 2000, 4096]),
                        (1, 512, [1024])) if "C" in only else ()):
        q = randn(B, S, 32, 128)
        kq, ks = quantize_kv(randn(B, 4096, 32, 128))
        vq, vs = quantize_kv(randn(B, 4096, 32, 128))
        L = lengths(lens)
        rows[f"C-int8 D128 S{S}"] = _device_ms(
            torch, lambda: kc.flash_decode_attention(q, kq, vq, L,
                                                     128 ** -0.5, ks, vs))
    page_len, max_pages = 16, 128
    for D, B, S, lens in (((64, 8, 1, decode8), (128, 8, 1, decode8),
                           (64, 1, 512, [812])) if "C" in only else ()):
        counts = [-(-n // page_len) for n in lens]
        ids = (rng.permutation(sum(counts)) + 1).tolist()
        tables = np.zeros((B, max_pages), np.int32)
        for b, c in enumerate(counts):
            tables[b, :c] = [ids.pop() for _ in range(c)]
        P = sum(counts) + 1
        bt, L = torch.tensor(tables, device=dev), lengths(lens)
        q = randn(B, S, 32, D)
        k, v = randn(P, page_len, 32, D), randn(P, page_len, 32, D)
        kq, ks = quantize_kv(randn(P, page_len, 32, D))
        vq, vs = quantize_kv(randn(P, page_len, 32, D))
        flags = rng.integers(0, 2, P).astype(np.int32)
        flags[0] = 0
        pq = torch.tensor(flags, device=dev)
        sc = D ** -0.5
        rows[f"paged D{D} S{S}"] = _device_ms(
            torch, lambda: kc.flash_decode_attention(q, k, v, L, sc,
                                                     block_tables=bt))
        rows[f"paged-int8 D{D} S{S}"] = _device_ms(
            torch, lambda: kc.flash_decode_attention(
                q, kq, vq, L, sc, ks, vs, block_tables=bt))
        rows[f"mixed D{D} S{S}"] = _device_ms(
            torch, lambda: kc.flash_decode_attention(
                q, k, v, L, sc, ks, vs, block_tables=bt, k_quant=kq,
                v_quant=vq, page_quant=pq))
    from picotron_tpu_torch.models import llama
    from picotron_tpu_torch.ops.kernels import quant_matmul as kg
    from picotron_tpu_torch.ops.quant_matmul import quantize_weight

    for M, K, N in (((8, 4096, 4096), (8, 4096, 11008), (8, 11008, 4096),
                     (8, 4096, 32000), (512, 4096, 11008))
                    if "G" in only else ()):
        x = randn(M, K)
        w = quantize_weight(randn(K, N).float() * 0.02)
        rows[f"G M{M} K{K} N{N}"] = _device_ms(
            torch, lambda: kg.quant_matmul_2d(x, w["q"], w["s"]))
        del x, w
    slots, rank = 8, 16
    ids8 = torch.tensor([0, 1, 2, 3, 1, 0, 3, 2], dtype=torch.int32,
                        device=dev)
    for B, S, K, N in (((8, 1, 2048, 2048), (8, 1, 2048, 8192),
                        (8, 1, 8192, 2048), (1, 512, 2048, 2048),
                        (8, 1, 4096, 4096), (8, 1, 4096, 11008),
                        (8, 1, 11008, 4096)) if "H" in only else ()):
        a = torch.zeros(slots, K, rank, device=dev)
        b = torch.zeros(slots, rank, N, device=dev)
        for slot, r in ((1, 16), (2, 8), (3, 4)):
            a[slot, :, :r] = 0.05 * torch.randn((K, r), generator=gen,
                                                device=dev)
            b[slot, :r] = 0.05 * torch.randn((r, N), generator=gen,
                                             device=dev)
        leaf = {"w": randn(K, N) * 0.02, "a": a, "b": b,
                "ids": ids8[:B] if B == 8 else ids8[1:1 + B]}
        x = randn(B, S, K)
        row = f"seam B{B} S{S} K{K} N{N}"
        rows[row] = _device_ms(torch, lambda: llama.matmul(x, leaf), row)
        del a, b, leaf, x
    print(json.dumps({"root": root, "device_ms": rows,
                      "wrapper_ms": wrapper, "kernels_per_call": EVENTS}),
          flush=True)


def _rmsnorm_rows(torch, randn, only, rows, wrapper) -> None:
    """A's and D's rows (device and wrapper times), on the same inputs for
    both trees."""
    from picotron_tpu_torch.ops.kernels import rmsnorm as ka

    eps = 1e-5
    shapes = {"A": ((8, 2048), (512, 2048), (8192, 2048), (8, 4096),
                    (37, 1000)),
              "D": ((8192, 2048), (1000, 2048), (4096, 4096), (37, 1000))}
    for kern in ("A", "D"):
        for n, H in (shapes[kern] if kern in only else ()):
            x, dy = randn(n, H), randn(n, H)
            w = (1.0 + 0.1 * randn(H).float()).to(torch.bfloat16)
            if kern == "A":
                fn = lambda: ka.rms_norm(x, w, eps)  # noqa: E731
            else:
                fn = lambda: ka.rms_norm_bwd(x, w, dy, eps)  # noqa: E731
            row = f"{kern} rows{n} H{H}"
            rows[row] = _device_ms(torch, fn, row)
            wrapper[row] = _wrapper_ms(torch, fn)
            del x, dy, w


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", action="append", required=True,
                    help="a checkout of the repo; give exactly two")
    ap.add_argument("--only", action="append", choices=KERNELS,
                    help="time only these kernels' rows (default: all)")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    only = args.only or list(KERNELS)
    if args.child:
        _child(os.path.abspath(args.root[0]), set(only))
        return 0
    if len(args.root) != 2:
        ap.error("give exactly two --root")
    old, new = (os.path.abspath(r) for r in args.root)
    times = {"device_ms": {}, "wrapper_ms": {}}
    for root in (old, new, new, old):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", "--root",
             root, *(f"--only={k}" for k in only)], cwd=root, check=True,
            stdout=subprocess.PIPE, text=True)
        for line in out.stdout.splitlines():
            if line.startswith("{"):
                print(line, flush=True)
                rec = json.loads(line)
                for key, by_row in times.items():
                    for row, ms in rec[key].items():
                        by_row.setdefault(row, {}).setdefault(
                            "old" if root == old else "new", []).append(ms)
    summary = {}
    for key, by_row in times.items():
        for row, by in by_row.items():
            med = {tree: statistics.median(v) for tree, v in by.items()}
            summary.setdefault("median_" + key, {})[row] = {
                **med, "new_over_old": med["new"] / med["old"]}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
