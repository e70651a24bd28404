"""Device time of kernel C (flash decode) in its five variants, for two
trees in one run on one CUDA card.

    python3 decode_ab.py --root OLD --root NEW

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
  1024 at 128, the paged variants over 812 (300 cached) at 64.

A row's time is the device time of one wrapper call, every kernel it
launches summed from a torch.profiler trace of 20 calls (the median of
three traces that lost no event), so a wrapper's host cost does not
hide its kernels. Prints one JSON line per run, then one summary line with
each row's median per tree and NEW / OLD.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ITERS = 20  # wrapper calls a trace
TRACES = 3  # complete traces a row


def _device_ms(torch, fn) -> float:
    """The median over ``TRACES`` profiler traces of ``ITERS`` calls of the
    device time of one call; a trace that lost an event (its count is no
    multiple of the calls) is taken again."""
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
            if len(times) == TRACES:
                return statistics.median(times)
    raise RuntimeError("no complete profiler trace")


def _child(root: str) -> None:
    """One process's rows, on the tree at ``root``."""
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

    rows = {}
    decode8 = [0, 1, 17, 128, 129, 700, 1500, 2048]
    for D in (64, 128):
        for B, S, lens in ((8, 1, decode8), (1, 512, [1536])):
            q, k, v = randn(B, S, 32, D), randn(B, 2048, 32, D), \
                randn(B, 2048, 32, D)
            L = lengths(lens)
            rows[f"C D{D} S{S}"] = _device_ms(
                torch, lambda: kc.flash_decode_attention(q, k, v, L,
                                                         D ** -0.5))
    for B, S, lens in ((8, 1, [0, 1, 130, 257, 700, 964, 2000, 4096]),
                       (1, 512, [1024])):
        q = randn(B, S, 32, 128)
        kq, ks = quantize_kv(randn(B, 4096, 32, 128))
        vq, vs = quantize_kv(randn(B, 4096, 32, 128))
        L = lengths(lens)
        rows[f"C-int8 D128 S{S}"] = _device_ms(
            torch, lambda: kc.flash_decode_attention(q, kq, vq, L,
                                                     128 ** -0.5, ks, vs))
    page_len, max_pages = 16, 128
    for D, B, S, lens in ((64, 8, 1, decode8), (128, 8, 1, decode8),
                          (64, 1, 512, [812])):
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
    print(json.dumps({"root": root, "device_ms": rows}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", action="append", required=True,
                    help="a checkout of the repo; give exactly two")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        _child(os.path.abspath(args.root[0]))
        return 0
    if len(args.root) != 2:
        ap.error("give exactly two --root")
    old, new = (os.path.abspath(r) for r in args.root)
    times = {}
    for root in (old, new, new, old):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", "--root",
             root], cwd=root, check=True, stdout=subprocess.PIPE, text=True)
        for line in out.stdout.splitlines():
            if line.startswith("{"):
                print(line, flush=True)
                for row, ms in json.loads(line)["device_ms"].items():
                    times.setdefault(row, {}).setdefault(
                        "old" if root == old else "new", []).append(ms)
    summary = {}
    for row, by in times.items():
        med = {tree: statistics.median(v) for tree, v in by.items()}
        summary[row] = {**med, "new_over_old": med["new"] / med["old"]}
    print(json.dumps({"median_device_ms": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
