"""Kernel G: the int8-weight matmul (csrc/quant_matmul.cu), and its plain
version.

``quant_matmul_2d(x, q, s)`` computes ``(x @ q) * s`` for x [M, K], int8 q
[K, N] and fp32 per-output-channel scales s [N]: fp32 accumulation, the
scale applied once to the fp32 result, then a cast to ``x.dtype``. It is
the function of ``picotron_tpu/ops/pallas/quant_matmul.py::
_quant_matmul_kernel`` (through ``quant_matmul_pallas``). CPU tensors take
``quant_matmul_plain``, the XLA fallback's order (:184-194); a CUDA tensor
launches the kernel or raises. The model reaches it through
``ops/quant_matmul.quant_matmul``, which flattens leading dimensions.

A call is one launch of one of the kernel's two variants, picked by
``plan`` from (M, K, N) alone: a split-K GEMV on the mma.sync tensor
cores for M <= 16 (decode, the last-token head), whose splits the last
block of each column tile adds in split order (an fp32 workspace and
int32 counters kept per device in ``SCRATCH``, the counters at zero); a
``wgmma`` GEMM on 128 x 128 tiles fed by TMA for M > 16 (prefill chunks).
"""

from __future__ import annotations

import functools

import torch

from picotron_tpu_torch.ops.kernels import build

KERNEL = build.Kernel(
    name="quant_matmul", route="cuda",
    source="picotron_tpu_torch/ops/kernels/csrc/quant_matmul.cu",
    replaces="picotron_tpu/ops/pallas/quant_matmul.py:130")


# H100 SXM: streaming multiprocessors, and the resident split-K blocks
# each should hold (two, by their registers)
SMS = 132
SPLITK_BLOCKS_PER_SM = 2
SPLITK_MAX_M = 16  # two n8 tiles of tokens
SPLITK_COLUMNS = 128  # a split-K block's columns
MAX_SPLITS = 8
WGMMA_TILE = 128  # a wgmma block's rows and columns
VARIANTS = ("splitk", "wgmma")


@functools.lru_cache(maxsize=None)
def plan(M: int, K: int, N: int) -> dict:
    """The launch of a call, from its shapes alone. M <= 16: ``splitk``
    over ceil(N / 128) column tiles, each split over ``splits`` blocks (1
    to 8) so that the grid holds about two blocks an SM, and no split is
    left without a 16-row slab for each of its 8 warps. M > 16: ``wgmma``
    on 128 x 128 tiles, unsplit."""
    if M <= SPLITK_MAX_M:
        tiles = -(-N // SPLITK_COLUMNS)
        splits = max(1, min(MAX_SPLITS, SMS * SPLITK_BLOCKS_PER_SM // tiles,
                            -(-K // 16) // 8))
        return {"variant": "splitk", "splits": splits, "tiles": tiles}
    return {"variant": "wgmma", "splits": 1,
            "tiles": -(-M // WGMMA_TILE) * -(-N // WGMMA_TILE)}


# device -> (the split-K merge's fp32 workspace, its int32 counters, one
# per column tile). A launch leaves every counter it used at zero, so the
# counters are zeroed once, when they are made or grown; both grow to the
# largest call and are never allocated per call. Calls that share them run
# one at a time (one stream).
SCRATCH: dict = {}


def _scratch(x: torch.Tensor, floats: int, tiles: int) -> tuple:
    ws, counters = SCRATCH.get(x.device, (None, None))
    if ws is None or ws.numel() < floats:
        ws = torch.empty(floats, dtype=torch.float32, device=x.device)
    if counters is None or counters.numel() < tiles:
        counters = torch.zeros(max(tiles, 1024), dtype=torch.int32,
                               device=x.device)
    SCRATCH[x.device] = (ws, counters)
    return ws, counters


def quant_matmul_plain(x: torch.Tensor, q: torch.Tensor,
                       s: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ q [K, N] int8 in fp32, times s [N], cast to x.dtype. The
    int8 operand is cast, never scaled: no dequantized weight exists."""
    return ((x.float() @ q.float()) * s.float()).to(x.dtype)


def quant_matmul_2d(x: torch.Tensor, q: torch.Tensor,
                    s: torch.Tensor) -> torch.Tensor:
    """See the module docstring."""
    if x.dim() != 2 or q.dim() != 2 or x.shape[1] != q.shape[0] \
            or tuple(s.shape) != (q.shape[1],):
        raise ValueError(f"quant_matmul shapes: x {tuple(x.shape)}, "
                         f"q {tuple(q.shape)}, s {tuple(s.shape)}")
    if q.dtype != torch.int8:
        raise ValueError(f"quant_matmul weights must be int8, got {q.dtype}")
    if x.device.type == "cpu":
        return quant_matmul_plain(x, q, s)
    if not x.is_cuda or any(t.device != x.device for t in (q, s)):
        raise ValueError("quant_matmul kernel needs every operand on one "
                         "CUDA device")
    if x.dtype != torch.bfloat16 or s.dtype != torch.float32:
        raise ValueError(f"quant_matmul kernel takes bf16 x and fp32 s; got "
                         f"{x.dtype} and {s.dtype}")
    if not all(t.is_contiguous() for t in (x, q, s)):
        raise ValueError("quant_matmul kernel needs contiguous operands")
    M, K = x.shape
    N = q.shape[1]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    p = plan(M, K, N)
    ws = counters = None
    if p["splits"] > 1:  # the splits' fp32 partials, merged in the launch
        ws, counters = _scratch(
            x, p["tiles"] * p["splits"] * 1024 * -(-M // 8), p["tiles"])
    rc = build.library().picotron_quant_matmul(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
        0 if ws is None else ws.data_ptr(),
        0 if counters is None else counters.data_ptr(), M, N, K,
        VARIANTS.index(p["variant"]), p["splits"], build.stream_of(x))
    build.check(rc, KERNEL)
    KERNEL.launches += 1
    return out
