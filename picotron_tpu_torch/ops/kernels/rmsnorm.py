"""Kernels A and D: RMSNorm forward and backward (csrc/rmsnorm.cu), and
their plain versions.

``rms_norm`` is the wrapper the model calls. Where autograd needs a
gradient it goes through ``RMSNormFunction``, which saves ``(x, w)`` and
whose backward is kernel D. CPU tensors take the plain versions
(``ops/rmsnorm.py`` forward, ``rms_norm_bwd_plain`` backward); a CUDA
tensor launches the kernel or raises.

Each call is one launch that follows a plan made here from the shapes (and,
for D, the card's SM count): ``plan_fwd`` puts a group of warps on a row,
a few groups to a block; ``plan_bwd`` gives D's persistent grid (one block
an SM, launched cooperatively) and its warps a row. Under either plan a
group walks the rows ``rows_of`` gives; D's plan also fixes each block's
slice of dw's columns
(``bwd_column_slices``) and the segments of partial rows it sums them over
(``bwd_segments``). ``rms_norm_bwd_fixed_order_plain`` is the plain model
of the order in which D sums dw under a plan.
"""

from __future__ import annotations

import functools
import math

import torch

from picotron_tpu_torch.ops.kernels import build
from picotron_tpu_torch.ops.rmsnorm import rms_norm as rms_norm_plain

KERNEL = build.Kernel(
    name="rmsnorm", route="cuda",
    source="picotron_tpu_torch/ops/kernels/csrc/rmsnorm.cu",
    replaces="picotron_tpu/ops/pallas/rmsnorm.py:34")
KERNEL_BWD = build.Kernel(
    name="rmsnorm_bwd", route="cuda",
    source="picotron_tpu_torch/ops/kernels/csrc/rmsnorm.cu",
    replaces="picotron_tpu/ops/pallas/rmsnorm.py:41")

VEC = 8  # bf16 values of a 16-byte access
FWD_WARPS = 4  # A: warps of a block, at least
FWD_MAX_WARPS = 8  # A: warps of a row, at most
FWD_MAX_VEC = 8  # A: a lane's vectors in registers
FWD_FEW_ROWS = 512  # A: rows few enough that a call's time is latency
FWD_MAX_BLOCKS = 1024  # A: blocks of a grid that walks many rows
BWD_WARPS = 8  # D: warps of its one block an SM
BWD_MAX_VEC = 8  # D: a lane's vectors (columns) of a row

__all__ = ["KERNEL", "KERNEL_BWD", "rms_norm", "rms_norm_plain",
           "rms_norm_fwd", "rms_norm_bwd", "rms_norm_bwd_plain",
           "rms_norm_bwd_fixed_order_plain", "plan_fwd", "plan_bwd",
           "rows_of", "bwd_column_slices", "bwd_segments", "RMSNormFunction"]


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


@functools.lru_cache(maxsize=None)
def plan_fwd(rows: int, H: int) -> dict:
    """A's launch, from the shapes alone. A group of ``warps_per_row``
    warps (1, 2, 4 or 8) takes a row, each lane ``vec_per_lane`` of its
    16-byte vectors of x and of the weight (1 to 8) in registers: four
    warps a row for at most ``FWD_FEW_ROWS`` rows (decode and a prefill
    chunk, where the time is latency and the lanes' serial arithmetic),
    two for more (training: the fewer registers a warp holds, the more
    warps an SM keeps in flight); at least enough that a lane holds 8
    vectors at most, and no warp without a vector. Blocks of ``warps``
    warps, ``warps // warps_per_row`` groups each, at most
    ``FWD_MAX_BLOCKS`` blocks: group ``k`` (group ``k % gpb`` of block ``k
    // gpb``) walks ``rows_of``. Past H 16384 the loop variant
    (``vec_per_lane`` 0): one warp a row, a block of ``warps`` rows, as
    many blocks as that takes."""
    nvec = H // VEC
    least = _pow2_at_least(-(-nvec // (32 * FWD_MAX_VEC)))
    if least > FWD_MAX_WARPS:
        blocks = -(-rows // FWD_WARPS)
        return {"variant": "loop", "warps_per_row": 1, "vec_per_lane": 0,
                "warps": FWD_WARPS, "blocks": blocks,
                "groups": blocks * FWD_WARPS}
    most = min(FWD_MAX_WARPS, _pow2_at_least(-(-nvec // 32)))
    per_row = max(least, min(most, 4 if rows <= FWD_FEW_ROWS else 2))
    warps = max(FWD_WARPS, per_row)
    gpb = warps // per_row
    blocks = max(1, min(FWD_MAX_BLOCKS, -(-rows // gpb)))
    return {"variant": "rows", "warps_per_row": per_row,
            "vec_per_lane": _pow2_at_least(-(-nvec // (32 * per_row))),
            "warps": warps, "blocks": blocks, "groups": blocks * gpb}


@functools.lru_cache(maxsize=None)
def plan_bwd(rows: int, H: int, sms: int) -> dict:
    """D's launch, from the shapes and the card's SM count alone.

    ``rows`` variant: a group of ``warps_per_row`` warps (1, 2, 4 or 8)
    takes a row, each lane ``vec_per_lane`` of its 16-byte vectors (at
    most 8); ``BWD_WARPS // warps_per_row`` groups a block; one block an
    SM, fewer where the rows would leave a block with none. Past H 16384
    the ``loop`` variant puts the whole block on a row (one group a block,
    ``vec_per_lane`` 0). Group ``k`` is group ``k % gpb`` of block ``k //
    gpb`` and walks ``rows_of``. Block ``b`` sums dw's columns
    ``bwd_column_slices(...)[b]`` (``slice_cols`` each, a multiple of 4)
    over the partial rows in the segments of ``bwd_segments``
    (``segment_blocks`` consecutive blocks each, about the square root of
    the grid)."""
    nvec = H // VEC
    per_row = _pow2_at_least(-(-nvec // (32 * BWD_MAX_VEC)))
    if per_row <= BWD_WARPS:
        variant = "rows"
        vpl = _pow2_at_least(-(-nvec // (32 * per_row)))
    else:
        variant, per_row, vpl = "loop", BWD_WARPS, 0
    gpb = BWD_WARPS // per_row
    blocks = max(1, min(sms, -(-rows // gpb)))
    return {"variant": variant, "blocks": blocks, "warps": BWD_WARPS,
            "warps_per_row": per_row, "vec_per_lane": vpl,
            "groups_per_block": gpb, "groups": blocks * gpb,
            "slice_cols": 4 * -(-H // (4 * blocks)),
            "segment_blocks": -(-blocks // (math.isqrt(blocks - 1) + 1))}


def rows_of(plan: dict, rows: int, group: int) -> range:
    """The rows group ``group`` of an A or D plan walks, in its order."""
    return range(group, rows, plan["groups"])


def bwd_column_slices(plan: dict, H: int) -> list:
    """Each block's [start, end) of dw's columns (empty past H)."""
    cw = plan["slice_cols"]
    return [(min(H, b * cw), min(H, (b + 1) * cw))
            for b in range(plan["blocks"])]


def bwd_segments(plan: dict) -> list:
    """The [first, end) blocks whose partial rows each segment sums."""
    nb, sb = plan["blocks"], plan["segment_blocks"]
    return [(s, min(nb, s + sb)) for s in range(0, nb, sb)]


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (read once)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


# device -> D's fp32 partial rows ([blocks, H] at most one an SM), grown to
# the largest call and never allocated per call. Calls that share it run
# one at a time (one stream).
SCRATCH: dict = {}


def _partials(x: torch.Tensor, floats: int) -> torch.Tensor:
    buf = SCRATCH.get(x.device)
    if buf is None or buf.numel() < floats:
        buf = torch.empty(floats, dtype=torch.float32, device=x.device)
        SCRATCH[x.device] = buf
    return buf


def _check(kernel: build.Kernel, x: torch.Tensor, weight: torch.Tensor,
           *more: torch.Tensor) -> None:
    h = x.shape[-1]
    if not x.is_cuda or any(t.device != x.device for t in (weight, *more)):
        raise ValueError(f"{kernel.name} kernel needs every operand on one "
                         f"CUDA device; got {x.device} and {weight.device}")
    if any(t.dtype != torch.bfloat16 for t in (x, weight, *more)):
        raise ValueError(f"{kernel.name} kernel takes bf16 operands; got "
                         f"{x.dtype} and {weight.dtype}")
    if tuple(weight.shape) != (h,):
        raise ValueError(f"weight shape {tuple(weight.shape)} != ({h},)")
    if any(t.shape != x.shape for t in more):
        raise ValueError(f"{kernel.name}: shape mismatch with x "
                         f"{tuple(x.shape)}")
    if h % 8 or not all(t.is_contiguous() for t in (x, weight, *more)):
        raise ValueError(f"{kernel.name} kernel needs contiguous tensors "
                         f"with H % 8 == 0; got H={h}")
    if any(t.data_ptr() % 16 for t in (x, weight, *more)):
        raise ValueError(f"{kernel.name} kernel needs 16-byte aligned "
                         "tensors")


def rms_norm_fwd(x: torch.Tensor, weight: torch.Tensor,
                 eps: float = 1e-5) -> torch.Tensor:
    """Kernel A (no autograd): x [..., H], weight [H]."""
    if x.device.type == "cpu":
        return rms_norm_plain(x, weight, eps)
    _check(KERNEL, x, weight)
    lib = build.library()
    out = torch.empty_like(x)
    h = x.shape[-1]
    rows = x.numel() // h
    if rows == 0:
        return out
    p = plan_fwd(rows, h)
    rc = lib.picotron_rmsnorm_fwd(
        x.data_ptr(), weight.data_ptr(), out.data_ptr(), rows, h,
        p["blocks"], p["warps"], p["warps_per_row"], p["vec_per_lane"],
        float(eps),
        build.stream_of(x))
    build.check(rc, KERNEL)
    KERNEL.launches += 1
    return out


def rms_norm_bwd_plain(x: torch.Tensor, weight: torch.Tensor,
                       dy: torch.Tensor, eps: float = 1e-5) -> tuple:
    """The Pallas backward's formula (``_bwd_kernel`` :46-55) in torch:
    fp32 throughout, dx in x's dtype, dw summed over every row in fp32
    and cast to the weight's dtype."""
    h = x.shape[-1]
    x32 = x.reshape(-1, h).float()
    dy32 = dy.reshape(-1, h).float()
    r = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    xhat = x32 * r
    dxhat = dy32 * weight.float()[None, :]
    dx = r * (dxhat - xhat * (dxhat * xhat).mean(dim=-1, keepdim=True))
    dw = (dy32 * xhat).sum(dim=0)
    return dx.to(x.dtype).reshape(x.shape), dw.to(weight.dtype)


def rms_norm_bwd_fixed_order_plain(x: torch.Tensor, weight: torch.Tensor,
                                   dy: torch.Tensor, eps: float,
                                   plan: dict) -> tuple:
    """``rms_norm_bwd_plain`` with dw summed in kernel D's order under
    ``plan``: each group's rows in walk order from 0, a block's groups in
    group order, then for each block's column slice the partial rows in
    block order within a segment and the segments in order. fp32 adds,
    one per step, as the kernel makes them."""
    dx, _ = rms_norm_bwd_plain(x, weight, dy, eps)
    h = x.shape[-1]
    x32 = x.reshape(-1, h).float()
    rows = x32.shape[0]
    xhat = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    contrib = dy.reshape(-1, h).float() * xhat
    gpb = plan["groups_per_block"]
    partial = []
    for b in range(plan["blocks"]):
        row = None
        for k in range(b * gpb, (b + 1) * gpb):
            acc = torch.zeros(h, dtype=torch.float32)
            for r in rows_of(plan, rows, k):
                acc = acc + contrib[r]
            row = acc if row is None else row + acc
        partial.append(row)
    dw = torch.zeros(h, dtype=torch.float32)
    for c0, c1 in bwd_column_slices(plan, h):
        total = None
        for b0, b1 in bwd_segments(plan):
            seg = partial[b0][c0:c1]
            for b in range(b0 + 1, b1):
                seg = seg + partial[b][c0:c1]
            total = seg if total is None else total + seg
        dw[c0:c1] = total
    return dx, dw.to(weight.dtype)


def rms_norm_bwd(x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor,
                 eps: float = 1e-5) -> tuple:
    """Kernel D: (dx, dw) of ``rms_norm(x, weight, eps)`` for the output
    gradient ``dy``. Same numerics as ``rms_norm_bwd_plain``."""
    if x.device.type == "cpu":
        return rms_norm_bwd_plain(x, weight, dy, eps)
    _check(KERNEL_BWD, x, weight, dy)
    lib = build.library()
    dx = torch.empty_like(x)
    dw = torch.empty_like(weight)
    h = x.shape[-1]
    rows = x.numel() // h
    if rows == 0:
        return dx, dw.zero_()
    p = plan_bwd(rows, h, sm_count(x.device.index))
    partial = _partials(x, p["blocks"] * h)
    rc = lib.picotron_rmsnorm_bwd(
        x.data_ptr(), weight.data_ptr(), dy.data_ptr(), dx.data_ptr(),
        dw.data_ptr(), partial.data_ptr(), rows, h, p["blocks"], p["warps"],
        p["warps_per_row"], p["vec_per_lane"], p["slice_cols"],
        p["segment_blocks"], float(eps), build.stream_of(x))
    build.check(rc, KERNEL_BWD)
    KERNEL_BWD.launches += 1
    return dx, dw


class RMSNormFunction(torch.autograd.Function):
    """RMSNorm with kernel A forward and kernel D backward. Saves
    ``(x, w)``; the backward recomputes the row statistics, as the Pallas
    VJP does. Nothing is kept on ``ctx`` but the saved tensors and eps, so
    a checkpointed layer can rerun the forward freely."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return rms_norm_fwd(x, weight, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dx, dw = rms_norm_bwd(x, weight, dy.contiguous(), ctx.eps)
        return dx, dw, None


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """x: [..., H]; weight: [H]. Same numerics as ``rms_norm_plain``.
    Differentiable through ``RMSNormFunction`` when autograd records;
    otherwise (serving) kernel A alone."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        return RMSNormFunction.apply(x, weight, eps)
    return rms_norm_fwd(x, weight, eps)
