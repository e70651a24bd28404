"""Kernels A and D: RMSNorm forward and backward (csrc/rmsnorm.cu), and
their plain versions.

``rms_norm`` is the wrapper the model calls. Where autograd needs a
gradient it goes through ``RMSNormFunction``, which saves ``(x, w)`` and
whose backward is kernel D. CPU tensors take the plain versions
(``ops/rmsnorm.py`` forward, ``rms_norm_bwd_plain`` backward); a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

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

# blocks of D's first kernel at most: two waves over the H100's 132 SMs,
# so the partial-dw scratch stays small ([264, H] fp32)
BWD_MAX_BLOCKS = 264

__all__ = ["KERNEL", "KERNEL_BWD", "rms_norm", "rms_norm_plain",
           "rms_norm_fwd", "rms_norm_bwd", "rms_norm_bwd_plain",
           "RMSNormFunction"]


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
    out = torch.empty_like(x)
    h = x.shape[-1]
    rows = x.numel() // h
    if rows == 0:
        return out
    rc = build.library().picotron_rmsnorm_fwd(
        x.data_ptr(), weight.data_ptr(), out.data_ptr(), rows, h, float(eps),
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


def rms_norm_bwd(x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor,
                 eps: float = 1e-5) -> tuple:
    """Kernel D: (dx, dw) of ``rms_norm(x, weight, eps)`` for the output
    gradient ``dy``. Same numerics as ``rms_norm_bwd_plain``."""
    if x.device.type == "cpu":
        return rms_norm_bwd_plain(x, weight, dy, eps)
    _check(KERNEL_BWD, x, weight, dy)
    dx = torch.empty_like(x)
    dw = torch.empty_like(weight)
    h = x.shape[-1]
    rows = x.numel() // h
    if rows == 0:
        return dx, dw.zero_()
    blocks = min(rows, BWD_MAX_BLOCKS)
    partial = torch.empty((blocks, h), dtype=torch.float32, device=x.device)
    rc = build.library().picotron_rmsnorm_bwd(
        x.data_ptr(), weight.data_ptr(), dy.data_ptr(), dx.data_ptr(),
        dw.data_ptr(), partial.data_ptr(), rows, h, blocks, float(eps),
        build.stream_of(x))
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
