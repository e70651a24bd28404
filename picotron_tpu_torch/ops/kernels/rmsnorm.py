"""Kernel A: RMSNorm forward (csrc/rmsnorm.cu) and its plain version.

``rms_norm`` is the wrapper the model calls: CPU tensors take the plain
version (``ops/rmsnorm.py``); a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from picotron_tpu_torch.ops.kernels import build
from picotron_tpu_torch.ops.rmsnorm import rms_norm as rms_norm_plain

KERNEL = build.Kernel(
    name="rmsnorm", route="cuda",
    source="picotron_tpu_torch/ops/kernels/csrc/rmsnorm.cu",
    replaces="picotron_tpu/ops/pallas/rmsnorm.py:34")

__all__ = ["KERNEL", "rms_norm", "rms_norm_plain"]


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """x: [..., H]; weight: [H]. Same numerics as ``rms_norm_plain``."""
    if x.device.type == "cpu":
        return rms_norm_plain(x, weight, eps)
    h = x.shape[-1]
    if not x.is_cuda or weight.device != x.device:
        raise ValueError(f"rms_norm kernel needs x and weight on one CUDA "
                         f"device; got {x.device} and {weight.device}")
    if x.dtype != torch.bfloat16 or weight.dtype != torch.bfloat16:
        raise ValueError(f"rms_norm kernel takes bf16 x and weight; got "
                         f"{x.dtype} and {weight.dtype}")
    if tuple(weight.shape) != (h,):
        raise ValueError(f"weight shape {tuple(weight.shape)} != ({h},)")
    if h % 8 or not x.is_contiguous() or not weight.is_contiguous():
        raise ValueError("rms_norm kernel needs contiguous tensors with "
                         f"H % 8 == 0; got H={h}")
    if x.data_ptr() % 16 or weight.data_ptr() % 16:
        raise ValueError("rms_norm kernel needs 16-byte aligned tensors")
    out = torch.empty_like(x)
    rows = x.numel() // h
    if rows == 0:
        return out
    rc = build.library().picotron_rmsnorm_fwd(
        x.data_ptr(), weight.data_ptr(), out.data_ptr(), rows, h, float(eps),
        build.stream_of(x))
    build.check(rc, KERNEL)
    KERNEL.launches += 1
    return out
