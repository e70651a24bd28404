"""RMSNorm, the plain PyTorch formulation.

Numerics follow ``picotron_tpu/ops/rmsnorm.py`` exactly: variance in
float32, ``x * rsqrt(var + eps)`` cast back to the input dtype, then
multiplied by the weight in the input dtype. The hand-written CUDA kernel
is ``ops/kernels/rmsnorm.py``; this function is its plain version and the
CPU path.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    normed = (x32 * torch.rsqrt(var + eps)).to(x.dtype)
    return normed * weight
