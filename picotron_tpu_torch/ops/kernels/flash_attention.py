"""Kernel B: causal flash-attention forward (csrc/flash_attention.cu) and
its plain version.

``flash_attention`` is the wrapper the model's full-sequence path calls:
CPU tensors take ``flash_attention_plain``; a CUDA tensor launches the
kernel or raises. Both take compact GQA K/V (``H % Hkv == 0``, query head
``h`` reads kv head ``h // (H // Hkv)``) and compute what
``picotron_tpu/ops/pallas/flash_attention.py::flash_attention`` computes
with ``causal=True``: fp32 scores and softmax, the probabilities rounded to
``v.dtype`` before the P @ V product, output in ``q.dtype``.
"""

from __future__ import annotations

import math

import torch

from picotron_tpu_torch.ops.attention import NEG_INF
from picotron_tpu_torch.ops.kernels import build

KERNEL = build.Kernel(
    name="flash_attention", route="cuda",
    source="picotron_tpu_torch/ops/kernels/csrc/flash_attention.cu",
    replaces="picotron_tpu/ops/pallas/flash_attention.py:97")

HEAD_DIMS = (64, 128)  # head_dim values the kernel is compiled for


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float) -> torch.Tensor:
    """q: [B, S, H, D], k/v: [B, S, Hkv, D] -> [B, S, H, D] in q.dtype."""
    g = q.shape[2] // k.shape[2]
    kr = k.repeat_interleave(g, dim=2).float()
    vr = v.repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr) * scale
    n = q.shape[1]
    causal = (torch.arange(n, device=q.device)[:, None]
              >= torch.arange(n, device=q.device)[None, :])
    s = torch.where(causal, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)  # [B, H, S, 1], from the fp32 p
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), vr.float())
    return (out / l.permute(0, 2, 1, 3)).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float | None = None) -> torch.Tensor:
    """Causal attention; see the module docstring."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    B, S, H, D = q.shape
    if k.shape != v.shape or k.dim() != 4 or k.shape[:2] != (B, S) \
            or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"flash_attention shapes: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not q.is_cuda or any(t.device != q.device for t in (k, v)):
        raise ValueError(f"flash_attention kernel needs q/k/v on one CUDA "
                         f"device; got {q.device}/{k.device}/{v.device}")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise ValueError(f"flash_attention kernel takes bf16; got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in "
                         f"{HEAD_DIMS}; got {D}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (q, k, v)):
        raise ValueError("flash_attention kernel needs contiguous, 16-byte "
                         "aligned q/k/v")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    rc = build.library().picotron_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, S, H, k.shape[2], D, float(scale), build.stream_of(q))
    build.check(rc, KERNEL)
    KERNEL.launches += 1
    return out
