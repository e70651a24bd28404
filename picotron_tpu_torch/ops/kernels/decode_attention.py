"""Kernel C: flash decode, KV-cache attention (csrc/decode_attention.cu),
and its plain version.

``flash_decode_attention`` is the wrapper ``inference/kv_cache.attend``
calls for ``attend_impl="flash"``: CPU tensors take
``flash_decode_attention_plain``; a CUDA tensor launches the kernel or
raises. The function is
``picotron_tpu/ops/pallas/decode_attention.py::flash_decode_attention``'s
contiguous full-precision form: S fresh queries per slot, query row ``s``
at position ``lengths[b] - S + s`` seeing key ``t`` iff ``t <=`` that
position (and ``t < T``), fp32 softmax and P @ V, and rows with no
visible key returning zeros.
"""

from __future__ import annotations

import torch

from picotron_tpu_torch.ops.kernels import build

KERNEL = build.Kernel(
    name="flash_decode", route="cuda",
    source="picotron_tpu_torch/ops/kernels/csrc/decode_attention.cu",
    replaces="picotron_tpu/ops/pallas/decode_attention.py:162")

HEAD_DIMS = (64, 128)  # head_dim values the kernel is compiled for


def flash_decode_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, lengths: torch.Tensor,
                                 scale: float) -> torch.Tensor:
    """q: [B, S, H, D]; k/v: [B, T, Hkv, D]; lengths: [B] ->
    [B, S, H, D] in q.dtype."""
    B, S, nh, D = q.shape
    T, nkv = k.shape[1], k.shape[2]
    g = nh // nkv
    qg = q.reshape(B, S, nkv, g, D).float()
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * scale
    pos_q = (lengths.long()[:, None] - S
             + torch.arange(S, device=q.device)[None, :])  # [B, S]
    mask = (torch.arange(T, device=q.device)[None, None, :]
            <= pos_q[:, :, None])[:, None, None]  # [B, 1, 1, S, T]
    scores = torch.where(mask, scores, float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.where(mask, torch.exp(scores - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    l = l.permute(0, 3, 1, 2, 4)  # [B, S, kv, g, 1], like out
    out = torch.where(l > 0, out / torch.where(l > 0, l, 1.0), 0.0)
    return out.reshape(B, S, nh, D).to(q.dtype)


def flash_decode_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, lengths: torch.Tensor,
                           scale: float) -> torch.Tensor:
    """See the module docstring."""
    if q.device.type == "cpu":
        return flash_decode_attention_plain(q, k, v, lengths, scale)
    B, S, H, D = q.shape
    if k.shape != v.shape or k.dim() != 4 or k.shape[0] != B \
            or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"flash_decode shapes: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if tuple(lengths.shape) != (B,) or lengths.dtype != torch.int32:
        raise ValueError(f"lengths must be [{B}] int32; got "
                         f"{tuple(lengths.shape)} {lengths.dtype}")
    if not q.is_cuda or any(t.device != q.device for t in (k, v, lengths)):
        raise ValueError("flash_decode kernel needs every operand on one "
                         "CUDA device")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise ValueError(f"flash_decode kernel takes bf16 q/k/v; got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_decode kernel takes head_dim in "
                         f"{HEAD_DIMS}; got {D}")
    if not all(t.is_contiguous() for t in (q, k, v, lengths)) \
            or any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_decode kernel needs contiguous operands, "
                         "q/k/v 16-byte aligned")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    rc = build.library().picotron_flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), B, S, H, k.shape[2], k.shape[1], D, float(scale),
        build.stream_of(q))
    build.check(rc, KERNEL)
    KERNEL.launches += 1
    return out
