"""Kernels B, E and F: the causal flash-attention forward
(csrc/flash_attention.cu) and its backward (csrc/flash_attention_bwd.cu),
with their plain versions.

``flash_attention`` is the wrapper the model's full-sequence path calls.
Where autograd needs a gradient it goes through ``FlashAttentionFunction``:
the forward is kernel B with its LSE output, it saves ``(q, k, v, o,
lse)``, and the backward is kernel E (dQ, and delta = rowsum(dO * O)) then
kernel F (dK, dV). Without autograd (serving) it is kernel B alone, with no
LSE. CPU tensors take the plain versions; a CUDA tensor launches the
kernel or raises.

All take compact GQA K/V (``H % Hkv == 0``, query head ``h`` reads kv head
``h // (H // Hkv)``) and compute what
``picotron_tpu/ops/pallas/flash_attention.py::flash_attention`` computes
with ``causal=True`` on K/V repeated to every head: fp32 scores and
softmax, the probabilities rounded to ``v.dtype`` before the P @ V
product, output in ``q.dtype``; in the backward the rounding points of the
Pallas bodies (trouble spots named in ``flash_attention_bwd_plain``). The
LSE is fp32 [B, H, S]; ``picotron_tpu``'s ``flash_attention_with_lse``
returns it as [B, S, H].
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
KERNEL_DQ = build.Kernel(
    name="flash_attention_bwd_dq", route="cuda",
    source="picotron_tpu_torch/ops/kernels/csrc/flash_attention_bwd.cu",
    replaces="picotron_tpu/ops/pallas/flash_attention.py:223")
KERNEL_DKV = build.Kernel(
    name="flash_attention_bwd_dkv", route="cuda",
    source="picotron_tpu_torch/ops/kernels/csrc/flash_attention_bwd.cu",
    replaces="picotron_tpu/ops/pallas/flash_attention.py:255")

HEAD_DIMS = (64, 128)  # head_dim values the kernels are compiled for


def _scores(q, k, scale):
    """fp32 causal scores [B, H, S, S] of q over compact k (repeated to
    every query head here), masked with the large negative fill."""
    g = q.shape[2] // k.shape[2]
    kr = k.repeat_interleave(g, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr) * scale
    n = q.shape[1]
    causal = (torch.arange(n, device=q.device)[:, None]
              >= torch.arange(n, device=q.device)[None, :])
    return torch.where(causal, s, NEG_INF)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float, return_lse: bool = False):
    """q: [B, S, H, D], k/v: [B, S, Hkv, D] -> [B, S, H, D] in q.dtype,
    and with ``return_lse`` also the fp32 LSE [B, H, S]."""
    g = q.shape[2] // k.shape[2]
    vr = v.repeat_interleave(g, dim=2)
    s = _scores(q, k, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)  # [B, H, S, 1], from the fp32 p
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), vr.float())
    out = (out / l.permute(0, 2, 1, 3)).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(l))[..., 0]
    return out


def _bwd_terms(q, k, v, lse, do, scale):
    """P (from the LSE) and dP = dO . V, fp32 [B, H, S, S], on K/V
    repeated to every query head."""
    g = q.shape[2] // k.shape[2]
    p = torch.exp(_scores(q, k, scale) - lse[..., None])
    vr = v.repeat_interleave(g, dim=2).float()
    return p, torch.einsum("bqhd,bkhd->bhqk", do.float(), vr)


def flash_attention_bwd_dq_plain(q, k, v, o, lse, do, scale: float) -> tuple:
    """Kernel E's function: (dq, delta). delta = rowsum(dO * O) [B, H, S]
    fp32; dS = P * (dP - delta) * scale is rounded to ``k.dtype`` before
    the dQ product (``_bwd_dq_kernel`` :223)."""
    g = q.shape[2] // k.shape[2]
    p, dp = _bwd_terms(q, k, v, lse, do, scale)
    delta = (do.float() * o.float()).sum(dim=-1).permute(0, 2, 1)
    ds = p * (dp - delta[..., None]) * scale
    kr = k.repeat_interleave(g, dim=2).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), kr)
    return dq.to(q.dtype), delta.contiguous()


def flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta,
                                  scale: float) -> tuple:
    """Kernel F's function: (dk, dv), the compact [B, S, Hkv, D] sums over
    each kv head's g query heads. dS is rounded to ``q.dtype`` before the
    dK product, P to ``do.dtype`` before the dV product
    (``_bwd_dkv_kernel`` :255)."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    p, dp = _bwd_terms(q, k, v, lse, do, scale)
    ds = p * (dp - delta[..., None]) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())

    def compact(t, dtype):
        return t.reshape(B, S, Hkv, H // Hkv, D).sum(dim=3).to(dtype)

    return compact(dk, k.dtype), compact(dv, v.dtype)


def flash_attention_bwd_plain(q, k, v, o, lse, do, scale: float) -> tuple:
    """(dq, dk, dv) of causal attention, the Pallas backward's function
    (``_bwd_dq_kernel`` :223, ``_bwd_dkv_kernel`` :255) in torch: P comes
    back from the LSE [B, H, S], products accumulate in fp32, and dS and P
    are rounded where the Pallas bodies round them."""
    dq, delta = flash_attention_bwd_dq_plain(q, k, v, o, lse, do, scale)
    dk, dv = flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, scale)
    return dq, dk, dv


def _check(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           *rows: torch.Tensor) -> None:
    """Shapes, device, dtype and layout the kernels take; ``rows`` are
    further [B, S, H, D] bf16 operands (o, dO)."""
    B, S, H, D = q.shape
    if k.shape != v.shape or k.dim() != 4 or k.shape[:2] != (B, S) \
            or k.shape[3] != D or H % k.shape[2] \
            or any(t.shape != q.shape for t in rows):
        raise ValueError(f"{name} shapes: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not q.is_cuda or any(t.device != q.device for t in (k, v, *rows)):
        raise ValueError(f"{name} kernel needs every operand on one CUDA "
                         f"device; got {q.device}/{k.device}/{v.device}")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v, *rows)):
        raise ValueError(f"{name} kernel takes bf16; got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"{name} kernel takes head_dim in {HEAD_DIMS}; "
                         f"got {D}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (q, k, v, *rows)):
        raise ValueError(f"{name} kernel needs contiguous, 16-byte aligned "
                         "operands")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float, return_lse: bool = False):
    """Kernel B (no autograd): the output, and with ``return_lse`` also
    the fp32 LSE [B, H, S]."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale, return_lse)
    _check(KERNEL.name, q, k, v)
    B, S, H, D = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if q.numel():
        rc = build.library().picotron_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            B, S, H, k.shape[2], D, float(scale), build.stream_of(q))
        build.check(rc, KERNEL)
        KERNEL.launches += 1
    return (out, lse) if return_lse else out


def _check_rows(q, lse, name: str) -> None:
    B, S, H, _ = q.shape
    if lse.shape != (B, H, S) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"{name} must be contiguous [B, H, S] fp32 on "
                         f"{q.device}; got {tuple(lse.shape)} {lse.dtype}")


def flash_attention_bwd_dq(q, k, v, o, lse, do, scale: float) -> tuple:
    """Kernel E: (dq, delta), same numerics as
    ``flash_attention_bwd_dq_plain``."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_plain(q, k, v, o, lse, do, scale)
    _check(KERNEL_DQ.name, q, k, v, o, do)
    _check_rows(q, lse, "lse")
    B, S, H, D = q.shape
    dq, delta = torch.empty_like(q), torch.empty_like(lse)
    if q.numel():
        rc = build.library().picotron_flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dq.data_ptr(), delta.data_ptr(),
            B, S, H, k.shape[2], D, float(scale), build.stream_of(q))
        build.check(rc, KERNEL_DQ)
        KERNEL_DQ.launches += 1
    return dq, delta


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale: float) -> tuple:
    """Kernel F: (dk, dv) from E's delta, same numerics as
    ``flash_attention_bwd_dkv_plain``."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, scale)
    _check(KERNEL_DKV.name, q, k, v, do)
    _check_rows(q, lse, "lse")
    _check_rows(q, delta, "delta")
    B, S, H, D = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.numel():
        rc = build.library().picotron_flash_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, S, H, k.shape[2], D, float(scale), build.stream_of(q))
        build.check(rc, KERNEL_DKV)
        KERNEL_DKV.launches += 1
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, scale: float) -> tuple:
    """Kernels E then F: (dq, dk, dv), same numerics as
    ``flash_attention_bwd_plain``. F reads the delta = rowsum(dO * O)
    that E writes beside dQ, so F runs after E on the stream."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, scale)
    dq, delta = flash_attention_bwd_dq(q, k, v, o, lse, do, scale)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale)
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """Causal flash attention with kernel B forward (with LSE) and kernels
    E and F backward. Saves ``(q, k, v, o, lse)``; keeps nothing else on
    ``ctx`` but the scale, so a checkpointed layer can rerun it freely."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = flash_attention_fwd(q, k, v, scale, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                         ctx.scale)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float | None = None) -> torch.Tensor:
    """Causal attention; see the module docstring."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFunction.apply(q, k, v, float(scale))
    return flash_attention_fwd(q, k, v, scale)
