"""Kernel C: flash decode, KV-cache attention (csrc/decode_attention.cu),
and its plain versions.

``flash_decode_attention`` is the wrapper ``inference/kv_cache.attend``
calls for ``attend_impl="flash"``: CPU tensors take the plain version; a
CUDA tensor launches the kernel or raises. The function is
``picotron_tpu/ops/pallas/decode_attention.py::flash_decode_attention``'s
contiguous form: S fresh queries per slot, query row ``s`` at position
``lengths[b] - S + s`` seeing key ``t`` iff ``t <=`` that position (and
``t < T``), fp32 softmax and P @ V, and rows with no visible key returning
zeros. Two variants, each its own kernel with its own launch count:

- full precision (``KERNEL``): bf16 K/V as stored;
- int8 (``KERNEL_INT8``, the Pallas kernel's ``quantized=True`` path):
  int8 K/V with fp32 per-row scales ``k_scale``/``v_scale`` [B, T, Hkv],
  each row dequantized in registers (int8 -> fp32 x scale) as the tile
  loads. Its plain version dequantizes the whole block to fp32 first and
  runs the full-precision arithmetic.
"""

from __future__ import annotations

import torch

from picotron_tpu_torch.ops.kernels import build

KERNEL = build.Kernel(
    name="flash_decode", route="cuda",
    source="picotron_tpu_torch/ops/kernels/csrc/decode_attention.cu",
    replaces="picotron_tpu/ops/pallas/decode_attention.py:162")
KERNEL_INT8 = build.Kernel(
    name="flash_decode_int8", route="cuda",
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


def flash_decode_attention_int8_plain(q, k, v, lengths, scale, k_scale,
                                      v_scale) -> torch.Tensor:
    """The int8 variant's plain version: K/V dequantized to fp32
    (int8 x per-row scale), then the full-precision arithmetic."""
    kf = k.float() * k_scale[..., None]
    vf = v.float() * v_scale[..., None]
    return flash_decode_attention_plain(q, kf, vf, lengths, scale)


def _check(kernel, q, k, v, lengths, kv_dtype, *scales) -> None:
    B, S, H, D = q.shape
    if k.shape != v.shape or k.dim() != 4 or k.shape[0] != B \
            or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"{kernel.name} shapes: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if any(tuple(t.shape) != tuple(k.shape[:3]) for t in scales):
        raise ValueError(f"{kernel.name}: scales must be "
                         f"{tuple(k.shape[:3])}; got "
                         f"{[tuple(t.shape) for t in scales]}")
    if tuple(lengths.shape) != (B,) or lengths.dtype != torch.int32:
        raise ValueError(f"lengths must be [{B}] int32; got "
                         f"{tuple(lengths.shape)} {lengths.dtype}")
    if not q.is_cuda or any(t.device != q.device
                            for t in (k, v, lengths, *scales)):
        raise ValueError(f"{kernel.name} kernel needs every operand on one "
                         f"CUDA device")
    if q.dtype != torch.bfloat16 or k.dtype != kv_dtype \
            or v.dtype != kv_dtype \
            or any(t.dtype != torch.float32 for t in scales):
        raise ValueError(f"{kernel.name} kernel takes bf16 q, {kv_dtype} "
                         f"k/v and fp32 scales; got {q.dtype}/{k.dtype}/"
                         f"{v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"{kernel.name} kernel takes head_dim in "
                         f"{HEAD_DIMS}; got {D}")
    if not all(t.is_contiguous() for t in (q, k, v, lengths, *scales)) \
            or any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{kernel.name} kernel needs contiguous operands, "
                         "q/k/v 16-byte aligned")


def flash_decode_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, lengths: torch.Tensor,
                           scale: float, k_scale: torch.Tensor | None = None,
                           v_scale: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """See the module docstring. ``k_scale``/``v_scale`` select the int8
    variant (int8 ``k``/``v``); they come together or not at all."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be given together")
    quantized = k_scale is not None
    if (k.dtype == torch.int8) != quantized:
        raise ValueError(
            f"int8 cache blocks need per-row scales (and vice versa); got "
            f"k.dtype={k.dtype} with scales="
            f"{'set' if quantized else 'unset'}")
    if q.device.type == "cpu":
        if quantized:
            return flash_decode_attention_int8_plain(q, k, v, lengths, scale,
                                                     k_scale, v_scale)
        return flash_decode_attention_plain(q, k, v, lengths, scale)
    B, S, H, D = q.shape
    if quantized:
        _check(KERNEL_INT8, q, k, v, lengths, torch.int8, k_scale, v_scale)
    else:
        _check(KERNEL, q, k, v, lengths, torch.bfloat16)
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    if quantized:
        rc = build.library().picotron_flash_decode_int8(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr(), lengths.data_ptr(), out.data_ptr(), B, S, H,
            k.shape[2], k.shape[1], D, float(scale), build.stream_of(q))
        build.check(rc, KERNEL_INT8)
        KERNEL_INT8.launches += 1
    else:
        rc = build.library().picotron_flash_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), B, S, H, k.shape[2], k.shape[1], D, float(scale),
            build.stream_of(q))
        build.check(rc, KERNEL)
        KERNEL.launches += 1
    return out
