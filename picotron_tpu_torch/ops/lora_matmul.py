"""Segmented multi-LoRA matmul: one dispatch, many adapters.

Port of ``picotron_tpu/ops/pallas/lora_matmul.py`` (the entry point; the
kernel is ``ops/kernels/lora_matmul.py``, kernel H). Every tenant's
low-rank adapter pair lives stacked in one ``[T, in, r]`` / ``[T, r,
out]`` pack, and a per-row id vector ``ids [B]`` picks the pair each batch
row runs, so one prefill or decode dispatch mixes tenants. The base
product (dense, or kernel G's int8 pair) is untouched: the adapter adds
an fp32 residual

    residual[b] = (x[b] @ a[ids[b]]) @ b[ids[b]]

onto the base output at ``models/llama.matmul`` (``lora_matmul_add_``:
on the card one launch of H, which adds it in place). Slot 0 of every pack is
the reserved null adapter (A = B = 0): base-only rows ride the same
dispatch and their residual is exactly zero. An engine with no pack never
builds adapter leaves, so its paths run exactly as before.

The device picks the implementation: a CPU tensor runs the plain version
(``lora_matmul_plain``, the JAX package's ``lora_matmul_xla``), a CUDA
tensor kernel H.
"""

from __future__ import annotations

import numpy as np
import torch

from picotron_tpu_torch.ops.kernels.lora_matmul import (  # noqa: F401
    lora_matmul_plain,
    segmented_lora,
    segmented_lora_add_,
)

# Packs store fp32: the residual accumulates in fp32 end to end, and
# adapter bytes are small next to the base weights they modify.
ADAPTER_DTYPE = torch.float32

# The reserved null adapter in slot 0 of every pack (A = B = 0).
NULL_ADAPTER = 0


def is_lora_weight(leaf) -> bool:
    """Whether a parameter leaf is an adapter-wrapped weight ``{"w":
    base_leaf, "a": [T, in, r], "b": [T, r, out], "ids": [B]}`` (the form
    ``models/llama.matmul`` dispatches on); ``w`` may itself be the
    quantized ``{"q", "s"}`` pair."""
    return isinstance(leaf, dict) and set(leaf) == {"w", "a", "b", "ids"}


def _operands(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, ids):
    """The JAX entry's checks, with its messages; ids as int32 on x's
    device (a tensor there already, or a host sequence)."""
    if x.dim() != 3:
        raise ValueError(
            f"lora_matmul expects x [B, S, in]; got {tuple(x.shape)}")
    if a.dim() != 3 or b.dim() != 3 or a.shape[2] != b.shape[1] \
            or a.shape[0] != b.shape[0]:
        raise ValueError(
            f"adapter pack shapes disagree: a {tuple(a.shape)} (want [T, "
            f"in, r]) vs b {tuple(b.shape)} (want [T, r, out])")
    if not torch.is_tensor(ids):
        ids = torch.from_numpy(np.asarray(ids, np.int32).reshape(-1)).to(
            x.device)
    elif ids.dtype != torch.int32:
        ids = ids.to(torch.int32)
    return ids


def lora_matmul(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                ids) -> torch.Tensor:
    """Per-row adapter residual ``(x[b] @ a[ids[b]]) @ b[ids[b]]``.

    x: [B, S, in] activations (bf16 or fp32); a: [T, in, r] fp32 stacked
    down-projections; b: [T, r, out] fp32 stacked up-projections; ids:
    [B] adapter slots (0 = the null adapter: an exactly zero residual),
    a tensor on x's device or a host sequence. Returns [B, S, out] fp32.
    """
    ids = _operands(x, a, b, ids)
    return segmented_lora(x.contiguous(), a, b, ids)


def lora_matmul_add_(base: torch.Tensor, x: torch.Tensor, a: torch.Tensor,
                     b: torch.Tensor, ids) -> torch.Tensor:
    """``base += lora_matmul(x, a, b, ids).to(base.dtype)`` in place, and
    ``base`` returned: the seam's form. ``base`` is the base product
    [B, S, out] (bf16 or fp32); rows of the null adapter are left as they
    are. On the card one launch of H and no allocation; on the CPU the
    plain version, the same values as ``base + residual.to(base.dtype)``.
    """
    ids = _operands(x, a, b, ids)
    return segmented_lora_add_(base, x.contiguous(), a, b, ids)
