"""Kernel H: the segmented multi-LoRA residual (csrc/lora_matmul.cu), and
its plain version.

``segmented_lora(x, a, b, ids)`` computes ``out[b] = (x[b] @ a[ids[b]]) @
b[ids[b]]`` for x [B, S, K] (bf16 or fp32), a [T, K, R] and b [T, R, N]
fp32 adapter stacks and ids [B] int32, into [B, S, N] fp32 with fp32
accumulation in both contractions: the function of
``picotron_tpu/ops/pallas/lora_matmul.py::_lora_kernel`` (through
``lora_matmul_pallas``). CPU tensors take ``lora_matmul_plain``, the
gather-and-einsum fallback's order (``lora_matmul_xla`` :118); a CUDA
tensor launches the kernel or raises. The ids stay on the device: the
kernel reads them there, so a call never waits for the host. One call is
two CUDA launches (shrink, then expand) and counts as one launch of H.
"""

from __future__ import annotations

import torch

from picotron_tpu_torch.ops.kernels import build

KERNEL = build.Kernel(
    name="lora_matmul", route="cuda",
    source="picotron_tpu_torch/ops/kernels/csrc/lora_matmul.cu",
    replaces="picotron_tpu/ops/pallas/lora_matmul.py:78")

# the widest pack rank the kernel takes (its rank column lives in registers)
MAX_RANK = 64
# contraction columns per shrink block: a decode row's K = 8192 spreads
# over 16 blocks, whose partial sums the expand adds in a fixed order
K_SPLIT = 512


def lora_matmul_plain(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                      ids: torch.Tensor) -> torch.Tensor:
    """Each row's adapter pair gathered, then two fp32 batched products."""
    idx = ids.long()
    t = torch.bmm(x.float(), a[idx].float())
    return torch.bmm(t, b[idx].float())


def segmented_lora(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                   ids: torch.Tensor) -> torch.Tensor:
    """See the module docstring."""
    if x.dim() != 3 or a.dim() != 3 or b.dim() != 3 \
            or a.shape[1] != x.shape[2] or a.shape[2] != b.shape[1] \
            or a.shape[0] != b.shape[0] or tuple(ids.shape) != (x.shape[0],):
        raise ValueError(f"lora_matmul shapes: x {tuple(x.shape)}, a "
                         f"{tuple(a.shape)}, b {tuple(b.shape)}, ids "
                         f"{tuple(ids.shape)}")
    if x.device.type == "cpu":
        return lora_matmul_plain(x, a, b, ids)
    if not x.is_cuda or any(t.device != x.device for t in (a, b, ids)):
        raise ValueError("lora_matmul kernel needs every operand on one "
                         "CUDA device")
    if x.dtype not in (torch.bfloat16, torch.float32) \
            or a.dtype != torch.float32 or b.dtype != torch.float32 \
            or ids.dtype != torch.int32:
        raise ValueError(f"lora_matmul kernel takes bf16 or fp32 x, fp32 "
                         f"a and b, int32 ids; got {x.dtype}, {a.dtype}, "
                         f"{b.dtype}, {ids.dtype}")
    if not all(t.is_contiguous() for t in (x, a, b, ids)):
        raise ValueError("lora_matmul kernel needs contiguous operands")
    B, S, K = x.shape
    T, _, R = a.shape
    N = b.shape[2]
    if not 1 <= R <= MAX_RANK:
        raise ValueError(f"lora_matmul kernel takes pack ranks 1 to "
                         f"{MAX_RANK}; got {R}")
    out = torch.empty((B, S, N), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    if K == 0:
        return out.zero_()
    t = torch.empty((-(-K // K_SPLIT), B, S, R), dtype=torch.float32,
                    device=x.device)
    rc = build.library().picotron_lora_matmul(
        x.data_ptr(), a.data_ptr(), b.data_ptr(), ids.data_ptr(),
        t.data_ptr(), out.data_ptr(), B, S, K, N, R, T, K_SPLIT,
        int(x.dtype == torch.bfloat16), build.stream_of(x))
    build.check(rc, KERNEL)
    KERNEL.launches += 1
    return out
