"""Kernel G: the int8-weight matmul (csrc/quant_matmul.cu), and its plain
version.

``quant_matmul_2d(x, q, s)`` computes ``(x @ q) * s`` for x [M, K], int8 q
[K, N] and fp32 per-output-channel scales s [N]: fp32 accumulation, the
scale applied once to the fp32 result, then a cast to ``x.dtype``. It is
the function of ``picotron_tpu/ops/pallas/quant_matmul.py::
_quant_matmul_kernel`` (through ``quant_matmul_pallas``). CPU tensors take
``quant_matmul_plain``, the XLA fallback's order (:184-194); a CUDA tensor
launches the kernel or raises. The model reaches it through
``ops/quant_matmul.quant_matmul``, which flattens leading dimensions.
"""

from __future__ import annotations

import torch

from picotron_tpu_torch.ops.kernels import build

KERNEL = build.Kernel(
    name="quant_matmul", route="cuda",
    source="picotron_tpu_torch/ops/kernels/csrc/quant_matmul.cu",
    replaces="picotron_tpu/ops/pallas/quant_matmul.py:130")


def quant_matmul_plain(x: torch.Tensor, q: torch.Tensor,
                       s: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ q [K, N] int8 in fp32, times s [N], cast to x.dtype. The
    int8 operand is cast, never scaled: no dequantized weight exists."""
    return ((x.float() @ q.float()) * s.float()).to(x.dtype)


def quant_matmul_2d(x: torch.Tensor, q: torch.Tensor,
                    s: torch.Tensor) -> torch.Tensor:
    """See the module docstring."""
    if x.dim() != 2 or q.dim() != 2 or x.shape[1] != q.shape[0] \
            or tuple(s.shape) != (q.shape[1],):
        raise ValueError(f"quant_matmul shapes: x {tuple(x.shape)}, "
                         f"q {tuple(q.shape)}, s {tuple(s.shape)}")
    if q.dtype != torch.int8:
        raise ValueError(f"quant_matmul weights must be int8, got {q.dtype}")
    if x.device.type == "cpu":
        return quant_matmul_plain(x, q, s)
    if not x.is_cuda or any(t.device != x.device for t in (q, s)):
        raise ValueError("quant_matmul kernel needs every operand on one "
                         "CUDA device")
    if x.dtype != torch.bfloat16 or s.dtype != torch.float32:
        raise ValueError(f"quant_matmul kernel takes bf16 x and fp32 s; got "
                         f"{x.dtype} and {s.dtype}")
    if not all(t.is_contiguous() for t in (x, q, s)):
        raise ValueError("quant_matmul kernel needs contiguous operands")
    M, K = x.shape
    N = q.shape[1]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    rc = build.library().picotron_quant_matmul(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(), M, N, K,
        build.stream_of(x))
    build.check(rc, KERNEL)
    KERNEL.launches += 1
    return out
