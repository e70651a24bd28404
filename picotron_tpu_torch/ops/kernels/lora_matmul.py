"""Kernel H: the segmented multi-LoRA residual (csrc/lora_matmul.cu), and
its plain versions.

``segmented_lora(x, a, b, ids)`` computes ``out[b] = (x[b] @ a[ids[b]]) @
b[ids[b]]`` for x [B, S, K] (bf16 or fp32), a [T, K, R] and b [T, R, N]
fp32 adapter stacks and ids [B] int32, into [B, S, N] fp32 with fp32
accumulation in both contractions: the function of
``picotron_tpu/ops/pallas/lora_matmul.py::_lora_kernel`` (through
``lora_matmul_pallas``). ``segmented_lora_add_(base, x, a, b, ids)`` adds
that residual into the base output in place, as ``base +
residual.to(base.dtype)`` rounds it (the JAX seam,
``picotron_tpu/models/llama.py::matmul``), and leaves null rows as they
are. CPU tensors take the plain versions (``lora_matmul_plain``, the
gather-and-einsum fallback's order, ``lora_matmul_xla`` :118); a CUDA
tensor launches the kernel or raises. The ids stay on the device: the
kernel reads them there, so a call never waits for the host. Either entry
is one CUDA launch, planned by ``plan`` from the shapes alone, and the
fused one allocates nothing.
"""

from __future__ import annotations

import functools

import torch

from picotron_tpu_torch.ops.kernels import build

KERNEL = build.Kernel(
    name="lora_matmul", route="cuda",
    source="picotron_tpu_torch/ops/kernels/csrc/lora_matmul.cu",
    replaces="picotron_tpu/ops/pallas/lora_matmul.py:78")

# the widest pack rank the kernel takes (a column of b lives in registers)
MAX_RANK = 64
# the most blocks of a cluster that split one row tile's K (shrink) and N
# (expand) between them: the portable cluster size
MAX_CLUSTER = 8
# x columns a cluster's block should have at least to take part
MIN_COLUMNS = 256
# row tiles from which a call has clusters enough to fill the card with 4
# blocks each (a 512-row chunk: 32)
MANY_CLUSTERS = 32


@functools.lru_cache(maxsize=None)
def plan(B: int, S: int, K: int, N: int, R: int) -> dict:
    """The launch of a call, from its shapes alone: ``rows`` (the row tile
    of one cluster: 1 at decode, else 16) and ``cluster`` (its blocks, a
    power of two up to 8, fewer when K and N are narrow, and at most 4 once
    the row tiles alone give 32 clusters or more). Both modes of a call take
    the same plan, so their residuals agree bit for bit."""
    del R  # the grid grows with it; the tiles do not
    rows = 1 if S == 1 else 16
    cap = 4 if B * -(-S // rows) >= MANY_CLUSTERS else MAX_CLUSTER
    cluster = 1
    while cluster < cap and max(K, N) >= 2 * cluster * MIN_COLUMNS:
        cluster *= 2
    return {"variant": "decode" if S == 1 else "rows16", "rows": rows,
            "cluster": cluster}


def lora_matmul_plain(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                      ids: torch.Tensor) -> torch.Tensor:
    """Each row's adapter pair gathered, then two fp32 batched products."""
    idx = ids.long()
    t = torch.bmm(x.float(), a[idx].float())
    return torch.bmm(t, b[idx].float())


def lora_add_plain(base: torch.Tensor, x: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The fused entry's plain version: ``base + residual.to(base.dtype)``
    (a new tensor; the entry writes it into ``base``)."""
    return base + lora_matmul_plain(x, a, b, ids).to(base.dtype)


def _check_shapes(x, a, b, ids) -> None:
    if x.dim() != 3 or a.dim() != 3 or b.dim() != 3 \
            or a.shape[1] != x.shape[2] or a.shape[2] != b.shape[1] \
            or a.shape[0] != b.shape[0] or tuple(ids.shape) != (x.shape[0],):
        raise ValueError(f"lora_matmul shapes: x {tuple(x.shape)}, a "
                         f"{tuple(a.shape)}, b {tuple(b.shape)}, ids "
                         f"{tuple(ids.shape)}")


def _check_kernel_operands(x, a, b, ids) -> None:
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
    if not 1 <= a.shape[2] <= MAX_RANK:
        raise ValueError(f"lora_matmul kernel takes pack ranks 1 to "
                         f"{MAX_RANK}; got {a.shape[2]}")


def _launch(out, x, a, b, ids, fused: bool) -> None:
    B, S, K = x.shape
    T, _, R = a.shape
    N = b.shape[2]
    p = plan(B, S, K, N, R)
    rc = build.library().picotron_lora_matmul(
        x.data_ptr(), a.data_ptr(), b.data_ptr(), ids.data_ptr(),
        out.data_ptr(), B, S, K, N, R, T, p["rows"], p["cluster"],
        int(fused), int(x.dtype == torch.bfloat16), build.stream_of(x))
    build.check(rc, KERNEL)
    KERNEL.launches += 1


def segmented_lora(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                   ids: torch.Tensor) -> torch.Tensor:
    """See the module docstring: the residual, [B, S, N] fp32."""
    _check_shapes(x, a, b, ids)
    if x.device.type == "cpu":
        return lora_matmul_plain(x, a, b, ids)
    _check_kernel_operands(x, a, b, ids)
    B, S, K = x.shape
    out = torch.empty((B, S, b.shape[2]), dtype=torch.float32,
                      device=x.device)
    if out.numel() == 0:
        return out
    if K == 0:
        return out.zero_()
    _launch(out, x, a, b, ids, fused=False)
    return out


def segmented_lora_add_(base: torch.Tensor, x: torch.Tensor,
                        a: torch.Tensor, b: torch.Tensor,
                        ids: torch.Tensor) -> torch.Tensor:
    """See the module docstring: ``base`` [B, S, N] (bf16 or fp32) gains
    each row's residual in place, and is returned."""
    _check_shapes(x, a, b, ids)
    want = (x.shape[0], x.shape[1], b.shape[2])
    if tuple(base.shape) != want:
        raise ValueError(f"lora_matmul base {tuple(base.shape)} is not the "
                         f"[B, S, N] {want} of x and b")
    if base.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"lora_matmul base must be bf16 or fp32; got "
                         f"{base.dtype}")
    if base.device != x.device:
        raise ValueError(f"lora_matmul base lies on {base.device}, x on "
                         f"{x.device}")
    if x.device.type == "cpu":
        return base.copy_(lora_add_plain(base, x, a, b, ids))
    _check_kernel_operands(x, a, b, ids)
    if base.dtype != x.dtype or not base.is_contiguous():
        raise ValueError(f"lora_matmul kernel adds into a contiguous base "
                         f"of x's dtype {x.dtype}; got {base.dtype}"
                         f"{'' if base.is_contiguous() else ', strided'}")
    if base.numel() == 0 or x.shape[2] == 0:
        return base
    _launch(base, x, a, b, ids, fused=True)
    return base
