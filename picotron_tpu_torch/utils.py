"""Small host-side helpers: logging, device resolution, and the training
log's arithmetic (FLOPs per token, MFU, readable numbers)."""

from __future__ import annotations

import torch


def log0(*args, **kwargs) -> None:
    """print() on the controlling process. The port runs one process per
    engine (no multi-host serving yet), so this is plain print; it keeps
    the JAX package's call sites recognisable."""
    print(*args, **kwargs)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means the CUDA card,
    and raises when there is none. The CPU is used only when the caller
    asks for it by name (``device="cpu"``), as the tests do."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port serves on the GPU; pass "
                "device='cpu' to run the plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype string ("bfloat16", "float32", ...) -> torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


# Dense bf16 tensor-core peak per card, by a substring of
# torch.cuda.get_device_name() (NVIDIA's data sheets). "H100 80GB HBM3" is
# the SXM part; other cards get no MFU, as the JAX function returns None
# off the TPU kinds it knows.
GPU_PEAK_FLOPS = {
    "H100 80GB HBM3": 989e12,
}


def peak_flops_per_chip(device=None) -> float | None:
    """The card's dense bf16 peak, or None (CPU, or a card not in
    ``GPU_PEAK_FLOPS``)."""
    device = torch.device(device) if device is not None else None
    if device is not None and device.type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(device)
    for key, val in GPU_PEAK_FLOPS.items():
        if key in name:
            return val
    return None


def flops_per_token(num_params: int, num_layers: int, hidden: int,
                    seq_len: int) -> float:
    """6N + 12 * layers * hidden * seq (parameter FLOPs plus the attention
    quadratic term)."""
    return 6 * num_params + 12 * num_layers * hidden * seq_len


def get_mfu(tokens_per_sec_per_chip: float, num_params: int, num_layers: int,
            hidden: int, seq_len: int, peak: float | None) -> float | None:
    """Model FLOPs utilisation in percent, or None without a peak."""
    if peak is None:
        return None
    fpt = flops_per_token(num_params, num_layers, hidden, seq_len)
    return 100.0 * fpt * tokens_per_sec_per_chip / peak


def to_readable_format(num: float, precision: int = 2) -> str:
    """1234567 -> '1.23M'."""
    for bound, suffix in ((1e12, "T"), (1e9, "B"), (1e6, "M"), (1e3, "K")):
        if abs(num) >= bound:
            return f"{num / bound:.{precision}f}{suffix}"
    return f"{num:.{precision}f}"


def device_memory_gb(device: torch.device) -> float | None:
    """Peak bytes allocated on a CUDA device, in GB (None on the CPU)."""
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 1e9
