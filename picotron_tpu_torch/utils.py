"""Small host-side helpers: logging and device resolution."""

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
