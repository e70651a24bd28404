"""Carry parameters between the JAX package and the port.

Both packages keep the same tree: ``{"embed", "layers": {leaf: [L, ...]},
"final_norm", "lm_head"}`` with linear weights ``(in, out)``. So a JAX
parameter tree, once fetched to numpy (``jax.tree.map(np.asarray, p)``),
becomes the port's dict of tensors leaf by leaf, and back.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _to_tensor(a, device, dtype) -> torch.Tensor:
    a = np.array(a)  # a writable copy: JAX hands out read-only buffers
    if a.dtype.name == "bfloat16":
        # numpy has no native bf16: JAX hands out an ml_dtypes array, whose
        # bits are torch's bfloat16 bits
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_jax(tree: dict, device=None,
                    dtype: torch.dtype | None = None) -> dict[str, Any]:
    """A JAX parameter tree of numpy arrays -> the port's parameter dict
    (nested like the input), on ``device`` (default CPU), cast to
    ``dtype`` when given."""
    device = torch.device(device if device is not None else "cpu")
    return {k: (params_from_jax(v, device, dtype) if isinstance(v, dict)
                else _to_tensor(v, device, dtype))
            for k, v in tree.items()}


def params_to_jax(params: dict) -> dict[str, Any]:
    """The port's parameter dict -> a tree of numpy arrays for the JAX
    package. bf16 tensors come back as float32 (exact: every bf16 value
    is a float32 value), since numpy has no bf16 of its own."""
    def conv(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return {k: (params_to_jax(v) if isinstance(v, dict) else conv(v))
            for k, v in params.items()}
