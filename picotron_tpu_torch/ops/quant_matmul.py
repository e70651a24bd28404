"""Per-output-channel int8 weights and the matmul that consumes them.

Port of ``picotron_tpu/ops/pallas/quant_matmul.py`` (the entry points; the
kernel is ``ops/kernels/quant_matmul.py``, kernel G). A matmul weight
``w`` [..., in, out] is stored as int8 values with ONE fp32 scale per
output channel: the absmax over the contraction axis (-2), so the error of
one channel never reaches another. ``quant_matmul(x, q, s)`` consumes that
storage directly: fp32 accumulation over the int8 values, the scale on the
fp32 result, never a dequantized weight.

``dequantize_weight`` exists for tests and for the fake-quant reference
only; the serving path never calls it (a test replaces it with one that
raises, and a full int8 generation still runs).
"""

from __future__ import annotations

import numpy as np
import torch

from picotron_tpu_torch.ops.kernels.quant_matmul import quant_matmul_2d

# int8 symmetric range; scales are fp32, so the epilogue multiply never
# rounds twice (the int8 KV cache's convention, inference/kv_cache.py)
INT8_MAX = 127.0
SCALE_DTYPE = torch.float32


def is_quant_weight(leaf) -> bool:
    """Whether a parameter leaf is a quantized pair ``{"q": int8 [..., in,
    out], "s": fp32 [..., out]}`` (the form ``models/llama.matmul``
    dispatches on)."""
    return isinstance(leaf, dict) and set(leaf) == {"q", "s"}


def quantize_weight(w: torch.Tensor) -> dict:
    """Per-output-channel absmax int8 quantization of ``w`` [..., in, out]
    on its own device. The divisor is ``max(amax / 127, 1e-12)``, rounding
    is half-to-even, and the stored scale is that divisor (0 for an
    all-zero channel, which quantizes to zeros), as in the JAX package."""
    wf = w.float()
    amax = wf.abs().amax(dim=-2)
    div = torch.clamp(amax / INT8_MAX, min=1e-12)
    q = torch.round(wf / div[..., None, :])
    del wf
    return {"q": q.clamp_(-INT8_MAX, INT8_MAX).to(torch.int8),
            "s": torch.where(amax > 0, div, 0.0).to(SCALE_DTYPE)}


def quantize_weight_host(w: np.ndarray) -> dict:
    """``quantize_weight`` in numpy, on the host."""
    wf = np.asarray(w, np.float32)
    amax = np.max(np.abs(wf), axis=-2)
    div = np.maximum(amax / INT8_MAX, np.float32(1e-12))
    q = np.round(wf / div[..., None, :])
    return {"q": np.clip(q, -INT8_MAX, INT8_MAX).astype(np.int8),
            "s": np.where(amax > 0, div, 0.0).astype(np.float32)}


def dequantize_weight(q: torch.Tensor, s: torch.Tensor,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of ``quantize_weight``: TESTS AND THE FAKE-QUANT REFERENCE
    ONLY."""
    return (q.float() * s[..., None, :]).to(dtype)


def quant_matmul(x: torch.Tensor, q: torch.Tensor,
                 s: torch.Tensor) -> torch.Tensor:
    """``x @ W`` from int8 weights q [in, out] and fp32 scales s [out]:
    x [..., in] -> [..., out] in x.dtype. Leading dimensions flatten
    through kernel G (its plain version for CPU tensors)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    return quant_matmul_2d(x2, q, s).reshape(*lead, q.shape[1])
