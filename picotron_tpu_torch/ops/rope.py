"""Rotary position embeddings (GPT-NeoX / HF-Llama rotate_half convention).

Same tables and application as ``picotron_tpu/ops/rope.py``: angles in
float64 on the host, cos/sin tiled to head_dim by concatenation and cast to
the compute dtype once; applied as ``x * cos + rotate_half(x) * sin``.
"""

from __future__ import annotations

import numpy as np
import torch


def precompute_rope(seq_length: int, head_dim: int, base: float,
                    dtype: torch.dtype, device=None) -> tuple:
    """(cos, sin), each [seq_length, head_dim]."""
    if head_dim % 2:
        raise ValueError(f"head_dim must be even, got {head_dim}")
    inv_freq = 1.0 / (base ** (np.arange(0, head_dim, 2, dtype=np.float64)
                               / head_dim))
    pos = np.arange(seq_length, dtype=np.float64)[:, None]
    angles = pos * inv_freq[None, :]
    cos = np.concatenate([np.cos(angles), np.cos(angles)], axis=-1)
    sin = np.concatenate([np.sin(angles), np.sin(angles)], axis=-1)
    return (torch.from_numpy(cos).to(device=device, dtype=dtype),
            torch.from_numpy(sin).to(device=device, dtype=dtype))


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: [batch, seq, heads, head_dim]; cos/sin: [seq, head_dim] shared
    across the batch, or [batch, seq, head_dim] per-sequence tables
    (``rope_at_positions``)."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    if cos.dim() == 3:
        c, s = cos[:, :, None, :], sin[:, :, None, :]
    else:
        c, s = cos[None, :, None, :], sin[None, :, None, :]
    return x * c + rotated * s


def rope_at_positions(cos: torch.Tensor, sin: torch.Tensor,
                      pos: torch.Tensor) -> tuple:
    """Per-sequence angle rows: ``pos`` [B] or [B, S] -> [B, S, head_dim]
    tables. Out-of-table positions clamp to the last row."""
    if pos.dim() == 1:
        pos = pos[:, None]
    pos = pos.clamp(0, cos.shape[0] - 1).long()
    return cos[pos], sin[pos]
