"""Plain scaled-dot-product attention, written out.

Port of ``picotron_tpu/ops/attention.py::sdpa``: fp32 scores and softmax,
a causal mask with the same large-negative fill, output cast back to
``q.dtype``. q/k/v carry the same number of heads; GQA repetition happens
in the model. ``torch.nn.functional.scaled_dot_product_attention`` is not
used: this is the reference path the kernels are held against.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30  # large-negative instead of -inf: fully masked rows stay finite


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
         causal: bool = True) -> torch.Tensor:
    """q: [B, Sq, H, D], k/v: [B, Sk, H, D] -> [B, Sq, H, D] in q.dtype."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        scores = torch.where(mask, scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)
