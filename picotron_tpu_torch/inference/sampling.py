"""Sampling over next-token logits: greedy, temperature, top-k, top-p.

Port of ``picotron_tpu/inference/sampling.py``: functions over full-vocab
logits [B, V] with per-request parameter tensors [B]. Temperature scaling
first, then top-k, then top-p on the rescaled distribution;
``temperature == 0`` means greedy for that row, ``top_k <= 0`` and
``top_p >= 1`` disable their filters. The random draw takes an explicit
``torch.Generator``: it gives other numbers than ``jax.random`` from the
same seed, so sampled streams agree with the JAX package in distribution,
not token for token.
"""

from __future__ import annotations

import torch

from picotron_tpu_torch.ops.attention import NEG_INF


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """Argmax decode: [B, V] -> [B] int32."""
    return logits.argmax(dim=-1).to(torch.int32)


def sanitize_logits(logits: torch.Tensor) -> torch.Tensor:
    """Non-finite entries -> the mask fill, so they can never be drawn."""
    return torch.where(torch.isfinite(logits), logits, NEG_INF)


def nonfinite_rows(logits: torch.Tensor) -> torch.Tensor:
    """[..., V] -> [...] bool: rows carrying any non-finite logit."""
    return ~torch.isfinite(logits).all(dim=-1)


def apply_top_k(logits: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Keep each row's k highest logits (k <= 0 disables); ties at the
    threshold all survive."""
    V = logits.shape[-1]
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    idx = (k.long() - 1).clamp(0, V - 1)
    thresh = sorted_desc.gather(-1, idx[:, None])
    keep = (k <= 0)[:, None] | (logits >= thresh)
    return torch.where(keep, logits, NEG_INF)


def apply_top_p(logits: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Nucleus filter (p >= 1 disables): the smallest prefix of the
    descending order whose mass reaches p; the top-1 token always stays."""
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_desc.float(), dim=-1)
    cum = probs.cumsum(dim=-1)
    keep_sorted = (cum - probs) < p[:, None]
    keep_sorted[:, 0] = True
    cutoff = torch.where(keep_sorted, sorted_desc,
                         float("inf")).amin(dim=-1)
    keep = (p >= 1.0)[:, None] | (logits >= cutoff[:, None])
    return torch.where(keep, logits, NEG_INF)


def filter_top_k_top_p(scaled: torch.Tensor, top_k: torch.Tensor,
                       top_p: torch.Tensor) -> torch.Tensor:
    """Both filters off one descending sort; equal to
    ``apply_top_p(apply_top_k(scaled, top_k), top_p)`` (ties at the top-k
    threshold included, the top-1 token always kept)."""
    V = scaled.shape[-1]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    idx = (top_k.long() - 1).clamp(0, V - 1)
    thresh = sorted_desc.gather(-1, idx[:, None])
    keep = (top_k[:, None] <= 0) | (sorted_desc >= thresh)
    probs = torch.softmax(torch.where(keep, sorted_desc, NEG_INF), dim=-1)
    cum = probs.cumsum(dim=-1)
    keep &= (top_p[:, None] >= 1.0) | ((cum - probs) < top_p[:, None])
    keep[:, 0] = True
    cutoff = torch.where(keep, sorted_desc, float("inf")).amin(dim=-1)
    return torch.where(scaled >= cutoff[:, None], scaled, NEG_INF)


def sample(logits: torch.Tensor, generator: torch.Generator,
           temperature: torch.Tensor, top_k: torch.Tensor,
           top_p: torch.Tensor) -> torch.Tensor:
    """One token per row: greedy where ``temperature == 0`` (and for rows
    with non-finite logits), otherwise a draw from the temperature-scaled,
    top-k- then top-p-filtered distribution. Parameters are [B] tensors on
    the logits' device; ``generator`` lives there too. A caller that knows
    every row is greedy can call ``greedy(sanitize_logits(logits))``
    instead: same tokens, no sort."""
    bad = nonfinite_rows(logits)
    logits = sanitize_logits(logits)
    greedy_tok = greedy(logits)
    t = temperature.float().clamp(min=1e-6)[:, None]
    filtered = filter_top_k_top_p(logits.float() / t, top_k, top_p)
    probs = torch.softmax(filtered, dim=-1)
    drawn = torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.where((temperature <= 0) | bad, greedy_tok,
                       drawn.to(torch.int32))
