"""Cross-entropy of the LM head's logits, at tp = 1.

Port of ``picotron_tpu/ops/cross_entropy.py``:

- ``cross_entropy_gathered`` (:25): plain mean CE over materialised fp32
  logits, the reference path;
- ``cross_entropy_fused`` (:88): the mean CE of ``x @ w`` computed in row
  chunks of ``chunk_rows`` (1024), so the [T, V] fp32 logits never exist
  at once. The forward keeps each row's fp32 logz; the backward recomputes
  each chunk's logits (one extra head product) instead of keeping them.
  The rows are zero-padded to whole chunks, and a mask keeps the padded
  tail out of both the loss and the gradient (``_chunks`` :108).

Neither is a Pallas kernel in the JAX package, so both are torch ops with
``torch.matmul``. At tp = 1 the vocab-parallel statistics of the JAX
version (pmax/psum over 'tp') are the plain max and sum.
"""

from __future__ import annotations

import torch

CHUNK_ROWS = 1024


def cross_entropy_gathered(logits: torch.Tensor,
                           targets: torch.Tensor) -> torch.Tensor:
    """logits [B, S, V]; targets [B, S] -> mean loss (fp32 scalar)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, targets[..., None].long())[..., 0]
    return (logz - picked).mean()


def _chunks(x2: torch.Tensor, t: torch.Tensor, chunk_rows: int):
    """Rows split into ceil(T / tc) chunks of tc = min(chunk_rows, T), the
    tail zero-padded; the fp32 mask marks the real rows."""
    T = x2.shape[0]
    tc = min(chunk_rows, T)
    n = -(-T // tc)
    pad = n * tc - T
    if pad:
        x2 = torch.cat([x2, x2.new_zeros(pad, x2.shape[1])])
        t = torch.cat([t, t.new_zeros(pad)])
    mask = (torch.arange(n * tc, device=x2.device) < T).float()
    return (x2.reshape(n, tc, -1), t.reshape(n, tc), mask.reshape(n, tc),
            n)


class FusedCrossEntropy(torch.autograd.Function):
    """Mean CE of ``x @ w`` (see the module docstring). Saves ``x``,
    ``w``, the targets and the fp32 logz [T] of every row."""

    @staticmethod
    def forward(ctx, x, w, targets, chunk_rows):
        H = x.shape[-1]
        x2, t = x.reshape(-1, H), targets.reshape(-1).long()
        T = x2.shape[0]
        xc, tc, mc, n = _chunks(x2, t, chunk_rows)
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        logz_all = []
        for i in range(n):
            logits = (xc[i] @ w).float()  # [tc, V]
            logz = torch.logsumexp(logits, dim=-1)
            picked = logits.gather(1, tc[i][:, None])[:, 0]
            total = total + ((logz - picked) * mc[i]).sum()
            logz_all.append(logz)
        ctx.save_for_backward(x, w, targets, torch.cat(logz_all))
        ctx.chunk_rows = chunk_rows
        return total / T

    @staticmethod
    def backward(ctx, g):
        x, w, targets, logz = ctx.saved_tensors
        H = x.shape[-1]
        x2, t = x.reshape(-1, H), targets.reshape(-1).long()
        T = x2.shape[0]
        xc, tc, mc, n = _chunks(x2, t, ctx.chunk_rows)
        lzc = logz.reshape(n, -1)
        scale = g.float() / T
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        dxc = []
        for i in range(n):
            p = torch.exp((xc[i] @ w).float() - lzc[i][:, None])
            p[torch.arange(p.shape[0], device=p.device), tc[i]] -= 1.0
            dlog = (p * (scale * mc[i])[:, None]).to(w.dtype)
            # bf16 products accumulate in fp32 inside the matmul; dx rounds
            # once to x's dtype, as the JAX version's fp32 dot_general then
            # astype does. Each chunk's dw rounds to w's dtype before the
            # fp32 sum over chunks (the JAX version keeps it in fp32): one
            # more bf16 rounding per chunk, none in fp32
            dxc.append((dlog @ w.t()).to(x.dtype))
            dw += (xc[i].t() @ dlog).float()
        dx = torch.cat(dxc)[:T].reshape(x.shape)
        return dx, dw.to(w.dtype), None, None


def cross_entropy_fused(x: torch.Tensor, w: torch.Tensor,
                        targets: torch.Tensor,
                        chunk_rows: int = CHUNK_ROWS) -> torch.Tensor:
    """x [B, S, H], w [H, V], targets [B, S] -> mean CE (fp32 scalar)."""
    return FusedCrossEntropy.apply(x, w, targets, chunk_rows)
