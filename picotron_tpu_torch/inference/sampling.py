"""Sampling over next-token logits: greedy, temperature, top-k, top-p.

Port of ``picotron_tpu/inference/sampling.py``: functions over full-vocab
logits [B, V] with per-request parameter tensors [B]. Temperature scaling
first, then top-k, then top-p on the rescaled distribution;
``temperature == 0`` means greedy for that row, ``top_k <= 0`` and
``top_p >= 1`` disable their filters. The random draw takes an explicit
``torch.Generator``: it gives other numbers than ``jax.random`` from the
same seed, so sampled streams agree with the JAX package in distribution,
not token for token.

``speculative_accept`` is the verify pass's acceptance rule (Leviathan et
al. 2023; Chen et al. 2023) for a deterministic drafter: greedy rows keep
the draft prefix that matches the argmax chain and emit the argmax after
it, bit for bit the JAX rule's; sampled rows accept draft ``i`` with
probability ``p_i(draft_i)`` and draw the fresh token from the residual,
which keeps the sampler's distribution. ``speculative_match`` is the
per-slot schedule's rule: every fed position draws the target chain's own
token with the key that position owns, and the draft prefix that matches
it is accepted, so the emitted stream never depends on the drafts.
"""

from __future__ import annotations

import torch

from picotron_tpu_torch.inference import prng
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
    keep_sorted[:, 0].fill_(True)
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
    keep[:, 0].fill_(True)  # fill_: no host value copied up
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


def sample_rowkeys(logits: torch.Tensor, keys: torch.Tensor,
                   temperature: torch.Tensor, top_k: torch.Tensor,
                   top_p: torch.Tensor,
                   greedy_only: bool | None = None) -> torch.Tensor:
    """``sample`` with a key per row (the per-slot key schedule): row ``b``
    draws ``prng.categorical`` with ``keys[b]`` ([B, 2] threefry keys) over
    the same filtered logits, so a row's token depends only on its key and
    its logits, and a row drawn here equals that row drawn alone. Greedy
    rows and rows with non-finite logits take the sanitized argmax, as in
    ``sample``. ``greedy_only`` (the caller knows every row is greedy, or
    knows one is not) skips reading the temperatures on the device; an
    all-greedy batch runs no filter and no draw."""
    bad = nonfinite_rows(logits)
    logits = sanitize_logits(logits)
    greedy_tok = greedy(logits)
    if greedy_only is None:
        greedy_only = bool((temperature <= 0).all())
    if greedy_only:
        return greedy_tok
    t = temperature.float().clamp(min=1e-6)[:, None]
    filtered = filter_top_k_top_p(logits.float() / t, top_k, top_p)
    drawn = prng.categorical(keys, filtered).to(torch.int32)
    return torch.where((temperature <= 0) | bad, greedy_tok, drawn)


def filtered_probs(logits: torch.Tensor, temperature: torch.Tensor,
                   top_k: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """The distribution ``sample`` draws its sampled rows from: softmax
    over the temperature-scaled, top-k- and top-p-filtered logits, the
    non-finite entries sanitized first. [N, V] with [N] parameters ->
    [N, V] fp32."""
    t = temperature.float().clamp(min=1e-6)[:, None]
    return torch.softmax(filter_top_k_top_p(
        sanitize_logits(logits).float() / t, top_k, top_p), dim=-1)


def _per_row(x: torch.Tensor, S: int) -> torch.Tensor:
    """Each slot's parameter for each of its S rows: [B] -> [B * S]
    (``repeat_interleave`` without its output-size read on the card)."""
    return x[:, None].expand(x.shape[0], S).reshape(-1)


def _leading_true(ok: torch.Tensor) -> torch.Tensor:
    """Length of each row's leading all-True run: [B, G] bool -> [B]
    int32."""
    return torch.cumprod(ok.to(torch.int32), dim=1).sum(dim=1,
                                                        dtype=torch.int32)


def speculative_accept(logits: torch.Tensor, draft: torch.Tensor,
                       generator: torch.Generator,
                       temperature: torch.Tensor, top_k: torch.Tensor,
                       top_p: torch.Tensor,
                       draft_len: torch.Tensor | None = None,
                       greedy_only: bool | None = None) -> tuple:
    """Accept a deterministic draft against the verify pass's logits.

    ``logits`` [B, S, V] fp32, where ``logits[:, i]`` scores the token
    after fed token ``i`` (S = G + 1: the slot's last token, then G
    drafts); ``draft`` [B, G] int32; ``temperature``/``top_k``/``top_p``
    [B], as ``sample`` takes them. ``draft_len`` [B] (None: G everywhere)
    makes the verify ragged: columns at or past a row's own draft length
    are never accepted and never count as a rejection, so a row with
    draft length 0 is one decode step. Returns (emitted [B, S] int32,
    counts [B] int32): the leading ``counts[b]`` (1 to G + 1) entries of
    row b are the accepted drafts and one fresh token, zeros after.

    Greedy rows (temperature <= 0) accept while the draft equals the
    argmax of the sanitized logits and emit the argmax after the run.
    Sampled rows draw G uniforms from ``generator`` (draft ``i`` accepted
    while ``u_i < p_i(draft_i)``), then one categorical draw from the
    residual: ``p`` at the first rejected position with the rejected
    token taken out, renormalized, or the bonus position's ``p`` when
    every real draft was accepted. ``greedy_only`` (the caller knows every
    row is greedy, or knows one is not) skips reading the temperatures on
    the device; an all-greedy batch runs no filter, softmax or draw."""
    B, S, V = logits.shape
    G = S - 1
    dev = logits.device
    cols_g = torch.arange(G, device=dev)[None, :]
    real = (cols_g < draft_len[:, None]) if draft_len is not None else None
    preds = greedy(sanitize_logits(logits.reshape(B * S, V))).reshape(B, S)
    ok_greedy = draft == preds[:, :G]
    if real is not None:
        ok_greedy &= real
    acc_greedy = _leading_true(ok_greedy)
    last_greedy = preds.gather(1, acc_greedy.long()[:, None])[:, 0]
    if greedy_only is None:
        greedy_only = bool((temperature <= 0).all())
    if greedy_only:
        acc, last = acc_greedy, last_greedy
    else:
        probs = filtered_probs(
            logits.reshape(B * S, V), _per_row(temperature, S),
            _per_row(top_k, S), _per_row(top_p, S)).reshape(B, S, V)
        p_draft = probs[:, :G].gather(2, draft.long()[..., None])[..., 0]
        u = torch.rand((B, G), generator=generator, device=dev)
        ok = u < p_draft
        if real is not None:
            ok &= real
        acc_s = _leading_true(ok)
        p_next = probs.gather(
            1, acc_s.long()[:, None, None].expand(B, 1, V))[:, 0]
        rej = draft.gather(1, acc_s.clamp(max=G - 1).long()[:, None])[:, 0]
        rejected = acc_s < (draft_len if draft_len is not None else G)
        strip = ((torch.arange(V, device=dev)[None, :] == rej[:, None])
                 & rejected[:, None])
        res = torch.where(strip, 0.0, p_next)
        total = res.sum(dim=-1, keepdim=True)
        # an empty residual draws uniformly, as the JAX rule's categorical
        # over log(max(res, 1e-20)) does
        res = torch.where(total > 0, res / total.clamp(min=1e-20), 1.0 / V)
        fresh = torch.multinomial(res, 1, generator=generator)[:, 0]
        sampled_row = temperature > 0
        acc = torch.where(sampled_row, acc_s, acc_greedy)
        last = torch.where(sampled_row, fresh.to(torch.int32), last_greedy)
    cols = torch.arange(S, device=dev)[None, :]
    padded = torch.cat([draft.to(torch.int32),
                        torch.zeros((B, 1), dtype=torch.int32, device=dev)],
                       dim=1)
    emitted = torch.where(cols < acc[:, None], padded, 0)
    emitted = torch.where(cols == acc[:, None], last[:, None], emitted)
    return emitted.to(torch.int32), (acc + 1).to(torch.int32)


def speculative_match(logits: torch.Tensor, draft: torch.Tensor,
                      base_keys: torch.Tensor, positions: torch.Tensor,
                      temperature: torch.Tensor, top_k: torch.Tensor,
                      top_p: torch.Tensor,
                      draft_len: torch.Tensor | None = None,
                      greedy_only: bool | None = None) -> tuple:
    """Draft acceptance under the per-slot key schedule: sample and match.

    Every fed position ``i`` of row ``b`` draws the target chain's own token
    ``s[b, i] = sample_rowkeys(logits[b, i], fold_in(base_keys[b],
    positions[b, i]))``; the draft prefix equal to ``s`` is accepted, and
    ``s`` at the first mismatch (or the bonus position) is the fresh
    token. So the emitted stream is a function of the base keys, the
    positions and the logits, never of the drafts: speculative output
    equals token-by-token decoding under the same schedule. For a
    deterministic drafter this is rejection sampling (a draft is accepted
    iff the chain's own draw equals it).

    ``base_keys`` [B, 2] per-slot keys; ``positions`` [B, S] the KV row
    each fed token was written at (the fold-in data of the draw that
    follows it). The other arguments and the return value ``(emitted [B,
    S] int32, counts [B] int32)`` are ``speculative_accept``'s."""
    B, S, V = logits.shape
    G = S - 1
    if greedy_only is None:
        greedy_only = bool((temperature <= 0).all())
    keys = None if greedy_only else prng.fold_in(
        prng.as_key(base_keys, logits.device)[:, None, :],
        positions).reshape(B * S, 2)
    s = sample_rowkeys(
        logits.reshape(B * S, V), keys, _per_row(temperature, S),
        _per_row(top_k, S), _per_row(top_p, S),
        greedy_only=greedy_only).reshape(B, S)
    ok = draft == s[:, :G]
    if draft_len is not None:
        ok &= (torch.arange(G, device=logits.device)[None, :]
               < draft_len[:, None])
    acc = _leading_true(ok)
    cols = torch.arange(S, device=logits.device)[None, :]
    emitted = torch.where(cols <= acc[:, None], s, 0)
    return emitted.to(torch.int32), (acc + 1).to(torch.int32)
