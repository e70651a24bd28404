"""Speculative decoding: the drafters and the per-slot spec_len controller.

Port of ``picotron_tpu/inference/speculative.py``. A drafter proposes
``spec_len`` tokens a slot; one ``engine.verify`` pass scores them all
and ``sampling.speculative_accept`` keeps the matching prefix and one
fresh token, so a dispatch emits 1 to ``spec_len + 1`` tokens a slot and
the output distribution is the sampler's (greedy streams bit for bit the
spec-off streams on the CPU).

- ``NgramDrafter``: prompt-lookup drafting from the slot's own history,
  with an incremental per-request suffix index (``ctx``) and an optional
  ``window`` on how far back a match may land;
- ``LearnedDrafter``: the EAGLE-style head over the target's own last
  hidden state (``engine.make_draft_program``), sharing its embedding,
  final norm and LM head;
- ``SpecController``: each slot's draft length and drafter for the next
  round, from the slot's draft counts and the batcher's dispatch
  latencies (``DispatchLatency``).

The JAX controller reads its counts and latencies from the obs registry
(``picotron_slot_draft_*_total``, ``picotron_dispatch_seconds``); the port
has no registry yet, so the batcher hands the same counts to ``record``
and keeps the latency tally itself. The decisions are the JAX
controller's on the same counts and latencies.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


class Drafter:
    """Proposes draft tokens for one slot from its token history.

    A drafter must be a deterministic function of its input: the
    acceptance rule takes the proposal as a point mass. ``kind`` names it
    to the controller; a ``stateful`` drafter takes the batcher's
    per-request ``ctx`` in ``propose`` and gets ``begin``/``forget``
    calls; a ``needs_hidden`` drafter drafts a whole batch from the
    engine's hidden states (``propose_batch``)."""

    kind = "custom"
    stateful = False
    needs_hidden = False

    def propose(self, history: np.ndarray, n: int) -> np.ndarray:
        """Exactly ``n`` int32 tokens to follow ``history`` (the slot's
        prompt and generated tokens, its unwritten last token included).
        A bad guess costs only rejected verify columns, so there is no
        "no proposal"."""
        raise NotImplementedError

    def begin(self, ctx) -> None:
        """The request keyed ``ctx`` was admitted."""

    def forget(self, ctx) -> None:
        """The request keyed ``ctx`` finished."""


class NgramDrafter(Drafter):
    """Prompt-lookup drafting: match the longest suffix n-gram (``ngram``
    down to 1 tokens) of the history against its earlier occurrences and
    propose the ``n`` tokens after the most recent match, cycled out to
    ``n`` (a match near the end repeats the loop it found). No match at
    any length repeats the last token. ``window`` > 0 ignores matches
    whose gram ends more than ``window`` tokens back.

    ``propose(h, n)`` scans the whole history (the reference);
    ``propose(h, n, ctx=key)`` extends a per-request index of every
    k-gram's most recent end by the tokens appended since the last call
    and answers from it. A history shorter than the index (a slot reused
    without ``begin``) rebuilds it."""

    kind = "ngram"
    stateful = True

    def __init__(self, ngram: int = 3, window: int = 0):
        if ngram < 1:
            raise ValueError("ngram must be >= 1")
        if window < 0:
            raise ValueError("window must be >= 0 (0 = unbounded)")
        self.ngram = int(ngram)
        self.window = int(window)
        self._idx: dict = {}  # ctx -> {"done": int, "maps": [dict] * ngram}

    def begin(self, ctx) -> None:
        self._idx.pop(ctx, None)

    def forget(self, ctx) -> None:
        self._idx.pop(ctx, None)

    def _continuation(self, h: np.ndarray, end: int, n: int) -> np.ndarray:
        return np.resize(h[end + 1:], n).astype(np.int32)

    def _min_end(self, L: int) -> int:
        """The earliest gram end the window admits."""
        return 0 if self.window <= 0 else max(0, L - 1 - self.window)

    def propose(self, history: np.ndarray, n: int,
                ctx=None) -> np.ndarray:
        h = np.asarray(history, np.int32).reshape(-1)
        if n < 1:
            return np.zeros(0, np.int32)
        if h.size < 2:
            return np.full(n, h[-1] if h.size else 0, np.int32)
        if ctx is not None:
            return self._propose_indexed(h, n, ctx)
        return self._propose_scan(h, n)

    def _propose_scan(self, h: np.ndarray, n: int) -> np.ndarray:
        lo = self._min_end(h.size)
        for k in range(min(self.ngram, h.size - 1), 0, -1):
            # starts i with i + k <= len - 1: a match needs a continuation
            windows = np.lib.stride_tricks.sliding_window_view(
                h[: h.size - 1], k)
            hits = np.flatnonzero((windows == h[-k:]).all(axis=1))
            hits = hits[hits + k - 1 >= lo]
            if hits.size:
                return self._continuation(h, int(hits[-1]) + k - 1, n)
        return np.full(n, h[-1], np.int32)

    def _propose_indexed(self, h: np.ndarray, n: int, ctx) -> np.ndarray:
        st = self._idx.get(ctx)
        if st is None or st["done"] > h.size - 1:
            st = {"done": 0, "maps": [dict() for _ in range(self.ngram)]}
            self._idx[ctx] = st
        maps = st["maps"]
        # gram ends e in [done, len - 2]; the end len - 1 is the query
        # itself, indexed on the next call once it has a continuation
        base = max(0, st["done"] - self.ngram + 1)
        tail = h[base:].tolist()
        for e in range(st["done"], h.size - 1):
            for k in range(1, min(self.ngram, e + 1) + 1):
                maps[k - 1][tuple(tail[e - k + 1 - base: e + 1 - base])] = e
        st["done"] = h.size - 1
        lo = self._min_end(h.size)
        for k in range(min(self.ngram, h.size - 1), 0, -1):
            e = maps[k - 1].get(tuple(tail[h.size - k - base:]))
            if e is not None and e >= lo:
                return self._continuation(h, e, n)
        return np.full(n, h[-1], np.int32)


class LearnedDrafter(Drafter):
    """EAGLE-style drafting from the target's own last hidden state: the
    engine's ``return_hidden`` keeps each slot's state before the final
    norm, and one pass (``engine.make_draft_program``) runs ``spec_len``
    greedy steps of a pseudo-hidden state through the shared embedding,
    final norm and LM head. ``head`` is an optional ``{"w": [2H, H]}``
    (``init_draft_head``); without it the merge is ``hidden +
    embed(token)``, which needs no weights beyond the target's. Either way
    the proposal is a deterministic function of (hidden, token)."""

    kind = "learned"
    needs_hidden = True

    def __init__(self, engine, params, head: Optional[dict] = None):
        if engine.spec_len < 1:
            raise ValueError(
                "LearnedDrafter needs a speculative engine (spec_len > 0)")
        if not engine.return_hidden:
            raise ValueError(
                "LearnedDrafter needs the engine's last-hidden-state hook"
                " — build the engine with inference.drafter: 'learned' "
                "(or return_hidden=True)")
        self.engine = engine
        self.params = params
        self.head = head
        self._program = engine.make_draft_program(with_head=head is not None)

    def propose_batch(self, tokens, hidden: torch.Tensor,
                      n: int) -> np.ndarray:
        """Draft ``n`` (= the engine's ``spec_len``) tokens for every slot:
        ``tokens`` [B] each slot's current last token (host ints or a
        tensor), ``hidden`` [B, H] the engine's hidden rows. Returns host
        int32 [B, n]; ragged lengths are the verify mask's business."""
        if n != self.engine.spec_len:
            raise ValueError(
                f"the draft program proposes exactly spec_len = "
                f"{self.engine.spec_len} tokens per slot, got n = {n} "
                f"(slice the per-slot prefix you need)")
        toks = torch.as_tensor(np.asarray(tokens, np.int32)).to(
            hidden.device)
        head = (self.head,) if self.head is not None else ()
        return self._program(self.params, *head, hidden,
                             toks).cpu().numpy().astype(np.int32)

    def propose(self, history, n, ctx=None):
        raise TypeError(
            "LearnedDrafter drafts per batch from device hidden states "
            "(propose_batch); per-slot host proposal is the n-gram "
            "drafter's path")


def init_draft_head(generator: torch.Generator, hidden_size: int,
                    dtype=torch.float32, device=None) -> dict:
    """A random head for ``LearnedDrafter``: one [2H, H] merge matrix,
    U(-1/sqrt(2H), 1/sqrt(2H)), drawn from ``generator``."""
    bound = 1.0 / np.sqrt(2.0 * hidden_size)
    w = torch.rand((2 * hidden_size, hidden_size), generator=generator,
                   dtype=torch.float32, device=device)
    return {"w": ((2.0 * w - 1.0) * bound).to(dtype)}


class DispatchLatency:
    """Wall time of the batcher's dispatches by kind ("verify", "decode",
    "draft"): a sum and a count, as the JAX controller reads them from
    ``picotron_dispatch_seconds``."""

    def __init__(self):
        self._sum: dict = {}
        self._count: dict = {}

    def observe(self, kind: str, seconds: float) -> None:
        self._sum[kind] = self._sum.get(kind, 0.0) + float(seconds)
        self._count[kind] = self._count.get(kind, 0) + 1

    def count(self, kind: str) -> int:
        return self._count.get(kind, 0)

    def mean(self, kind: str, min_samples: int = 1) -> Optional[float]:
        """The mean seconds of ``kind``, or None under ``min_samples``."""
        n = self._count.get(kind, 0)
        if n < max(1, min_samples):
            return None
        return self._sum[kind] / n


class SpecController:
    """The per-slot speculation policy (the JAX package's
    ``SpecController``), one decision a slot a round:

    - a slot re-evaluates once it has proposed ``window`` draft tokens
      since its last evaluation;
    - the window's accept rate r picks a direction: r >= ``target`` up
      (double toward ``max_spec_len``), r < ``low`` down (halve), else
      hold;
    - once ``latency`` holds ``latency_min_samples`` verify and decode
      dispatches, speculation must also pay: (1 + r g) tokens per verify
      (plus draft) against ``block_len`` per decode block, or the
      direction is forced down, and a ramp up that would not pay is held;
    - a ramp applies after ``hysteresis`` consecutive evaluations agree;
    - at draft length 1 a losing slot first switches to a drafter it has
      not tried since its reset, then turns off (0); an off slot probes
      with 1 token after ``cooloff`` rounds;
    - a slot whose request has a TPOT SLO halves its length each round
      the measured verify + draft time exceeds it (``slo_cap``), and
      starts at 1 when it already does.

    ``decisions`` counts each action. When every occupied slot is off the
    batcher runs a decode block instead of a verify."""

    def __init__(self, cfg, latency: DispatchLatency, *, slots: int,
                 max_spec_len: int, block_len: int, kinds=("ngram",)):
        if max_spec_len < 1:
            raise ValueError("SpecController needs max_spec_len >= 1")
        if not kinds:
            raise ValueError("SpecController needs at least one drafter")
        self.cfg = cfg
        self.latency = latency
        self.slots = int(slots)
        self.gmax = int(max_spec_len)
        self.block_len = int(block_len)
        self.kinds = tuple(kinds)
        self._decisions: dict = {}
        self._g = [self.gmax] * self.slots
        self._kind = [self.kinds[0]] * self.slots
        self._streak = [0] * self.slots
        self._idle = [0] * self.slots
        self._tried: list = [{self.kinds[0]} for _ in range(self.slots)]
        self._snap = [(0.0, 0.0)] * self.slots  # counts at the last eval
        self._slo: list = [None] * self.slots  # TPOT SLO, seconds
        self._counts = [(0.0, 0.0)] * self.slots  # (proposed, accepted)

    def record(self, slot: int, proposed: int, accepted: int) -> None:
        """One round's draft counts of ``slot``."""
        p, a = self._counts[slot]
        self._counts[slot] = (p + proposed, a + accepted)

    def _mean_latency(self, kind: str) -> Optional[float]:
        return self.latency.mean(kind, self.cfg.latency_min_samples)

    def _pays(self, g: int, r: float) -> Optional[bool]:
        """Whether drafting ``g`` at accept rate ``r`` beats a decode
        block on the measured latencies; None until both kinds have
        enough samples."""
        c_v = self._mean_latency("verify")
        c_d = self._mean_latency("decode")
        if c_v is None or c_d is None:
            return None
        c_draft = self._mean_latency("draft") or 0.0
        return (1.0 + r * g) * c_d > self.block_len * (c_v + c_draft)

    def _decide(self, action: str) -> None:
        self._decisions[action] = self._decisions.get(action, 0) + 1

    @property
    def decisions(self) -> dict:
        """{action: count} over the controller's life."""
        return dict(self._decisions)

    def reset(self, slot: int, tpot_slo_s: Optional[float] = None) -> None:
        """A new request took ``slot``: the full draft (1 if its TPOT SLO
        is already missed), the first drafter, clean counts."""
        self._slo[slot] = tpot_slo_s
        self._g[slot] = self.gmax
        if tpot_slo_s is not None and self._over_slo(slot):
            self._g[slot] = 1
        self._kind[slot] = self.kinds[0]
        self._streak[slot] = 0
        self._idle[slot] = 0
        self._tried[slot] = {self.kinds[0]}
        self._snap[slot] = self._counts[slot]

    def _over_slo(self, slot: int) -> bool:
        """Whether the measured verify (+ draft) time exceeds the slot's
        TPOT SLO; False without an SLO or enough samples."""
        slo = self._slo[slot]
        if slo is None:
            return False
        c_v = self._mean_latency("verify")
        if c_v is None:
            return False
        return c_v + (self._mean_latency("draft") or 0.0) > slo

    def lens(self) -> np.ndarray:
        """Each slot's draft length for the next round [slots] int32."""
        return np.asarray(self._g, np.int32)

    def drafter_kinds(self) -> list:
        """Each slot's drafter kind for the next round."""
        return list(self._kind)

    def spec_len_mean(self, occupied) -> float:
        """Mean draft length over the ``occupied`` slots."""
        occ = list(occupied)
        if not occ:
            return 0.0
        return float(np.mean([self._g[i] for i in occ]))

    def after_round(self, slot: int) -> None:
        """``slot`` took part in one round (a verify or a decode block):
        advance its cooloff clock, apply the SLO cap, and evaluate once
        its window has filled."""
        g = self._g[slot]
        if g == 0:
            self._idle[slot] += 1
            if self.cfg.cooloff and self._idle[slot] >= self.cfg.cooloff:
                self._g[slot] = 1
                self._idle[slot] = 0
                self._streak[slot] = 0
                self._tried[slot] = {self._kind[slot]}
                self._snap[slot] = self._counts[slot]
                self._decide("probe")
            return
        if g > 1 and self._over_slo(slot):
            self._g[slot] = g // 2
            self._streak[slot] = 0
            self._decide("slo_cap")
            return
        prop, acc = self._counts[slot]
        sprop, sacc = self._snap[slot]
        if prop - sprop < self.cfg.window:
            return
        r = (acc - sacc) / max(prop - sprop, 1.0)
        self._snap[slot] = (prop, acc)
        direction = (1 if r >= self.cfg.target
                     else -1 if r < self.cfg.low else 0)
        pays = self._pays(g, r)
        if pays is not None:
            if direction > 0 and not self._pays(min(2 * g, self.gmax), r):
                direction = 0
            if not pays:
                direction = -1
        if direction == 0:
            self._streak[slot] = 0
            return
        streak = self._streak[slot]
        streak = streak + direction if streak * direction > 0 else direction
        self._streak[slot] = streak
        if abs(streak) < self.cfg.hysteresis:
            return
        self._streak[slot] = 0
        if direction > 0:
            new_g = min(max(1, 2 * g), self.gmax)
            if new_g != g:
                self._g[slot] = new_g
                self._decide("ramp_up")
            return
        if g > 1:
            self._g[slot] = g // 2
            self._decide("ramp_down")
            return
        untried = [k for k in self.kinds if k not in self._tried[slot]]
        if untried:
            self._kind[slot] = untried[0]
            self._tried[slot].add(untried[0])
            self._snap[slot] = self._counts[slot]
            self._decide("switch_drafter")
            return
        self._g[slot] = 0
        self._idle[slot] = 0
        self._decide("spec_off")
