"""Deterministic, config-driven fault injection for the serving stack.

Port of ``ServingChaos`` of ``picotron_tpu/resilience/chaos.py``: the
engine's dispatch hooks (``InferenceEngine(..., hooks=ServingChaos(r))``)
keyed to decode and verify dispatches, so that each recovery path of the
batcher has a reproducible trigger: a dispatch exception (the retry), a
slot whose every dispatch fails (the per-slot isolation), a latency spike
and NaN logits (the samplers' non-finite gate).
"""

from __future__ import annotations

import time

from picotron_tpu_torch.utils import log0


class ChaosError(RuntimeError):
    """An injected fault."""


class ServingChaos:
    """Fault injection for serving, installed as an engine's dispatch hooks.

    Rounds are 1-indexed decode or verify dispatches (prefill dispatches
    pass through), and every dispatch the engine attempts counts, the
    batcher's retries and per-slot isolation re-dispatches included: so
    ``chaos_dispatch_raise_round`` fires once and the retry lands, while
    ``chaos_dispatch_fail_slot`` fails every dispatch in which that slot
    is active, so only its own solo re-dispatch keeps failing.

    - ``chaos_dispatch_raise_round``: raise ``ChaosError`` before round N
      (once);
    - ``chaos_dispatch_fail_slot``: raise whenever this slot is active
      (every time; -1 = off);
    - ``chaos_latency_round``: sleep ``chaos_latency_s`` before round N
      (once);
    - ``chaos_poison_logits_round``: round N's dispatch runs with NaN
      logits (once).
    """

    def __init__(self, r, sleep=time.sleep):
        self.dispatch_raise_round = int(r.chaos_dispatch_raise_round)
        self.fail_slot = int(r.chaos_dispatch_fail_slot)
        self.latency_round = int(r.chaos_latency_round)
        self.latency_s = float(r.chaos_latency_s)
        self.poison_round = int(r.chaos_poison_logits_round)
        self._sleep = sleep  # injectable so tests do not wait
        self.round = 0  # decode and verify dispatches seen so far
        self._fired: set = set()

    @property
    def active(self) -> bool:
        return (self.fail_slot >= 0
                or any(s > 0 for s in (self.dispatch_raise_round,
                                       self.latency_round,
                                       self.poison_round)))

    def _fire_once(self, event: str, at: int) -> bool:
        if at > 0 and self.round == at and event not in self._fired:
            self._fired.add(event)
            return True
        return False

    def before_dispatch(self, kind: str, slots: list) -> None:
        """Engine hook, called before every dispatch with the active slot
        indices. The latency fires before the exceptions (a spike, then a
        failure)."""
        if kind not in ("decode", "verify"):
            return
        self.round += 1
        if self._fire_once("latency", self.latency_round):
            log0(f"chaos: {self.latency_s}s latency spike before dispatch "
                 f"round {self.round}")
            self._sleep(self.latency_s)
        if self.fail_slot >= 0 and self.fail_slot in slots:
            raise ChaosError(
                f"chaos: persistent dispatch fault (slot {self.fail_slot} "
                f"active, round {self.round})")
        if self._fire_once("raise", self.dispatch_raise_round):
            raise ChaosError(
                f"chaos: injected dispatch exception at round {self.round}")

    def poison_logits(self, kind: str) -> bool:
        """Engine hook: whether this dispatch (the round ``before_dispatch``
        just opened) runs with NaN logits. Consumes the event."""
        if kind not in ("decode", "verify"):
            return False
        if self._fire_once("poison", self.poison_round):
            log0(f"chaos: poisoning dispatch round {self.round} logits")
            return True
        return False
