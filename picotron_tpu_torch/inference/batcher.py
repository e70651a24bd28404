"""Continuous batching: admit and retire variable-length requests into
the engine's fixed slots.

Port of the serial scheduler of ``picotron_tpu/inference/batcher.py``.
Each ``step()``:

  admit:  while a slot is free and requests wait, prefill the next prompt
          (the pow-2-bucketed one-shot prefill at or under
          ``engine.prefill_chunk`` tokens, chunked straight into the slot
          above it) and sample its first token from the prefill logits;
  decode: one ``decode_block`` advances every occupied slot by up to
          ``engine.decode_block_len`` tokens, with per-slot sampling
          parameters, EOS ids and budgets, and the stop state on the
          device;
  retire: slots that hit EOS or their budget release their cache slot.

Free slots still ride through the decode block (fixed shapes); they carry
a zero budget at length 0 and their outputs are ignored. One
``torch.Generator`` seeded from ``seed`` draws every sampled token.

Not ported yet: request deadlines, dispatch retry and slot isolation,
priorities and tenancy, speculation, overlap and the mixed prefill lane.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from picotron_tpu_torch.inference import sampling
from picotron_tpu_torch.inference.kv_cache import cache_bytes
from picotron_tpu_torch.models.llama import param_bytes


@dataclass
class Request:
    """One generation request. ``temperature == 0`` = greedy; ``top_k <= 0``
    and ``top_p >= 1`` disable those filters."""

    uid: str
    prompt: list
    max_new_tokens: int = 32
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    eos_id: Optional[int] = None


@dataclass
class GenerationResult:
    uid: str
    prompt: list
    tokens: list  # generated ids, EOS included when hit
    finish_reason: str  # "eos" | "length"
    queue_wait_s: Optional[float] = None  # submit -> admit
    ttft_s: Optional[float] = None  # submit -> first token
    dispatches: int = 0  # decode blocks this request's slot took part in


@dataclass
class _Slot:
    req: Request
    generated: list = field(default_factory=list)
    submit_t: Optional[float] = None
    queue_wait_s: Optional[float] = None
    ttft_s: Optional[float] = None
    dispatches: int = 0


class ContinuousBatcher:
    """Drive an InferenceEngine over a stream of requests.

    >>> b = ContinuousBatcher(engine, params)
    >>> b.submit(Request("a", [1, 2, 3], max_new_tokens=16))
    >>> results = b.run()           # {"a": GenerationResult(...)}

    ``params`` must live on the engine's device. One batcher owns one
    cache.
    """

    def __init__(self, engine, params, seed: int = 0, clock=time.monotonic):
        self.engine = engine
        self.params = params
        self._clock = clock
        self._gen = torch.Generator(device=engine.device).manual_seed(seed)
        self._cache = engine.init_cache()
        n = engine.slots
        self._slots: list = [None] * n
        self._pending: deque = deque()
        self._results: dict = {}
        self._submit_t: dict = {}
        self._last_tok = np.zeros(n, np.int32)
        self._temp = np.zeros(n, np.float32)
        self._top_k = np.zeros(n, np.int32)
        self._top_p = np.ones(n, np.float32)
        self._eos = np.full(n, -1, np.int32)
        self._budget = np.zeros(n, np.int32)
        # lifetime counters (bench + tests)
        self.decode_dispatches = 0
        self.prefill_dispatches = 0
        self.generated_tokens = 0
        # host wall time of decode blocks, results read back included
        self.decode_seconds = 0.0

    # ---- queue surface ----------------------------------------------------

    def submit(self, req: Request) -> None:
        if not req.prompt:
            raise ValueError(f"request {req.uid!r}: empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError(
                f"request {req.uid!r}: max_new_tokens must be >= 1 "
                f"(got {req.max_new_tokens})")
        if (req.uid in self._submit_t or req.uid in self._results
                or any(s is not None and s.req.uid == req.uid
                       for s in self._slots)):
            raise ValueError(
                f"request {req.uid!r}: duplicate uid (queued, in flight, "
                f"or finished with an untaken result)")
        if self.engine.max_seq_len - len(req.prompt) < 1:
            raise ValueError(
                f"request {req.uid!r}: prompt of {len(req.prompt)} tokens "
                f"leaves no room to generate under max_seq_len "
                f"{self.engine.max_seq_len}")
        self._submit_t[req.uid] = self._clock()
        self._pending.append(req)

    @property
    def busy(self) -> bool:
        return bool(self._pending) or any(s is not None for s in self._slots)

    def stats(self) -> dict:
        """Serving counters (the JAX batcher's ``/statz`` fields that the
        port has), with the resident bytes of the weights and the cache
        that int8 storage shrinks."""
        return {
            "decode_dispatches": self.decode_dispatches,
            "prefill_dispatches": self.prefill_dispatches,
            "generated_tokens": self.generated_tokens,
            "queued": len(self._pending),
            "active_slots": sum(s is not None for s in self._slots),
            "slots": len(self._slots),
            "weight_dtype": self.engine.weight_dtype,
            "weight_bytes": param_bytes(self.params),
            "kv_cache_dtype": str(self.engine.cache_dtype).removeprefix(
                "torch."),
            "cache_bytes": cache_bytes(self._cache),
        }

    def take_results(self) -> dict:
        """Finished results since the last call: {uid: GenerationResult}."""
        out, self._results = self._results, {}
        return out

    def run(self, requests=None) -> dict:
        """Submit ``requests`` (optional) and step until every submitted
        request has finished. Returns {uid: GenerationResult}."""
        for r in requests or ():
            self.submit(r)
        while self.busy:
            self.step()
        return self.take_results()

    # ---- one scheduler round ----------------------------------------------

    def _finish(self, i: int, reason: str) -> None:
        s = self._slots[i]
        self._results[s.req.uid] = GenerationResult(
            s.req.uid, list(s.req.prompt), list(s.generated), reason,
            queue_wait_s=s.queue_wait_s, ttft_s=s.ttft_s,
            dispatches=s.dispatches)
        self._slots[i] = None
        self._cache = self.engine.release(self._cache, i)
        self._last_tok[i] = 0
        self._temp[i] = 0.0
        self._top_k[i] = 0
        self._top_p[i] = 1.0
        self._eos[i] = -1
        self._budget[i] = 0

    def _remaining(self, i: int) -> int:
        """Tokens slot i may still produce: its budget capped by the
        sequence window."""
        s = self._slots[i]
        cap = min(s.req.max_new_tokens,
                  self.engine.max_seq_len - len(s.req.prompt))
        return max(cap - len(s.generated), 0)

    def _token_done(self, i: int, tok: int) -> None:
        """Record one generated token for slot i; retire on EOS/budget."""
        s = self._slots[i]
        s.generated.append(tok)
        self.generated_tokens += 1
        if s.ttft_s is None and s.submit_t is not None:
            s.ttft_s = self._clock() - s.submit_t
        r = s.req
        if r.eos_id is not None and tok == r.eos_id:
            self._finish(i, "eos")
        elif (len(s.generated) >= r.max_new_tokens
              or len(r.prompt) + len(s.generated) >= self.engine.max_seq_len):
            self._finish(i, "length")
        else:
            self._last_tok[i] = tok

    def _prefill_into(self, req: Request, i: int) -> torch.Tensor:
        """Prefill ``req`` into slot ``i`` (one-shot or chunked); return its
        last-token logits [1, V]."""
        eng = self.engine
        if len(req.prompt) > eng.prefill_chunk:
            self._cache, logits = eng.prefill_chunked(
                self.params, self._cache, req.prompt, i)
            self.prefill_dispatches += -(-len(req.prompt) // eng.prefill_chunk)
            return logits
        kv, logits = eng.prefill(self.params, req.prompt)
        self._cache = eng.insert(self._cache, kv, i, len(req.prompt))
        self.prefill_dispatches += 1
        return logits

    def _admit(self) -> None:
        dev = self.engine.device
        for i in range(len(self._slots)):
            if self._slots[i] is not None:
                continue
            if not self._pending:
                return
            req = self._pending.popleft()
            submit_t = self._submit_t.pop(req.uid, None)
            logits = self._prefill_into(req, i)
            slot = _Slot(req, submit_t=submit_t)
            if submit_t is not None:
                slot.queue_wait_s = self._clock() - submit_t
            self._slots[i] = slot
            self._temp[i] = req.temperature
            self._top_k[i] = req.top_k
            self._top_p[i] = req.top_p
            self._eos[i] = req.eos_id if req.eos_id is not None else -1
            first = sampling.sample(
                logits, self._gen,
                torch.tensor([req.temperature], dtype=torch.float32,
                             device=dev),
                torch.tensor([req.top_k], dtype=torch.int32, device=dev),
                torch.tensor([req.top_p], dtype=torch.float32, device=dev))
            self._token_done(i, int(first[0]))

    def step(self) -> None:
        """Admit waiting requests into free slots, then advance every
        occupied slot by one decode block and retire the finished ones."""
        self._admit()
        if not any(s is not None for s in self._slots):
            return
        for i, s in enumerate(self._slots):
            self._budget[i] = self._remaining(i) if s is not None else 0
        budget = self._budget.copy()
        t0 = self._clock()
        self._cache, toks, counts = self.engine.decode_block(
            self.params, self._cache, self._last_tok, self._gen, self._eos,
            budget, self._temp, self._top_k, self._top_p)
        toks, counts = toks.cpu().numpy(), counts.cpu().numpy()
        self.decode_seconds += self._clock() - t0
        self.decode_dispatches += 1
        for i, s in enumerate(self._slots):
            if s is None:
                continue
            if budget[i] > 0:
                s.dispatches += 1
            # the device already stopped this row at EOS/budget; walking
            # the produced prefix applies the same rules host-side
            for t in toks[i, : counts[i]]:
                if self._slots[i] is None:
                    break
                self._token_done(i, int(t))
