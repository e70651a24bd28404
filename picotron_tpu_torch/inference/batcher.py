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

Admission picks the highest priority class first, FIFO within a class,
and a request with a TTFT SLO ahead of its class's best-effort peers
(``_pick``). When a live slot carries a TPOT SLO, a round admits at most
one ``prefill_chunk`` of prompt tokens, unless a waiting request has spent
half its TTFT budget (``_prefill_gate``). On an engine with an adapter
pack each request runs under its ``adapter_slot`` (prefill and every
decode block, one id per slot), and on the paged layout its tenant salts
the radix prefix cache. ``stats()["tenants"]`` tallies each tenant's
requests, tokens and deferrals; ``shed_lower_priority`` and the tenant
loads are the admission gate's levers.

On the paged layout (``engine.paged``) admission prices each request in
pool pages (``page_commitment``): a request that could never fit the pool
is shed at the door (finish reason "shed", no tokens), and under passing
pressure the queue waits for live slots to return pages; the prefill is
``engine.prefill_paged``, which shares the longest cached prompt prefix.

Free slots still ride through the decode block (fixed shapes); they carry
a zero budget at length 0 and their outputs are ignored. One
``torch.Generator`` seeded from ``seed`` draws every sampled token.

Not ported yet: request deadlines, dispatch retry and slot isolation,
speculation, overlap, the mixed prefill lane and the ``picotron_tenant_*``
metric families.
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
    # ---- multi-tenant serving (inference/tenancy.py) ----------------------
    # tenant name ("" = anonymous base traffic: the null adapter, the
    # default radix domain, class-1 priority, no SLOs)
    tenant: str = ""
    # admission class: higher classes admit first; the lowest queued class
    # sheds first (shed_lower_priority)
    priority: int = 1
    # the tenant's adapter pack slot (0 = the reserved null adapter)
    adapter_slot: int = 0
    # SLO targets in milliseconds (None = best-effort): ttft steers
    # admission order and the prefill gate's preemption; tpot caps the
    # prompt tokens a round admits while the request decodes
    ttft_slo_ms: Optional[float] = None
    tpot_slo_ms: Optional[float] = None


@dataclass
class GenerationResult:
    uid: str
    prompt: list
    tokens: list  # generated ids, EOS included when hit
    finish_reason: str  # "eos" | "length" | "shed"
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
        # per-slot adapter pack slots, one row per decode block on an
        # engine with a pack; 0 (the null adapter) for free and base slots
        self._adapter = np.zeros(n, np.int32)
        # per-tenant host tally (stats()["tenants"])
        self._tenant_stats: dict = {}
        # prompt tokens admitted this scheduler round (_prefill_gate)
        self._round_prefill_tokens = 0
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

    # ---- paged admission pricing ------------------------------------------

    @property
    def paged(self):
        """The engine's host page allocator (None on the contiguous
        layout)."""
        return self.engine.paged

    def commitment(self, req: Request) -> int:
        """Worst-case tokens ``req`` can hold: its prompt plus what it may
        still generate under the window."""
        return len(req.prompt) + max(0, min(
            req.max_new_tokens, self.engine.max_seq_len - len(req.prompt)))

    def page_commitment(self, req: Request) -> int:
        """Worst-case pool pages ``req`` can occupy: its commitment plus the
        one row a stopped slot keeps rewriting, in pages, at most a slot's
        window. Prefix hits only make the real footprint smaller."""
        return min(self.paged.pages_for(self.commitment(req) + 1),
                   self.paged.max_pages)

    def page_load(self) -> int:
        """Worst-case page commitment of every queued and live request."""
        load = sum(self.page_commitment(r) for r in self._pending)
        for s in self._slots:
            if s is not None:
                load += self.page_commitment(s.req)
        return load

    # ---- multi-tenant accounting ------------------------------------------

    def _tstat(self, req: Request) -> dict:
        """The tally of ``req``'s tenant ("" counts as "base")."""
        name = req.tenant or "base"
        st = self._tenant_stats.get(name)
        if st is None:
            st = {"requests": 0, "tokens": 0, "shed": 0,
                  "prefill_deferred": 0, "prefill_preempts": 0}
            self._tenant_stats[name] = st
        return st

    def _tenant_requests(self, tenant: str) -> list:
        """One tenant's queued and live requests."""
        live = [s.req for s in self._slots if s is not None]
        return [r for r in [*self._pending, *live]
                if (r.tenant or "") == tenant]

    def tenant_token_load(self, tenant: str) -> int:
        """Worst-case token commitment of one tenant's queued and live
        requests: the per-tenant quota's price."""
        return sum(self.commitment(r) for r in self._tenant_requests(tenant))

    def tenant_page_load(self, tenant: str) -> int:
        """Worst-case page commitment of one tenant's queued and live
        requests (paged layout; 0 on contiguous)."""
        if self.paged is None:
            return 0
        return sum(self.page_commitment(r)
                   for r in self._tenant_requests(tenant))

    def shed_lower_priority(self, priority: int, tokens: int = 0,
                            pages: int = 0) -> tuple:
        """Shed QUEUED requests of a class strictly below ``priority``
        (lowest class first, newest first within a class) until the freed
        worst-case commitment covers ``tokens`` and ``pages`` (0 = no
        demand on that budget) or no lower-class request remains. Returns
        (tokens_freed, pages_freed)."""
        freed_t = freed_p = 0
        while freed_t < tokens or freed_p < pages:
            best = None
            for j, r in enumerate(self._pending):
                if r.priority >= priority:
                    continue
                # <= keeps the LATEST of the lowest class: the request
                # that waited least loses first
                if (best is None
                        or r.priority <= self._pending[best].priority):
                    best = j
            if best is None:
                break
            req = self._pending[best]
            freed_t += self.commitment(req)
            if self.paged is not None:
                freed_p += self.page_commitment(req)
            del self._pending[best]
            self._shed(req)
        return freed_t, freed_p

    def _shed(self, req: Request) -> None:
        """Finish a queued request unstarted (reason "shed", no tokens)."""
        self._submit_t.pop(req.uid, None)
        self._tstat(req)["shed"] += 1
        self._results[req.uid] = GenerationResult(
            req.uid, list(req.prompt), [], "shed")

    def stats(self) -> dict:
        """Serving counters (the JAX batcher's ``/statz`` fields that the
        port has), with the resident bytes of the weights and the cache
        that int8 storage shrinks; on the paged layout, the pool's
        occupancy and the prefix cache's counters too; with tenants, each
        tenant's tally under ``"tenants"`` (requests admitted, tokens
        emitted, requests shed, admissions the prefill gate deferred or
        let through on TTFT pressure)."""
        d = {
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
        if self.paged is not None:
            d.update(self.paged.stats())
        if self._tenant_stats:
            d["tenants"] = {name: dict(st)
                            for name, st in self._tenant_stats.items()}
        return d

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
        self._adapter[i] = 0

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
        self._tstat(s.req)["tokens"] += 1
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
        """Prefill ``req`` into slot ``i`` (one-shot or chunked) under its
        adapter slot; return its last-token logits [1, V]."""
        eng = self.engine
        # an engine without a pack takes no ids and runs as without tenancy
        adapter = (int(req.adapter_slot) if eng.adapters is not None
                   else None)
        if self.paged is not None:
            self.paged.priced[i] = self.page_commitment(req)
            self._cache, logits, n, _ = eng.prefill_paged(
                self.params, self._cache, req.prompt, i, adapter_id=adapter,
                cache_salt=req.tenant)
            self.prefill_dispatches += n
            return logits
        if len(req.prompt) > eng.prefill_chunk:
            self._cache, logits = eng.prefill_chunked(
                self.params, self._cache, req.prompt, i, adapter_id=adapter)
            self.prefill_dispatches += -(-len(req.prompt) // eng.prefill_chunk)
            return logits
        kv, logits = eng.prefill(self.params, req.prompt, adapter_id=adapter)
        self._cache = eng.insert(self._cache, kv, i, len(req.prompt))
        self.prefill_dispatches += 1
        return logits

    def _admit(self) -> None:
        dev = self.engine.device
        self._round_prefill_tokens = 0
        for i in range(len(self._slots)):
            if self._slots[i] is not None:
                continue
            req = self._next_admissible()
            if req is None:
                return
            submit_t = self._submit_t.pop(req.uid, None)
            logits = self._prefill_into(req, i)
            self._round_prefill_tokens += len(req.prompt)
            self._tstat(req)["requests"] += 1
            slot = _Slot(req, submit_t=submit_t)
            if submit_t is not None:
                slot.queue_wait_s = self._clock() - submit_t
            self._slots[i] = slot
            self._adapter[i] = (req.adapter_slot
                                if self.engine.adapters is not None else 0)
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

    def _pick(self) -> int:
        """Index of the next admission candidate in the queue: the highest
        priority class first, FIFO within a class, except that a request
        with a TTFT SLO jumps ahead of best-effort peers of its own class
        (its clock is already running; theirs is not)."""
        best = 0
        for j in range(1, len(self._pending)):
            r, b = self._pending[j], self._pending[best]
            if r.priority > b.priority:
                best = j
            elif (r.priority == b.priority and b.ttft_slo_ms is None
                  and r.ttft_slo_ms is not None):
                best = j
        return best

    def _prefill_gate(self, req: Request) -> bool:
        """Whether ``req`` may prefill this round. While a live slot carries
        a TPOT SLO, a round admits at most one ``prefill_chunk`` of prompt
        tokens (its prefill stalls every decoder behind it); the first
        admission of a round always passes. A request that has spent half
        its TTFT budget waiting preempts the cap. Both decisions are
        tallied per tenant."""
        if self._round_prefill_tokens == 0:
            return True
        if not any(s is not None and s.req.tpot_slo_ms is not None
                   for s in self._slots):
            return True
        if req.ttft_slo_ms is not None:
            t0 = self._submit_t.get(req.uid)
            if (t0 is not None and (self._clock() - t0) * 1000.0
                    >= req.ttft_slo_ms / 2.0):
                self._tstat(req)["prefill_preempts"] += 1
                return True
        if (self._round_prefill_tokens + len(req.prompt)
                <= self.engine.prefill_chunk):
            return True
        self._tstat(req)["prefill_deferred"] += 1
        return False

    def _next_admissible(self):
        """Take the next request to admit (``_pick``), or None to stop
        admitting this round. Paged: a request that can never fit the pool
        is shed here; one that does not fit now waits, since admitting it
        could strand a live slot mid-decode. A request the prefill gate
        defers waits for the next round."""
        while self._pending:
            j = self._pick()
            req = self._pending[j]
            if self.paged is not None:
                need = self.page_commitment(req)
                if need > self.paged.usable_pages:
                    del self._pending[j]
                    self._shed(req)
                    continue
                if not self.paged.can_admit(need):
                    return None
            if not self._prefill_gate(req):
                return None
            del self._pending[j]
            return req
        return None

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
            budget, self._temp, self._top_k, self._top_p,
            adapter_ids=(self._adapter if self.engine.adapters is not None
                         else None))
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
