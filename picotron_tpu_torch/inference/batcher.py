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
          device; on a speculative engine (``spec_len > 0``) one draft-
          verify round instead (``_spec_round``): the drafters propose,
          one ``engine.verify`` emits 1 to ``spec_len + 1`` tokens a slot;
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
A paged request with a handoff payload (``kv_import``, from a prefill
replica's ``export_prefix``) imports its pages first: when they cover the
whole prompt and carry the first token, the slot is seated from them with
no prefill dispatch (``handoff_seated``); otherwise the payload is a
prefix hint that the admission then hits. A payload the replica cannot
land is dropped and counted (``picotron_handoff_dropped_total``), and the
request prefills itself. ``export_prefix`` and ``import_prefix`` are the
serve front end's /kv plane.

Speculation: the drafter (``inference.drafter``: the prompt-lookup
``NgramDrafter``, or the ``LearnedDrafter`` over the engine's hidden rows
with the n-gram drafter beside it; or one passed in) proposes each
occupied slot's draft; with ``inference.spec_controller.enabled`` a
``SpecController`` sets each slot's draft length and drafter every round
from its accept counts and the dispatch latencies this batcher tallies
(``latency``), and when it has turned every occupied slot off the round
is a decode block. ``draft_proposed``, ``draft_accepted`` and
``accept_rate`` count the drafts.

Free slots still ride through the decode block (fixed shapes); they carry
a zero budget at length 0 and their outputs are ignored. Sampled tokens are
keyed by the engine's ``key_schedule``: on "round" one ``torch.Generator``
seeded from ``seed`` draws every sampled token in round order; on "slot"
each admission takes one ``prng.split`` of a ``PRNGKey(seed)`` chain as
its slot's base key, and the token at sequence index ``p`` is keyed
``fold_in(base, p - 1)`` (the first token from the prefill logits, the
rest in the dispatches), so a stream is the same at any
``decode_block_len`` and under speculation, and the JAX package's.

Faults: every dispatch (a prefill, a decode block, a verify) is retried
(``resilience.dispatch_attempts``, ``dispatch_backoff``). A prefill that
still fails finishes only its request (reason "error", no tokens). A round
that still fails is isolated: each occupied slot is dispatched alone, the
others' budgets masked to 0, from the state the group round started from
(the engine restores what a failed dispatch advanced, and the batcher
rewinds the generator before each solo dispatch), so the slots that
succeed alone emit the bits of a fault-free round and the ones that fail
alone finish "error". A failure whose state could not be restored
(``engine.CacheLost``) empties the cache: every occupied slot finishes
"error" and the queue is served on. A CUDA error that leaves the device
unusable is not retried: it raises out of ``step()``. A request with
``timeout_s`` finishes "timeout" once that long has passed since its
admission, at the start of a round, and its slot is refilled in the same
round.

The overlap pipeline (``inference.overlap``, ``_step_overlap``): each
step issues round N + 1 before it reads round N back, so delivery, finish
detection, drafting and admission run while the card executes. Issue
takes its input tokens from the device-held row ``_dev_last`` (the last
round's ``next_tok`` output, patched where a slot is seated), uploads
every host operand through pinned buffers and queues the round's
read-back into pinned buffers behind an event: nothing at issue waits
for the card, and the sync stage waits on that event alone. What the host
sees is a round stale: budgets may overshoot (the device stops at EOS and
budget itself, and the walk cuts at the host's rules), drafts guess from
the round before (the slot schedule's sample-and-match makes the emitted
stream independent of them), and a slot that finishes while a round is in
flight bumps its seat epoch, so the sync drops that round's rows
(exactly-once delivery). A host fault at issue drains the pipeline and
reruns the round through the serial recovery (``_round_fallback``); a
fault on the card first shows at the sync and, as a lost device, raises
out of ``step()``. The paged host lengths advance at the sync
(``engine.defer_advance``).

The mixed prefill lane (``inference.mixed_dispatch``): a prompt longer
than one chunk, or a paged prompt with a radix hit, is seated at once as
a prefilling slot (budget 0) and fed one chunk a round through the decode
or verify dispatch (``_lane_feed``; the prefill gate's round budget is
the feed rate), and its first token lands with its final chunk
(``_lane_land``). A cold prompt at or under one chunk still prefills
alone. One lane: a lane-worthy request waits while the lane is busy.
``stats()`` adds the ``overlap`` payload (issue-to-issue gaps, host work a
step, the device's share of the wall time) and the lane's tallies.

Telemetry: the batcher records into the engine's metrics registry
(``engine.obs``, or ``obs=``): ``counters`` is a ``CounterDict`` mirrored
into ``picotron_requests_total{state}``, the queue-wait and TTFT windows
are registry histograms (the ``/statz`` percentiles and the ``/metrics``
buckets are one instrument), and tokens, drafts and each tenant's
requests, tokens, latencies and SLOs count into their families;
``refresh_gauges`` re-reads the occupancy gauges from host state alone,
from any thread. ``on_token(uid, token)`` sees every emitted token from
inside ``step()``, once the batcher has accepted it: the serial round, the
overlap pipeline's sync and the lane's landing alike (the serve front
end's stream).

Not ported yet: dp serving's rebalance under overlap and its per-shard
lanes, the JAX benchmark's synthetic device wait, the request spans, and
the per-slot and per-drafter speculation, controller, dispatch-time,
gap, host-work, lane and stall metric families (``stats()`` holds their
numbers).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from picotron_tpu_torch.inference import prng, sampling
from picotron_tpu_torch.inference.engine import CacheLost
from picotron_tpu_torch.inference.page_transport import TransportError
from picotron_tpu_torch.inference.paged_kv import PagePoolExhausted
from picotron_tpu_torch.inference.speculative import (
    DispatchLatency,
    LearnedDrafter,
    NgramDrafter,
    SpecController,
)
from picotron_tpu_torch.inference.kv_cache import cache_bytes
from picotron_tpu_torch.models.llama import param_bytes
from picotron_tpu_torch.obs.metrics import percentiles_of
from picotron_tpu_torch.resilience.retry import retry
from picotron_tpu_torch.utils import log0


# the retained recent samples of the issue-to-issue gaps and the host work
# a step (the JAX registry's histogram window)
SAMPLE_WINDOW = 4096


def device_lost(e: BaseException) -> bool:
    """Whether ``e`` is a CUDA error that leaves the device unusable to
    this process (a sticky error such as an illegal address): no retry or
    re-dispatch can succeed after it."""
    fatal = getattr(torch, "AcceleratorError", None)
    return ((fatal is not None and isinstance(e, fatal))
            or (isinstance(e, RuntimeError) and "CUDA error" in str(e)))


def _unretryable(e: BaseException) -> bool:
    return isinstance(e, CacheLost) or device_lost(e)


def _log_dispatch_failure(kind: str, ident, e: BaseException) -> None:
    log0(f"serving: {kind} dispatch failed for {ident} "
         f"({type(e).__name__}: {e})", flush=True)


@dataclass
class Request:
    """One generation request. ``temperature == 0`` = greedy; ``top_k <= 0``
    and ``top_p >= 1`` disable those filters. ``timeout_s`` is a wall-clock
    budget from admission: past it the request finishes with reason
    "timeout" and frees its slot (None = no deadline)."""

    uid: str
    prompt: list
    max_new_tokens: int = 32
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    eos_id: Optional[int] = None
    timeout_s: Optional[float] = None
    # the disaggregated handoff (inference/page_transport.py, paged engines
    # only): a transport payload whose pages are imported at admission.
    # With a ``first_token`` and covering the whole prompt, the slot seats
    # ready to decode with no prefill dispatch; otherwise the payload is a
    # prefix hint (imported into the radix cache, which the normal
    # admission then hits)
    kv_import: Optional[dict] = None
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
    # "eos" | "length" | "timeout" | "shed" (dropped unstarted) | "error"
    # (a dispatch failure isolated to this request)
    finish_reason: str
    queue_wait_s: Optional[float] = None  # submit -> admit
    ttft_s: Optional[float] = None  # submit -> first token
    dispatches: int = 0  # decode or verify rounds its slot took part in
    # speculative engines: the slot's draft length and drafter at
    # retirement (the controller's last choice, else the static ones)
    spec_len_final: Optional[int] = None
    drafter: Optional[str] = None


@dataclass
class _Slot:
    req: Request
    generated: list = field(default_factory=list)
    deadline: Optional[float] = None  # clock() time after which it retires
    submit_t: Optional[float] = None
    queue_wait_s: Optional[float] = None
    ttft_s: Optional[float] = None
    dispatches: int = 0
    # mixed dispatch: the slot's prompt is still being fed through the
    # lane; it rides every dispatch with budget 0 until its final chunk
    # lands its first token
    prefilling: bool = False


class ContinuousBatcher:
    """Drive an InferenceEngine over a stream of requests.

    >>> b = ContinuousBatcher(engine, params)
    >>> b.submit(Request("a", [1, 2, 3], max_new_tokens=16))
    >>> results = b.run()           # {"a": GenerationResult(...)}

    ``params`` must live on the engine's device. One batcher owns one
    cache. ``drafter`` replaces the configured drafter of a speculative
    engine (a scripted one in tests). ``clock`` (deadlines, latencies) and
    ``sleep`` (the retry backoff) are injectable for tests. ``on_token``
    (``on_token(uid, token)``) sees every emitted token, from inside
    ``step()``; ``obs`` replaces the engine's telemetry bundle.
    """

    def __init__(self, engine, params, seed: int = 0, clock=time.monotonic,
                 drafter=None, sleep=time.sleep,
                 on_token: Optional[Callable] = None, obs=None):
        self.engine = engine
        self.params = params
        self._clock = clock
        # one registry across engine, batcher and front end unless injected
        self.obs = obs if obs is not None else engine.obs
        self.on_token = on_token
        # the round schedule's draws; the slot schedule's base keys come
        # from the threefry chain, one split per admission
        self._gen = torch.Generator(device=engine.device).manual_seed(seed)
        self._slot_keys = engine.key_schedule == "slot"
        self._key = prng.PRNGKey(seed)
        r = engine.cfg.resilience
        self._retry = dict(attempts=r.dispatch_attempts,
                           backoff=r.dispatch_backoff,
                           desc="serving dispatch", sleep=sleep,
                           fatal=_unretryable)
        inf = engine.cfg.inference
        if drafter is None and engine.spec_len > 0:
            if engine.drafter_kind == "learned":
                drafter = LearnedDrafter(engine, params)
            else:
                drafter = NgramDrafter(engine.spec_ngram,
                                       window=inf.spec_history_window)
        self.drafter = drafter
        # the drafters the controller switches between, the primary first:
        # a learned primary carries the n-gram drafter beside it
        self._drafters: dict = {}
        if engine.spec_len > 0 and drafter is not None:
            self._drafters[drafter.kind] = drafter
            if drafter.kind == "learned":
                self._drafters["ngram"] = NgramDrafter(
                    engine.spec_ngram, window=inf.spec_history_window)
        # wall time of each dispatch kind: the controller's cost input
        self.latency = DispatchLatency()
        self.controller = None
        if engine.spec_len > 0 and inf.spec_controller.enabled:
            self.controller = SpecController(
                inf.spec_controller, self.latency, slots=engine.slots,
                max_spec_len=engine.spec_len,
                block_len=engine.decode_block_len,
                kinds=tuple(self._drafters))
        # the learned drafter's input: each slot's last hidden state, kept
        # on the device between dispatches
        self._hidden = None
        if engine.return_hidden:
            self._hidden = torch.zeros(
                (engine.slots, engine.cfg.model.hidden_size),
                dtype=engine._dt, device=engine.device)
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
        # the slot schedule's per-slot base keys (uint32 words)
        self._base_keys = np.zeros((n, 2), np.int64)
        # per-slot adapter pack slots, one row per decode block on an
        # engine with a pack; 0 (the null adapter) for free and base slots
        self._adapter = np.zeros(n, np.int32)
        # per-tenant host tally (stats()["tenants"])
        self._tenant_stats: dict = {}
        # prompt tokens admitted this scheduler round (_prefill_gate)
        self._round_prefill_tokens = 0
        # lifetime counters (bench + tests); every submitted request ends in
        # exactly one terminal state (completed = eos or length). A
        # CounterDict: plain-dict reads, every write mirrored into
        # picotron_requests_total{state}
        reg = self.obs.registry
        self.counters = reg.counter_dict(
            "picotron_requests_total",
            ("admitted", "completed", "expired", "errored", "shed"),
            help="request accounting by terminal state (+ admitted)")
        # the /statz percentile windows and the /metrics histograms: one
        # instrument, two renderings
        self._queue_wait_hist = reg.histogram(
            "picotron_queue_wait_seconds", "submit -> admit")
        self._ttft_hist = reg.histogram(
            "picotron_ttft_seconds", "submit -> first token")
        self._tokens_total = reg.counter(
            "picotron_generated_tokens_total", "tokens emitted to streams")
        self._draft_proposed_total = reg.counter(
            "picotron_draft_proposed_total",
            "draft tokens proposed (speculative engines)")
        self._draft_accepted_total = reg.counter(
            "picotron_draft_accepted_total",
            "draft tokens accepted into emitted streams")
        # disaggregation: imports that landed a remote prefix's pages, and
        # admissions seated straight from a handoff (no prefill dispatch)
        self._remote_hits_total = reg.counter(
            "picotron_prefix_remote_hits_total",
            "transport imports that landed a remote-prefilled prefix")
        self.handoff_seated = 0
        self.decode_dispatches = 0
        self.prefill_dispatches = 0
        self.generated_tokens = 0
        # draft tokens proposed, and those that entered an emitted stream
        self.draft_proposed = 0
        self.draft_accepted = 0
        # host wall time of the decode and draft-verify rounds, results
        # read back included (under overlap: the issue and sync stages)
        self.decode_seconds = 0.0
        # ---- the overlap pipeline (inference.overlap) ----------------------
        self._overlap = bool(engine.overlap)
        if self._overlap:
            engine.defer_advance = True
        # seat epochs, bumped when a slot finishes and when one is seated:
        # the round in flight keeps the epochs it was issued under, and its
        # sync drops every row whose seat moved since
        self._epoch = np.zeros(n, np.int64)
        self._inflight = None  # the issued round not yet read back
        self._dev_last = None  # the device's [slots] last-token row
        # issue-to-issue gaps (host time from one round's read-back to the
        # next issue; 0.0 while a round is in flight at issue) and each
        # step's host work (its wall time less its waits on the card), in
        # both modes; the summed issue-to-read-back windows over the wall
        # time from the first issue to the last read-back
        self._gaps: deque = deque(maxlen=SAMPLE_WINDOW)
        self._host_work: deque = deque(maxlen=SAMPLE_WINDOW)
        self._t_last_sync_end = None
        self._host_sync_s = 0.0  # the last read-back's wait on the card
        self._step_sync_wait = 0.0
        self._ov_device_s = 0.0
        self._ov_t0 = self._ov_t1 = None
        # ---- the mixed prefill lane (inference.mixed_dispatch) -------------
        self._mixed = bool(engine.mixed)
        self._lanes: list = [None]  # one lane record (dp_size is 1)
        self._lane_scratch = None  # a dispatch's (first token, lane hidden)
        # prompt tokens fed through the lane; seconds and count of the solo
        # prefills that ran while a decoder was seated (the stall the lane
        # removes)
        self.lane_tokens = 0
        self.decode_stall_s = 0.0
        self.decode_stalls = 0

    @property
    def accept_rate(self) -> Optional[float]:
        """Fraction of proposed draft tokens that were emitted (None before
        any draft)."""
        if not self.draft_proposed:
            return None
        return self.draft_accepted / self.draft_proposed

    def spec_len_effective(self) -> float:
        """Mean draft length over the occupied slots: the controller's
        choices, or ``engine.spec_len`` without one (0.0 with nothing
        parked or speculation off)."""
        occ = [i for i, s in enumerate(self._slots) if s is not None]
        if self.engine.spec_len <= 0 or not occ:
            return 0.0
        if self.controller is not None:
            return self.controller.spec_len_mean(occ)
        return float(self.engine.spec_len)

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
        """Requests wait, a slot is occupied, or a round is in flight."""
        return (bool(self._pending)
                or any(s is not None for s in self._slots)
                or self._inflight is not None)

    @property
    def queue_depth(self) -> int:
        """Requests waiting for a slot (the bounded-queue admission gate)."""
        return len(self._pending)

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

    def token_load(self) -> int:
        """Worst-case token commitment of every queued and live request:
        the token-budget admission gate's load."""
        load = sum(self.commitment(r) for r in self._pending)
        for s in self._slots:
            if s is not None:
                load += self.commitment(s.req)
        return load

    def page_commitment(self, req: Request) -> int:
        """Worst-case pool pages ``req`` can occupy: its commitment plus
        the rows a dispatch can write past it (the one row a stopped slot
        keeps rewriting, or a verify's ``spec_len`` draft rows), in pages,
        at most a slot's window. Prefix hits only make the real footprint
        smaller."""
        overshoot = (self.engine.spec_len if self.engine.spec_len > 0
                     else 1)
        return min(self.paged.pages_for(self.commitment(req) + overshoot),
                   self.paged.max_pages)

    def page_load(self) -> int:
        """Worst-case page commitment of every queued and live request."""
        load = sum(self.page_commitment(r) for r in self._pending)
        for s in self._slots:
            if s is not None:
                load += self.page_commitment(s.req)
        return load

    # ---- multi-tenant accounting ------------------------------------------

    @staticmethod
    def _tname(req: Request) -> str:
        """The request's tenant label ("" counts as "base")."""
        return req.tenant or "base"

    def _tstat(self, req: Request) -> dict:
        """The tally of ``req``'s tenant."""
        name = self._tname(req)
        st = self._tenant_stats.get(name)
        if st is None:
            st = {"requests": 0, "tokens": 0, "shed": 0,
                  "prefill_deferred": 0, "prefill_preempts": 0}
            self._tenant_stats[name] = st
        return st

    def _tenant_count(self, req: Request, state: str) -> None:
        self.obs.registry.counter(
            "picotron_tenant_requests_total",
            "request accounting by tenant and terminal state (+ admitted)",
            tenant=self._tname(req), state=state).inc()

    def _tenant_slo(self, req: Request, slo: str, met: bool) -> None:
        self.obs.registry.counter(
            "picotron_tenant_slo_total",
            "per-tenant SLO attainment by target and outcome",
            tenant=self._tname(req), slo=slo,
            outcome="met" if met else "missed").inc()

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
        self.counters["shed"] += 1
        self._tstat(req)["shed"] += 1
        self._tenant_count(req, "shed")
        self._results[req.uid] = GenerationResult(
            req.uid, list(req.prompt), [], "shed")

    def shed_pending(self) -> None:
        """Finish every queued (never admitted) request "shed": the
        graceful drain. Live slots run on; work that never started goes
        back to its client, to retry on another replica."""
        while self._pending:
            self._shed(self._pending.popleft())

    def refresh_gauges(self) -> tuple:
        """Re-read live occupancy into the registry gauges; returns
        ``(queued, active)``. Called by ``stats()`` and by the serve front
        end's ``/metrics`` render without the front end's lock: it reads
        host state alone (snapshots of the queue and the slot list, the
        host page allocator's counts) and mutates no batcher state."""
        pending = list(self._pending)
        slots = list(self._slots)
        queued = len(pending)
        active = sum(s is not None for s in slots)
        reg = self.obs.registry
        reg.gauge("picotron_queue_depth",
                  "requests waiting for a slot").set(queued)
        reg.gauge("picotron_active_slots",
                  "slots holding a live request").set(active)
        # one shard: the JAX package's dp gauges at dp 1, so scrapers
        # never branch
        reg.gauge("picotron_dp_size",
                  "dp shards of this logical engine").set(1)
        reg.gauge("picotron_shard_occupancy", "occupied slots by dp shard",
                  shard="0").set(active)
        if self.paged is not None:
            total = self.paged.pool.usable_pages
            live = self.paged.pool.live_count
            reg.gauge("picotron_kv_pages_live",
                      "KV pool pages holding live tokens").set(live)
            reg.gauge("picotron_kv_pool_utilization",
                      "live / usable KV pool pages").set(
                          live / max(total, 1))
        if self.engine.spec_len > 0:
            reg.gauge("picotron_spec_accept_rate",
                      "fraction of proposed draft tokens accepted").set(
                          self.accept_rate or 0.0)
            reg.gauge("picotron_spec_len",
                      "mean effective draft length over occupied slots"
                      ).set(self.spec_len_effective())
        queued_by: dict = {}
        for r in pending:
            name = self._tname(r)
            queued_by[name] = queued_by.get(name, 0) + 1
        active_by: dict = {}
        pages_by: dict = {}
        for s in slots:
            if s is None:
                continue
            name = self._tname(s.req)
            active_by[name] = active_by.get(name, 0) + 1
            if self.paged is not None:
                pages_by[name] = (pages_by.get(name, 0)
                                  + self.page_commitment(s.req))
        for name in set(self._tenant_stats) | set(queued_by) | set(active_by):
            reg.gauge("picotron_tenant_queue_depth",
                      "queued requests by tenant",
                      tenant=name).set(queued_by.get(name, 0))
            reg.gauge("picotron_tenant_active_slots",
                      "occupied slots by tenant",
                      tenant=name).set(active_by.get(name, 0))
            if self.paged is not None:
                reg.gauge("picotron_tenant_pages_committed",
                          "worst-case page commitment of live slots, "
                          "by tenant",
                          tenant=name).set(pages_by.get(name, 0))
        return queued, active

    def stats(self) -> dict:
        """Serving counters (the JAX batcher's ``/statz`` fields that the
        port has, the request accounting of ``counters`` among them), with
        the resident bytes of the weights and the cache that int8 storage
        shrinks; on the paged layout, the pool's
        occupancy, the prefix cache's counters and the handoff's
        (``handoff_seated``, ``prefix_remote_hits``) too; with tenants, each
        tenant's tally under ``"tenants"`` (requests admitted, tokens
        emitted, requests shed, admissions the prefill gate deferred or
        let through on TTFT pressure). A
        speculative engine adds ``spec_len_effective`` (and, once a draft
        was proposed, ``accept_rate``; with a controller its decisions
        under ``spec_controller``). ``overlap`` holds the issue-to-issue
        gaps and each step's host work (percentiles over the recent
        window) and, once a round was read back, the device-busy seconds
        (summed issue-to-read-back windows), the wall time and their ratio;
        ``mixed`` whether the lane runs and whether it is mid-prompt; the
        lane's prompt tokens and the solo prefills' decode stall beside
        them. ``queue_wait_s`` and ``ttft_s`` are percentiles over the
        registry histograms' recent windows (None before a sample or with
        ``obs.enabled: false``)."""
        queued, active = self.refresh_gauges()
        d = {
            **self.counters,
            "decode_dispatches": self.decode_dispatches,
            "prefill_dispatches": self.prefill_dispatches,
            "generated_tokens": self.generated_tokens,
            "queued": queued,
            "active_slots": active,
            "slots": len(self._slots),
            "queue_wait_s": self._queue_wait_hist.percentiles(),
            "ttft_s": self._ttft_hist.percentiles(),
            "weight_dtype": self.engine.weight_dtype,
            "weight_bytes": param_bytes(self.params),
            "kv_cache_dtype": str(self.engine.cache_dtype).removeprefix(
                "torch."),
            "cache_bytes": cache_bytes(self._cache),
        }
        if self.draft_proposed:
            d["accept_rate"] = self.accept_rate
        if self.engine.spec_len > 0:
            d["spec_len_effective"] = self.spec_len_effective()
            if self.controller is not None:
                d["spec_controller"] = self.controller.decisions
        if self.paged is not None:
            d.update(self.paged.stats())
            d["handoff_seated"] = self.handoff_seated
            d["prefix_remote_hits"] = int(self._remote_hits_total.value)
        if self._tenant_stats:
            d["tenants"] = {name: dict(st)
                            for name, st in self._tenant_stats.items()}
        ov = {"enabled": self._overlap,
              "dispatch_gap_s": percentiles_of(self._gaps),
              "host_work_s": percentiles_of(self._host_work)}
        if self._ov_t0 is not None and self._ov_t1 is not None:
            wall = max(self._ov_t1 - self._ov_t0, 1e-9)
            ov.update(device_busy_s=self._ov_device_s, wall_s=wall,
                      overlap_efficiency=min(1.0, self._ov_device_s / wall))
        d["overlap"] = ov
        d["last_host_sync_s"] = self._host_sync_s
        d["mixed"] = {"enabled": self._mixed,
                      "lanes_active": sum(ln is not None
                                          for ln in self._lanes)}
        d["prefill_lane_tokens"] = self.lane_tokens
        d["decode_stall_s"] = self.decode_stall_s
        d["decode_stalls"] = self.decode_stalls
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

    _TERMINAL = {"eos": "completed", "length": "completed",
                 "timeout": "expired", "error": "errored"}

    def _finish(self, i: int, reason: str) -> None:
        s = self._slots[i]
        self.counters[self._TERMINAL[reason]] += 1
        self._tenant_count(s.req, self._TERMINAL[reason])
        if (len(s.generated) > 1 and s.ttft_s is not None
                and s.submit_t is not None):
            # the request's mean time per output token after the first
            tpot = ((self._clock() - s.submit_t - s.ttft_s)
                    / (len(s.generated) - 1))
            self.obs.registry.histogram(
                "picotron_tenant_tpot_seconds",
                "mean per-token decode latency by tenant",
                tenant=self._tname(s.req)).observe(tpot)
            if s.req.tpot_slo_ms is not None:
                self._tenant_slo(s.req, "tpot",
                                 tpot * 1000.0 <= s.req.tpot_slo_ms)
        spec_len = drafter_kind = None
        if self.engine.spec_len > 0:
            if self.controller is not None:
                spec_len = int(self.controller.lens()[i])
                drafter_kind = self.controller.drafter_kinds()[i]
            else:
                spec_len = self.engine.spec_len
                drafter_kind = (self.drafter.kind if self.drafter is not None
                                else None)
        self._results[s.req.uid] = GenerationResult(
            s.req.uid, list(s.req.prompt), list(s.generated), reason,
            queue_wait_s=s.queue_wait_s, ttft_s=s.ttft_s,
            dispatches=s.dispatches, spec_len_final=spec_len,
            drafter=drafter_kind)
        for d in self._drafters.values():
            d.forget(s.req.uid)
        self._slots[i] = None
        # a round in flight that was issued against this occupant drops
        # the seat's rows at its sync
        self._epoch[i] += 1
        ln = self._lanes[0]
        if ln is not None and ln["slot"] == i:
            # a prefilling occupant retired mid-prompt abandons the lane;
            # the epoch bump isolates a chunk still in flight
            self._lanes[0] = None
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
        self._tokens_total.inc()
        self._tstat(s.req)["tokens"] += 1
        self.obs.registry.counter(
            "picotron_tenant_tokens_total",
            "tokens emitted to streams, by tenant",
            tenant=self._tname(s.req)).inc()
        if s.ttft_s is None and s.submit_t is not None:
            s.ttft_s = self._clock() - s.submit_t
            self._ttft_hist.observe(s.ttft_s)
            self.obs.registry.histogram(
                "picotron_tenant_ttft_seconds",
                "submit -> first token, by tenant",
                tenant=self._tname(s.req)).observe(s.ttft_s)
            if s.req.ttft_slo_ms is not None:
                self._tenant_slo(s.req, "ttft",
                                 s.ttft_s * 1000.0 <= s.req.ttft_slo_ms)
        if self.on_token is not None:
            self.on_token(s.req.uid, tok)
        r = s.req
        if r.eos_id is not None and tok == r.eos_id:
            self._finish(i, "eos")
        elif (len(s.generated) >= r.max_new_tokens
              or len(r.prompt) + len(s.generated) >= self.engine.max_seq_len):
            self._finish(i, "length")
        else:
            self._last_tok[i] = tok

    def _split(self) -> torch.Tensor:
        """The next key of the ``PRNGKey(seed)`` chain (one per
        admission)."""
        self._key, sub = prng.split(self._key)
        return sub

    def _dev_tok(self) -> torch.Tensor:
        """The device-held [slots] last-token row (overlap): a round's input
        tokens come from here, so issuing it never waits for the host to
        read the round before. A slot program's ``next_tok`` output
        replaces it at issue; seating a slot writes that slot's entry in
        place, after the round in flight on the stream."""
        if self._dev_last is None:
            self._dev_last = self.engine._tokens(self._last_tok)
        return self._dev_last

    def _retried(self, fn):
        """``fn()`` under the dispatch retry budget."""
        return retry(fn, **self._retry)

    def _prefill_into(self, req: Request, i: int, key=None):
        """Prefill ``req`` into slot ``i`` (one-shot or chunked) under its
        adapter slot; return its last-token logits [1, V], or on a
        ``sample_on_device`` engine the first token [1] drawn in the
        dispatch with ``key``. On a ``return_hidden`` engine the prompt's
        last hidden state seeds the slot's drafting row. A paged request
        with a handoff payload (``kv_import``) that seats returns
        ``("handoff", first_token)`` and dispatches nothing."""
        eng = self.engine
        if self.paged is not None and req.kv_import is not None:
            seated = self._try_import(req, i)
            if seated is not None:
                return seated
            # the payload landed as a prefix hint (or was dropped): the
            # paged admission below hits whatever it left in the cache
        sample = ((key, req.temperature, req.top_k, req.top_p)
                  if eng.sample_on_device else None)
        # an engine without a pack takes no ids and runs as without tenancy
        adapter = (int(req.adapter_slot) if eng.adapters is not None
                   else None)
        if self.paged is not None:
            self.paged.priced[i] = self.page_commitment(req)
            out = eng.prefill_paged(
                self.params, self._cache, req.prompt, i, adapter_id=adapter,
                cache_salt=req.tenant, sample=sample)
            self._cache, logits, n = out[:3]
            hidden = out[4:]
            self.prefill_dispatches += n
        elif len(req.prompt) > eng.prefill_chunk:
            out = eng.prefill_chunked(
                self.params, self._cache, req.prompt, i, adapter_id=adapter,
                sample=sample)
            self._cache, logits = out[:2]
            hidden = out[2:]
            self.prefill_dispatches += -(-len(req.prompt) // eng.prefill_chunk)
        else:
            out = eng.prefill(self.params, req.prompt, adapter_id=adapter,
                              sample=sample)
            kv, logits = out[:2]
            hidden = out[2:]
            self._cache = eng.insert(self._cache, kv, i, len(req.prompt))
            self.prefill_dispatches += 1
        if self._hidden is not None and hidden:
            self._hidden[i] = hidden[0][0]
        return logits

    def _try_import(self, req: Request, i: int):
        """Land ``req.kv_import``'s pages and, when the payload covers the
        whole prompt with its first token, seat slot ``i`` ready to decode:
        the handoff's admission with no dispatch. Returns ``("handoff",
        first_token)`` on a seat, None when the payload is only a prefix
        hint (or pressure evicted part of it before the slot could share
        it). A payload this replica cannot land (corrupt bytes, no pool
        room) is dropped and counted, and the request self-prefills: the
        import released every page it allocated. Idempotent under the
        dispatch retry: the import skips cached chunks and
        ``match_prefix`` releases what an earlier attempt held."""
        payload = req.kv_import
        self.paged.priced[i] = self.page_commitment(req)
        try:
            self._cache, info = self.engine.import_prefix(self._cache,
                                                          payload)
        except (TransportError, PagePoolExhausted) as e:
            self.obs.registry.counter(
                "picotron_handoff_dropped_total",
                "kv payloads dropped as locally unusable").inc()
            log0(f"serving: kv import for {req.uid!r} dropped "
                 f"({type(e).__name__}: {e}); self-prefilling", flush=True)
            return None
        if info["pages_imported"] > 0:
            # counted when pages land: a retried admission's second import
            # (everything cached already) adds nothing
            self._remote_hits_total.inc()
        ids = [int(t) for t in payload.get("token_ids") or []]
        first = payload.get("first_token")
        if first is None or ids != [int(t) for t in req.prompt]:
            return None
        cached = self.paged.match_prefix(i, ids, cap_last=False,
                                         salt=req.tenant)
        if cached != len(ids):
            return None
        self._cache = self.engine.seat_slot(self._cache, i, cached)
        if self._hidden is not None:
            # no prefill ran, so no hidden state: zero the row rather than
            # draft from the previous occupant's (the first verify seeds it)
            self._hidden[i].zero_()
        self.handoff_seated += 1
        return ("handoff", int(first))

    def export_prefix(self, ids, first_token=None,
                      tenant: str = "") -> dict:
        """The longest radix-cached prefix of ``ids`` in this batcher's
        cache as a transport payload (the serve front end's /kv/export and
        /kv/pages; the caller serializes batcher access). ``tenant``
        scopes the lookup and rides in the payload."""
        return self.engine.export_prefix(self._cache, ids,
                                         first_token=first_token,
                                         cache_salt=tenant)

    def import_prefix(self, payload) -> dict:
        """Land a transport payload in this batcher's cache and radix cache
        (the serve front end's /kv/import). Returns the import's info."""
        self._cache, info = self.engine.import_prefix(self._cache, payload)
        if info["pages_imported"] > 0:
            self._remote_hits_total.inc()
        return info

    def _seat(self, req: Request, i: int, submit_t, prefilling=False):
        """Seat ``req`` in slot ``i``: its slot record, a new seat epoch,
        its sampling row and adapter, the controller's and the drafters'
        fresh start."""
        now = self._clock()
        slot = _Slot(req, submit_t=submit_t, prefilling=prefilling,
                     deadline=(now + req.timeout_s
                               if req.timeout_s is not None else None))
        if submit_t is not None:
            slot.queue_wait_s = now - submit_t
            self._queue_wait_hist.observe(slot.queue_wait_s)
        self._slots[i] = slot
        self._epoch[i] += 1
        self._adapter[i] = (req.adapter_slot
                            if self.engine.adapters is not None else 0)
        # a new request: the controller restarts the slot's policy and
        # stateful drafters drop the previous occupant's index
        if self.controller is not None:
            self.controller.reset(i, tpot_slo_s=(
                req.tpot_slo_ms / 1000.0
                if req.tpot_slo_ms is not None else None))
        for d in self._drafters.values():
            d.begin(req.uid)
        self._temp[i] = req.temperature
        self._top_k[i] = req.top_k
        self._top_p[i] = req.top_p
        self._eos[i] = req.eos_id if req.eos_id is not None else -1

    def _first_token(self, i: int, first: int) -> None:
        """A seated slot's first token: under overlap it goes into the
        device row the next round reads as well."""
        if self._overlap:  # fill_: no copy that waits for the card
            self._dev_tok()[i: i + 1].fill_(first)
        self._token_done(i, first)

    def _admit(self) -> None:
        dev = self.engine.device
        self._round_prefill_tokens = 0
        for i in range(len(self._slots)):
            if self._slots[i] is not None:
                continue
            req, lane = self._next_admissible()
            if req is None:
                if lane:  # the lane is busy: this seat waits
                    continue
                return
            if lane:
                self._lane_start(req, i)
                continue
            submit_t = self._submit_t.pop(req.uid, None)
            # the first token's key: the round schedule's generator, or the
            # slot's base key (one split of the chain per admission, taken
            # before the prefill, so a failed one still spends its link)
            # folded with the prompt's last row
            if self._slot_keys:
                self._base_keys[i] = self._split().numpy()
                key = prng.fold_in(self._base_keys[i], len(req.prompt) - 1)
            else:
                key = self._gen
            gen_state = self._gen.get_state()

            def attempt():
                try:
                    return self._prefill_into(req, i, key)
                except BaseException:
                    # a sample_on_device attempt may have drawn already
                    self._gen.set_state(gen_state)
                    raise

            self.counters["admitted"] += 1
            self._tstat(req)["requests"] += 1
            self._tenant_count(req, "admitted")
            # a solo prefill stalls every seated decoder behind it: the
            # stall the mixed lane removes, timed in both modes
            stall0 = (self._clock()
                      if any(s is not None and not s.prefilling
                             for s in self._slots) else None)
            try:
                logits = self._retried(attempt)
            except Exception as e:  # noqa: BLE001 - isolated to this request
                if device_lost(e):
                    raise
                # the request never held the slot: release what a partial
                # prefill left there; everyone admitted decodes on
                _log_dispatch_failure("prefill", req.uid, e)
                self.counters["errored"] += 1
                self._tenant_count(req, "errored")
                self._results[req.uid] = GenerationResult(
                    req.uid, list(req.prompt), [], "error")
                self._cache = self.engine.release(self._cache, i)
                continue
            finally:
                if stall0 is not None:
                    self.decode_stall_s += self._clock() - stall0
                    self.decode_stalls += 1
            handoff = isinstance(logits, tuple)
            if not handoff:
                # a handoff seat costs the prefill gate nothing
                self._round_prefill_tokens += len(req.prompt)
            self._seat(req, i, submit_t)
            if handoff:
                # the prefill replica sampled the first token already
                first = [logits[1]]
            elif self.engine.sample_on_device:
                first = logits  # drawn in the dispatch
            else:
                args = (torch.tensor([req.temperature], dtype=torch.float32,
                                     device=dev),
                        torch.tensor([req.top_k], dtype=torch.int32,
                                     device=dev),
                        torch.tensor([req.top_p], dtype=torch.float32,
                                     device=dev))
                if self._slot_keys:
                    first = sampling.sample_rowkeys(
                        logits, key[None], *args,
                        greedy_only=req.temperature <= 0)
                else:
                    first = sampling.sample(logits, self._gen, *args)
            self._first_token(i, int(first[0]))

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

    def _prefill_gate(self, req: Request, tokens: Optional[int] = None,
                      submit_t: Optional[float] = None) -> bool:
        """Whether ``req`` may prefill this round. While a live slot carries
        a TPOT SLO, a round admits at most one ``prefill_chunk`` of prompt
        tokens (its prefill stalls every decoder behind it); the first
        admission of a round always passes. A request that has spent half
        its TTFT budget waiting preempts the cap. Both decisions are
        tallied per tenant. ``tokens`` prices the decision (default: the
        whole prompt, which a serial admission prefills this round); the
        lane prices one chunk, so the gate's round budget is the lane's
        feed rate. ``submit_t`` stands in for the queue's clock (a lane's
        request left the queue when it was seated)."""
        if tokens is None:
            tokens = len(req.prompt)
        if self._round_prefill_tokens == 0:
            return True
        if not any(s is not None and s.req.tpot_slo_ms is not None
                   for s in self._slots):
            return True
        if req.ttft_slo_ms is not None:
            t0 = (submit_t if submit_t is not None
                  else self._submit_t.get(req.uid))
            if (t0 is not None and (self._clock() - t0) * 1000.0
                    >= req.ttft_slo_ms / 2.0):
                self._tstat(req)["prefill_preempts"] += 1
                return True
        if (self._round_prefill_tokens + tokens
                <= self.engine.prefill_chunk):
            return True
        self._tstat(req)["prefill_deferred"] += 1
        return False

    def _next_admissible(self) -> tuple:
        """The next request to admit (``_pick``) and whether it prefills
        through the lane, or (None, False) to stop admitting this round,
        or (None, True) when the request wants the lane and the lane is
        busy (the request stays queued; this seat waits). Paged: a request
        that can never fit the pool is shed here; one that does not fit
        now waits, since admitting it could strand a live slot mid-decode.
        A request the prefill gate defers waits for the next round (the
        lane's chunks pay the gate as they are fed)."""
        while self._pending:
            j = self._pick()
            req = self._pending[j]
            if self.paged is not None:
                need = self.page_commitment(req)
                if need > self.paged.usable_pages:
                    del self._pending[j]
                    self._shed(req)
                    continue
            lane = self._lane_wants(req)
            if lane and self._lanes[0] is not None:
                return None, True
            if self.paged is not None and not self.paged.can_admit(need):
                return None, False
            if not lane and not self._prefill_gate(req):
                return None, False
            del self._pending[j]
            return req, lane
        return None, False

    # ---- the mixed prefill lane -------------------------------------------

    def _lane_wants(self, req: Request) -> bool:
        """Whether ``req`` prefills through the lane rather than alone: a
        prompt longer than one chunk (the serial path runs the same chunks,
        as stalls), or a paged prompt with a radix hit (the serial path
        resumes past it in chunks: again the lane's computation). A cold
        prompt at or under one chunk prefills alone: its one-shot bucketed
        prefill is another computation, and the streams that do not need
        the lane keep their bits. A handoff payload (``kv_import``) stays
        serial too: its import may seat the slot with no prefill at
        all."""
        if not self._mixed or req.kv_import is not None:
            return False
        if len(req.prompt) > self.engine.prefill_chunk:
            return True
        if self.paged is None:
            return False
        return self.paged.peek_prefix([int(t) for t in req.prompt],
                                      salt=req.tenant) > 0

    def _lane_start(self, req: Request, i: int) -> None:
        """Seat ``req`` in free slot ``i`` as a prefilling occupant and open
        the lane on it: the prompt goes through the dispatches one chunk a
        round (``_lane_feed``) and no prefill runs alone. The admission's
        accounting is the serial seat's; the first token (and the TTFT)
        comes when the final chunk lands. The base key is split here, as a
        serial admission splits it, and the final chunk's draw folds it at
        the prompt's last row."""
        submit_t = self._submit_t.pop(req.uid, None)
        self._base_keys[i] = self._split().numpy()
        fold = prng.fold_in(self._base_keys[i],
                            len(req.prompt) - 1).numpy()
        ids = [int(t) for t in req.prompt]
        cached = 0
        if self.paged is not None:
            self.paged.priced[i] = self.page_commitment(req)
            cached = self.paged.match_prefix(i, ids, salt=req.tenant)
            if cached > 0:
                # the shared prefix parked, ready to resume past: the
                # serial radix-hit admission without its chunks
                self._cache = self.engine.seat_slot(self._cache, i, cached)
        self.counters["admitted"] += 1
        self._tstat(req)["requests"] += 1
        self._tenant_count(req, "admitted")
        self._seat(req, i, submit_t, prefilling=True)
        self._lanes[0] = dict(slot=i, epoch=int(self._epoch[i]), req=req,
                              ids=ids, cached=cached, done_end=cached,
                              fed_end=cached, key=fold, chunks=0)

    def _lane_feed(self) -> tuple:
        """This round's lane operand: the lane's next chunk, if its prompt
        has one left and the prefill gate lets the chunk's tokens through
        (a deferred chunk counts as a deferral). Returns (``lanes`` for
        ``decode_block``/``verify`` or None, the feed records for
        ``_lane_land``). Under overlap the lane feeds one chunk ahead of
        its last landed row (``fed_end`` past ``done_end``): the chunk in
        flight runs first on the stream, so the next one's prefix is
        parked when it runs."""
        ln = self._lanes[0]
        if ln is None:
            return None, ()
        i = ln["slot"]
        s = self._slots[i]
        if (s is None or s.req is not ln["req"]
                or self._epoch[i] != ln["epoch"]):
            self._lanes[0] = None
            return None, ()
        ids, C = ln["ids"], self.engine.prefill_chunk
        s0 = ln["fed_end"]
        if s0 >= len(ids):
            return None, ()  # the final chunk is in flight
        end = min(s0 + C, len(ids))
        if not self._prefill_gate(s.req, tokens=end - s0,
                                  submit_t=s.submit_t):
            return None, ()
        # prefill_chunked's convention: an absolute start on the paged
        # layout, the window slid back near its end on the contiguous one
        w0 = (s0 if self.paged is not None
              else min(s0, self.engine.max_seq_len - C))
        entry = dict(slot=i, tokens=ids[w0:end], start=w0)
        if self.engine.sample_on_device:
            entry.update(key=ln["key"], temperature=s.req.temperature,
                         top_k=s.req.top_k, top_p=s.req.top_p)
        if self.engine.adapters is not None:
            entry["adapter"] = int(s.req.adapter_slot)
        self._round_prefill_tokens += end - s0
        self.lane_tokens += end - s0
        ln["fed_end"] = end
        return [entry], [dict(lane=ln, end=end)]

    def _lane_first(self, lane_out, feeds):
        """The first token [1] of the prompt whose final chunk ``feeds``
        carried, on the device (None when no final chunk was fed): the
        ``sample_on_device`` lane's own draw, or the draw from its logits
        with the fold key at the prompt's last row, as a serial admission
        draws it. Queued without a host sync."""
        final = [f["lane"] for f in feeds
                 if f["end"] >= len(f["lane"]["ids"])]
        if not final or lane_out is None:
            return None
        if self.engine.sample_on_device:
            return lane_out
        eng, req = self.engine, final[0]["req"]
        return sampling.sample_rowkeys(
            lane_out, eng._key_rows(final[0]["key"])[None],
            eng._upload([req.temperature], np.float32),
            eng._upload([req.top_k], np.int32),
            eng._upload([req.top_p], np.float32),
            greedy_only=req.temperature <= 0)

    def _strip_lane(self, out: tuple, feeds) -> tuple:
        """A mixed engine's dispatch tuple without its lane outputs, which
        go to ``_lane_scratch`` as (first token, lane hidden) for
        ``_lane_land``. An isolation re-dispatch runs the chunk again on
        the same rows with the same bytes, so stashing again changes
        nothing."""
        if not self._mixed:
            return out
        n = 2 if self.engine.return_hidden else 1
        lane = out[-n:]
        self._lane_scratch = (self._lane_first(lane[0], feeds),
                              lane[1] if n == 2 else None)
        return out[:-n]

    def _lane_land(self, feeds) -> None:
        """Land one round's lane chunk: the lane's confirmed row count, its
        paged host length, the chunk's prefill dispatch and, with the
        prompt's final chunk, the first token (the slot decodes from the
        next round). A round that delivered nothing (every isolated
        dispatch failed) rewinds the feed, so the chunk runs again: its
        rewrite is the same bytes."""
        scratch, self._lane_scratch = self._lane_scratch, None
        if not feeds:
            return
        if scratch is None:
            for f in feeds:
                if self._lanes[0] is f["lane"]:
                    f["lane"]["fed_end"] = f["lane"]["done_end"]
            return
        first_tok, lane_hid = scratch
        for f in feeds:
            ln = f["lane"]
            if self._lanes[0] is not ln:
                continue  # dropped while the chunk flew
            i = ln["slot"]
            s = self._slots[i]
            if s is None or self._epoch[i] != ln["epoch"]:
                self._lanes[0] = None
                continue
            self.prefill_dispatches += 1
            ln["chunks"] += 1
            ln["done_end"] = f["end"]
            if self.paged is not None:
                self.paged.set_len(i, f["end"])
            if f["end"] < len(ln["ids"]):
                continue
            if self._hidden is not None and lane_hid is not None:
                self._hidden[i] = lane_hid[0]
            if self.paged is not None:
                self.paged.register_prompt(i, ln["ids"], salt=s.req.tenant)
            self._lanes[0] = None
            s.prefilling = False
            self._first_token(i, int(first_tok.reshape(-1)[0]))

    def _expire_deadlines(self) -> None:
        """Retire every slot past its deadline with reason "timeout". Runs
        first in a round, so the freed slot is refilled in the same
        round."""
        now = self._clock()
        for i, s in enumerate(self._slots):
            if s is not None and s.deadline is not None and now >= s.deadline:
                self._finish(i, "timeout")

    # ---- speculation ------------------------------------------------------

    def _plan_spec(self) -> tuple:
        """Each slot's draft length and drafter kind for the next round, or
        (None, None) when the controller has turned every occupied slot
        off: the round is then a decode block."""
        n = len(self._slots)
        lens = np.zeros(n, np.int32)
        kinds: list = [None] * n
        occupied = [i for i, s in enumerate(self._slots) if s is not None]
        if self.controller is not None:
            clens = self.controller.lens()
            ckinds = self.controller.drafter_kinds()
            for i in occupied:
                lens[i] = clens[i]
                kinds[i] = ckinds[i]
            if occupied and not lens.any():
                return None, None
        else:
            for i in occupied:
                lens[i] = self.engine.spec_len
                kinds[i] = self.drafter.kind
        return lens, kinds

    def _merge_hidden(self, hid, counts) -> None:
        """Fold one dispatch's hidden rows into the slots' drafting rows:
        only slots that emitted tokens move (a solo re-dispatch moves its
        own row)."""
        if self._hidden is not None and hid is not None:
            moved = self.engine._upload(np.asarray(counts) > 0, np.bool_)
            self._hidden = torch.where(moved[:, None], hid, self._hidden)

    def _draft(self, lens, kinds) -> np.ndarray:
        """The [slots, spec_len + 1] verify block: column 0 each slot's
        last token, then ``lens[i]`` drafts of its drafter (zeros past
        them). Learned slots draft together in one pass over the hidden
        rows, timed as a "draft" dispatch (it reads its drafts back, as
        the JAX package's does); host drafters propose per slot from its
        history. Under overlap this runs while the card works, from host
        state a round stale, and the round takes column 0 from the device
        row instead: a stale draft costs acceptance, never a token."""
        g = self.engine.spec_len
        tokens = np.zeros((len(self._slots), g + 1), np.int32)
        learned = [i for i, s in enumerate(self._slots)
                   if s is not None and kinds[i] == "learned"
                   and lens[i] > 0]
        batch = None
        if learned:
            t0 = self._clock()
            batch = self._drafters["learned"].propose_batch(
                self._last_tok, self._hidden, g)
            self.latency.observe("draft", self._clock() - t0)
        for i, s in enumerate(self._slots):
            if s is None:
                continue
            tokens[i, 0] = self._last_tok[i]
            gi = int(lens[i])
            if gi == 0:
                continue  # this slot rides the verify with no draft
            if kinds[i] == "learned":
                tokens[i, 1: 1 + gi] = batch[i, :gi]
                continue
            d = self._drafters.get(kinds[i], self.drafter)
            hist = np.asarray(list(s.req.prompt) + s.generated, np.int32)
            if getattr(d, "stateful", False):
                tokens[i, 1: 1 + gi] = d.propose(hist, gi, ctx=s.req.uid)
            else:
                tokens[i, 1: 1 + gi] = d.propose(hist, gi)
        return tokens

    def _spec_account(self, lens, accepted, budget, failed) -> None:
        """One verify round's draft counts: the lifetime totals and the
        controller's per-slot record (failed slots proposed nothing that
        was verified)."""
        for i, s in enumerate(self._slots):
            if s is None or i in failed or budget[i] <= 0 or lens[i] == 0:
                continue
            gi = int(lens[i])
            acc = int(accepted[i]) if accepted is not None else 0
            self.draft_proposed += gi
            self.draft_accepted += acc
            self._draft_proposed_total.inc(gi)
            self._draft_accepted_total.inc(acc)
            if self.controller is not None:
                self.controller.record(i, gi, acc)

    def _keys_arg(self):
        """The dispatch's key operand: the slots' base keys, or the round
        schedule's generator."""
        return self._base_keys if self._slot_keys else self._gen

    def _note_issue(self, t0: float) -> None:
        """Tally the issue-to-issue gap: the host time from the last
        round's read-back to this issue, the bubble overlap closes (0.0
        while a round is still in flight at issue)."""
        if self._ov_t0 is None:
            self._ov_t0 = t0
        if self._inflight is not None:
            gap = 0.0
        elif self._t_last_sync_end is None:
            return  # the first round has nothing to gap against
        else:
            gap = max(0.0, t0 - self._t_last_sync_end)
        self._gaps.append(gap)

    def _note_sync_end(self, t_issue: float, t_sync: float,
                       t_end: float) -> None:
        """A round read back: its wait, and its issue-to-read-back window
        (the device's share of the wall time counts these)."""
        self._step_sync_wait += t_end - t_sync
        self._host_sync_s = t_end - t_sync
        self._t_last_sync_end = t_end
        self._ov_device_s += max(0.0, t_end - t_issue)
        self._ov_t1 = t_end

    def _spec_round(self, budget, lens, kinds, lanes=None,
                    feeds=()) -> tuple:
        """One draft-verify round: the drafts (``_draft``), one
        ``engine.verify`` dispatch over them (with the lane's chunk),
        ragged at ``lens`` and fault-isolated like a decode round, and the
        draft counts. Returns (emitted [slots, spec_len + 1], counts
        [slots], failed slots) on the host."""
        tokens = self._draft(lens, kinds)

        def dispatch(b):
            t0 = self._clock()
            self._note_issue(t0)
            out = self._strip_lane(self.engine.verify(
                self.params, self._cache, tokens, self._keys_arg(),
                self._eos, b, self._temp, self._top_k, self._top_p,
                draft_len=lens, lanes=lanes,
                adapter_ids=(self._adapter if self.engine.adapters is not None
                             else None)), feeds)
            self._cache, emitted, counts, accepted = out[:4]
            t_sync = self._clock()
            emitted, counts = emitted.cpu().numpy(), counts.cpu().numpy()
            accepted = accepted.cpu().numpy()
            # the slot program's next-token output is the overlap
            # pipeline's; here the host walk keeps _last_tok
            hid = out[-1] if self.engine.return_hidden else None
            self._merge_hidden(hid, counts)
            self.decode_dispatches += 1
            t1 = self._clock()
            self._note_sync_end(t0, t_sync, t1)
            self.latency.observe("verify", t1 - t0)
            return emitted, counts, accepted

        emitted, counts, accepted, failed = self._guarded_round(dispatch,
                                                                budget)
        self._spec_account(lens, accepted, budget, failed)
        return emitted, counts, failed

    def _decode_round(self, budget, lanes=None, feeds=()) -> tuple:
        """One ``decode_block`` round (with the lane's chunk),
        fault-isolated. Returns (tokens [slots, block], counts [slots],
        failed slots) on the host."""

        def dispatch(b):
            t0 = self._clock()
            self._note_issue(t0)
            out = self._strip_lane(self.engine.decode_block(
                self.params, self._cache, self._last_tok, self._keys_arg(),
                self._eos, b, self._temp, self._top_k, self._top_p,
                lanes=lanes,
                adapter_ids=(self._adapter if self.engine.adapters is not None
                             else None)), feeds)
            self._cache, toks, counts = out[:3]
            t_sync = self._clock()
            toks, counts = toks.cpu().numpy(), counts.cpu().numpy()
            hid = out[-1] if self.engine.return_hidden else None
            self._merge_hidden(hid, counts)
            self.decode_dispatches += 1
            t1 = self._clock()
            self._note_sync_end(t0, t_sync, t1)
            self.latency.observe("decode", t1 - t0)
            return toks, counts, None

        toks, counts, _, failed = self._guarded_round(dispatch, budget)
        return toks, counts, failed

    # ---- dispatch fault recovery ------------------------------------------

    def _cache_lost(self) -> None:
        """A failed dispatch left the cache unrestorable: every parked
        sequence is gone, so every occupied slot finishes "error" and the
        cache is emptied in place; the queue is served on. A round in
        flight and the device token row die with it."""
        self._cache = self.engine.reset_cache(self._cache)
        self._inflight = None
        self._dev_last = None
        for i, s in enumerate(self._slots):
            if s is not None:
                self._finish(i, "error")
        self._lanes[0] = None

    def _guarded_round(self, dispatch, budget) -> tuple:
        """Run one decode or verify round with fault recovery.

        ``dispatch(budget) -> (toks [n, S], counts [n], aux [n] | None)``
        runs the round for the slots whose budget row is nonzero (free
        slots always carry 0). The happy path is one retried call. If it
        still fails, the round is isolated: each occupied slot is
        dispatched alone (every other budget masked to 0) from the state
        the round started from, its generator state included, with the
        same keys and tokens. A row's logits see only its own slot's cache
        and its draw is the same at the same [slots, V] shape, so the
        slots that succeed alone emit a fault-free round's bits; the ones
        that fail alone come back in ``failed`` (the caller retires them
        "error"). After isolation the generator stands where a successful
        dispatch of the round left it. A lost cache ends the round through
        ``_cache_lost``; a lost device raises.

        Returns (toks, counts, aux, failed); the counts of failed and
        retired slots are 0."""
        gen0 = self._gen.get_state()
        try:
            toks, counts, aux = self._retried(lambda: dispatch(budget))
            return toks, counts, aux, []
        except Exception as e:  # noqa: BLE001 - recovered below or raised
            if device_lost(e):
                raise
            _log_dispatch_failure("round", "the active slots", e)
            lost = isinstance(e, CacheLost)
        n = len(self._slots)
        empty = (np.zeros((n, 1), np.int32), np.zeros(n, np.int64), None)
        if lost:
            self._cache_lost()
            return (*empty, [])
        toks_out = aux_out = None
        counts_out = np.zeros(n, np.int64)
        failed: list = []
        gen_end = None
        for i in range(n):
            if self._slots[i] is None or budget[i] <= 0:
                continue
            solo = np.zeros_like(budget)
            solo[i] = budget[i]
            self._gen.set_state(gen0)
            try:
                t, c, a = self._retried(lambda: dispatch(solo))
            except Exception as e:  # noqa: BLE001 - isolated to slot i
                if device_lost(e):
                    raise
                _log_dispatch_failure("solo", f"slot {i}", e)
                if isinstance(e, CacheLost):
                    self._gen.set_state(gen0)
                    self._cache_lost()
                    return (*empty, [])
                failed.append(i)
                continue
            gen_end = self._gen.get_state()
            if toks_out is None:
                toks_out = np.zeros_like(t)
                aux_out = None if a is None else np.zeros_like(a)
            toks_out[i] = t[i]
            counts_out[i] = c[i]
            if a is not None:
                aux_out[i] = a[i]
        self._gen.set_state(gen0 if gen_end is None else gen_end)
        if toks_out is None:  # every occupied slot failed alone
            toks_out = empty[0]
        return toks_out, counts_out, aux_out, failed

    # ---- the step ---------------------------------------------------------

    def _budgets(self) -> np.ndarray:
        """This round's budget row: each decoding slot's remaining tokens,
        0 for free and prefilling slots."""
        for i, s in enumerate(self._slots):
            self._budget[i] = (self._remaining(i)
                               if s is not None and not s.prefilling else 0)
        return self._budget.copy()

    def _deliver(self, budget, toks, counts, failed) -> None:
        """The tail of a round on the host: the slots' dispatch counts and
        the controller's tick, the failed slots retired "error", and the
        emitted tokens walked through ``_token_done`` (the device already
        stopped each row at EOS and budget; the walk applies the same rules
        on the host, and stops at a slot that retires)."""
        for i, s in enumerate(self._slots):
            if s is not None and budget[i] > 0 and i not in failed:
                s.dispatches += 1
                if self.controller is not None:
                    # after this round's counts landed; idle slots advance
                    # their cooloff
                    self.controller.after_round(i)
        for i in failed:
            if self._slots[i] is not None:
                self._finish(i, "error")
        for i in range(len(self._slots)):
            for t in toks[i, : counts[i]]:
                if self._slots[i] is None:
                    break
                self._token_done(i, int(t))

    def step(self) -> None:
        """Retire overdue slots, admit waiting requests into free slots
        (or into the lane), then advance every decoding slot by one decode
        block (or, on a speculative engine, one draft-verify round, ragged
        under the controller, or a decode block once the controller has
        turned every occupied slot off) with the lane's next chunk in the
        same dispatch, retire the slots whose dispatches failed alone, walk
        the emitted tokens and land the chunk. Under ``inference.overlap``
        the round is pipelined instead (``_step_overlap``). An engine fault
        never raises out of here, unless it lost the device."""
        if self._overlap:
            self._step_overlap()
            return
        t_step0 = self._clock()
        self._step_sync_wait = 0.0
        self._expire_deadlines()
        self._admit()
        if not any(s is not None for s in self._slots):
            return
        budget = self._budgets()
        lanes, feeds = self._lane_feed()
        self._lane_scratch = None
        lens = kinds = None
        if self.engine.spec_len > 0:
            lens, kinds = self._plan_spec()
        t0 = self._clock()
        if lens is not None:
            toks, counts, failed = self._spec_round(budget, lens, kinds,
                                                    lanes, feeds)
        else:
            toks, counts, failed = self._decode_round(budget, lanes, feeds)
        self.decode_seconds += self._clock() - t0
        self._deliver(budget, toks, counts, failed)
        self._lane_land(feeds)
        self._host_work.append(
            max(0.0, self._clock() - t_step0 - self._step_sync_wait))

    # ---- the overlap pipeline ---------------------------------------------

    def _step_overlap(self) -> None:
        """One pipelined round: expire, admit, issue round N + 1, then read
        back and deliver round N. With no slot occupied the round in
        flight drains and the pipeline empties (``busy`` covers it)."""
        t_step0 = self._clock()
        self._step_sync_wait = 0.0
        self._expire_deadlines()
        self._admit()
        t0 = self._clock()
        if not any(s is not None for s in self._slots):
            self._sync_inflight()
            self.decode_seconds += self._clock() - t0
            return
        rec = self._issue_round(self._budgets())
        self._sync_inflight()
        self._inflight = rec
        self.decode_seconds += self._clock() - t0
        self._host_work.append(
            max(0.0, self._clock() - t_step0 - self._step_sync_wait))

    def _issue_round(self, budget):
        """Build and issue one decode or verify round without waiting for
        the card: the input tokens are the device row (``_dev_tok``), the
        keys the slots' base keys, every host operand goes up through
        pinned buffers, and the round's results are copied back into
        pinned buffers behind an event. Returns the in-flight record for
        ``_sync_inflight``. A fault at issue drains the pipeline and runs
        the same round through the serial recovery (``_round_fallback``),
        delivering it at once: then None."""
        t_round = self._clock()
        lead = None if self._inflight is None else self._inflight["lead"]
        lanes, feeds = self._lane_feed()
        spec_lens = spec_kinds = None
        if self.engine.spec_len > 0:
            spec_lens, spec_kinds = self._plan_spec()
        adapter = self._adapter if self.engine.adapters is not None else None
        if spec_lens is None:
            kind, nwrite = "decode", self.engine.decode_block_len

            def issue(b, toks_in):
                return self.engine.decode_block(
                    self.params, self._cache, toks_in, self._base_keys,
                    self._eos, b, self._temp, self._top_k, self._top_p,
                    adapter_ids=adapter, lead=lead, lanes=lanes)
        else:
            kind, nwrite = "verify", self.engine.spec_len + 1
            # drafted while the card runs the round in flight, from host
            # state a round stale; column 0 is the device row
            drafts = self.engine._tokens(
                self._draft(spec_lens, spec_kinds)[:, 1:])

            def issue(b, toks_in):
                return self.engine.verify(
                    self.params, self._cache,
                    torch.cat([toks_in[:, None], drafts], dim=1),
                    self._base_keys, self._eos, b, self._temp,
                    self._top_k, self._top_p, draft_len=spec_lens,
                    adapter_ids=adapter, lead=lead, lanes=lanes)
        t0 = self._clock()
        self._note_issue(t0)
        epochs = self._epoch.copy()
        self._lane_scratch = None
        try:
            out = self._strip_lane(issue(budget, self._dev_tok()), feeds)
        except Exception as e:  # noqa: BLE001 - recovered synchronously
            if device_lost(e):
                raise
            _log_dispatch_failure("issue", "the active slots", e)
            self._sync_inflight()
            self._round_fallback(kind, budget, spec_lens, issue, feeds)
            return None
        self._cache, toks, counts = out[:3]
        accepted = out[3] if kind == "verify" else None
        self._dev_last = out[4 if kind == "verify" else 3]
        hid = out[-1] if self.engine.return_hidden else None
        first, lane_hid = self._lane_scratch or (None, None)
        self._lane_scratch = None
        self.decode_dispatches += 1
        # the read-back, queued behind this round and nothing later
        host = [None if t is None else t.to("cpu", non_blocking=True)
                for t in (toks, counts, accepted, first)]
        done = None
        if self.engine.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        return dict(kind=kind, t0=t0, budget=budget, epochs=epochs,
                    host=host, done=done, hid=hid, lane_hid=lane_hid,
                    spec_lens=spec_lens, feeds=feeds,
                    # the next issue's ensure reach: this round may advance
                    # each slot by up to lead rows before the stale host
                    # lengths catch up at its sync
                    lead=np.minimum(np.maximum(budget, 0), nwrite))

    def _round_fallback(self, kind, budget, spec_lens, issue,
                        feeds) -> None:
        """A fault at issue: with the pipeline drained (the host state is
        current), run the round's built inputs through ``_guarded_round``
        (the serial retries and isolation) and deliver it at once. The
        budget rows of seats the drain freed are masked. ``issue`` carries
        the round's lane chunk, so a re-dispatch runs it too and the land
        confirms or rewinds it."""
        occ = np.array([s is not None for s in self._slots])
        budget = np.where(occ, budget, 0).astype(budget.dtype)
        self._lane_scratch = None

        def dispatch(b):
            t0 = self._clock()
            self._note_issue(t0)
            out = self._strip_lane(issue(b, self._dev_tok()), feeds)
            self._cache, toks, counts = out[:3]
            accepted = out[3] if kind == "verify" else None
            self._dev_last = out[4 if kind == "verify" else 3]
            hid = out[-1] if self.engine.return_hidden else None
            self.decode_dispatches += 1
            t_sync = self._clock()
            outs = (toks.cpu().numpy(), counts.cpu().numpy(),
                    None if accepted is None else accepted.cpu().numpy())
            # the deferred advance lands per successful dispatch, so the
            # isolation's re-dispatches compose as the serial ones do
            self.engine.apply_advance(outs[1])
            self._merge_hidden(hid, outs[1])
            t1 = self._clock()
            self._note_sync_end(t0, t_sync, t1)
            self.latency.observe(kind, t1 - t0)
            return outs

        toks, counts, accepted, failed = self._guarded_round(dispatch,
                                                             budget)
        if kind == "verify":
            self._spec_account(spec_lens, accepted, budget, failed)
        self._deliver(budget, toks, counts, failed)
        self._lane_land(feeds)

    def _sync_inflight(self) -> None:
        """Read back the round in flight (the one wait of the pipeline, on
        its own event), drop every row whose seat epoch moved since its
        issue (a late stop or a new occupant: exactly-once delivery),
        advance the paged host lengths by the rows that stay, and deliver
        as the serial tail does, the lane's chunk included."""
        rec, self._inflight = self._inflight, None
        if rec is None:
            return
        t_sync = self._clock()
        if rec["done"] is not None:
            rec["done"].synchronize()
        toks, counts, accepted, first = rec["host"]
        toks, counts = toks.numpy(), counts.numpy()
        if accepted is not None:
            accepted = accepted.numpy()
        t1 = self._clock()
        self._note_sync_end(rec["t0"], t_sync, t1)
        live = ((rec["epochs"] == self._epoch)
                & np.array([s is not None for s in self._slots]))
        counts = np.where(live, counts, 0)
        budget = np.where(live, rec["budget"], 0)
        self.engine.apply_advance(counts)
        self._merge_hidden(rec["hid"], counts)
        self.latency.observe(rec["kind"], t1 - rec["t0"])
        if rec["kind"] == "verify":
            self._spec_account(rec["spec_lens"], accepted, budget, ())
        self._deliver(budget, toks, counts, ())
        if rec["feeds"]:
            self._lane_scratch = (first, rec["lane_hid"])
            self._lane_land(rec["feeds"])
