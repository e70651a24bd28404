"""Serving front end: a stdlib HTTP server over the port's batcher.

    python -m picotron_tpu_torch.tools.serve --config exp.json \
        --hf-path model.safetensors --port 8000

Port of ``picotron_tpu/tools/serve.py`` with the same HTTP contract:
admission control, load shedding, health surfaces, graceful drain and a
stall watchdog between ``ContinuousBatcher`` and its clients. It serves on
the CUDA card; ``main(argv, device="cpu")`` runs the plain PyTorch path on
the CPU, as the tests do.

API (all bodies JSON):

- ``POST /generate``: ``{"prompt": [ids], "max_new_tokens", "temperature",
  "top_k", "top_p", "eos_id", "timeout_s", "stream", "uid",
  "request_id", "tenant"}`` (all but ``prompt`` optional). Non-streaming:
  one JSON document with ``tokens`` and ``finish_reason``
  (``eos|length|timeout|shed|error``); 200 for served outcomes, 503 +
  ``Retry-After`` when shed, 500 on ``error``. ``"stream": true``: NDJSON
  rows ``{"event": "token", ...}`` per token, then one ``{"event":
  "done", ...}`` with the full result. ``request_id`` is echoed on every
  row (falling back to the server ``uid``).
- ``GET /healthz``: 200 while the dispatch loop makes progress, 503 once
  the watchdog sees a stall or the loop died.
- ``GET /readyz``: 200 only when accepting work; the 503 body's
  ``"state"`` is ``"draining" | "stalled" | "dead"``.
- ``GET /statz``: the batcher's ``stats()`` plus the admission
  rejections and the drain and stall state.
- ``GET /metrics``: Prometheus text of the engine's registry (engine,
  batcher and front end: the instruments ``/statz`` reads) and the
  process-wide counters (``obs.GLOBAL_REGISTRY``).
- ``GET /tenants`` / ``POST /tenants`` / ``DELETE /tenants/<name>``: the
  multi-tenant admin plane (``inference/tenancy.py``), present when a
  registry is configured (``inference.tenancy`` or
  ``--tenant-manifest``). A removed tenant's adapter slot zeroes back to
  null, so its rows in flight degrade to base output. Per-tenant quotas
  429 with ``"budget": "tenant_tokens" | "tenant_pages"``; the global
  budgets with ``"tokens" | "pages"``.
- ``POST /drain``: start a graceful drain (202, then 409).
- ``POST /kv/export`` / ``GET|POST /kv/pages`` / ``POST /kv/import`` /
  ``GET /kv/prefixes``: the prefill/decode disaggregation plane
  (``inference.role``, paged layout only; ``inference/page_transport.py``).
  ``/kv/export`` prefills a prompt with a one-token budget and returns its
  pages and first token as a transport payload; ``/kv/pages`` looks up the
  longest radix-cached prefix of ``ids``; ``/kv/import`` lands a payload
  in the local radix cache; ``/kv/prefixes?limit=N`` lists the hottest
  cached prefixes. A ``/generate`` carrying that payload as ``"kv"`` seats
  with no prefill dispatch; a payload this replica cannot use is dropped
  and counted (``picotron_handoff_dropped_total``), never a 400, and the
  request prefills here. A ``"prefill"`` replica sheds ``/generate``
  (503, ``"role"``); a ``"decode"`` one answers ``/kv/export`` 503. The
  8 MiB body cap holds for payloads too: at SmolLM-1.7B's width one bf16
  page of 16 rows is 3 MiB raw, 4 MiB in base64.

Admission (checked at POST time, in the JAX order): the prompt, the
tenant, a bounded wait for the batcher lock (503 "stalled" past it), a
dead or draining loop (503), the bounded wait queue (503), the tenant's
token and page quotas (429), the token budget (``--token-budget``,
default slots x max_seq_len) and on the paged layout the page budget
(429, after shedding queued lower-class work for a higher-class
arrival), a duplicate uid (400). Every rejection carries
``Retry-After``.

Threads: the dispatch loop is the only thread that touches the engine's
tensors (it runs ``step()`` under ``_mu``). Handlers, ``/metrics`` and
the watchdog read host state only: admission prices requests from the
host queue and the host page allocator, ``/statz`` takes ``_mu`` with a
1 s bounded wait, ``/metrics`` refreshes its gauges without it.

Not ported yet, and refused, never dropped: the span tracer and the
profiler (``/tracez``, ``/profilez``: 501; no SIGUSR2; ``--obs-dump``).

SIGTERM/SIGINT drains: readiness flips, queued requests finish "shed",
slots in flight finish, and the CLI exits 0 (1 when the loop died). A
second signal aborts. ``--smoke`` is a scripted drive on a tiny model.
"""

from __future__ import annotations

import argparse
import json
import queue
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from picotron_tpu_torch.inference import page_transport
from picotron_tpu_torch.inference.batcher import (
    ContinuousBatcher,
    GenerationResult,
    Request,
)
from picotron_tpu_torch.inference.paged_kv import PagePoolExhausted
from picotron_tpu_torch.inference.tenancy import BASE_TENANT, Tenant
from picotron_tpu_torch.models.llama import param_bytes
from picotron_tpu_torch.obs import GLOBAL_REGISTRY
from picotron_tpu_torch.resilience.preemption import PreemptionGuard

# the dispatch loop's pause between steps while a handler waits for its
# lock: long enough for a woken thread to take it
HANDOFF_S = 0.001

# what the unported surfaces answer (501 bodies)
NO_TRACER = ("the span tracer is not in the PyTorch port yet (the obs "
             "slice)")
NO_PROFILER = ("on-demand profiler captures are not in the PyTorch port yet "
               "(the obs slice)")


class AdmissionError(Exception):
    """A request rejected at the door. ``extra`` rides into the JSON error
    body: budget rejections name the budget that tripped (``"budget":
    "tokens" | "pages" | "tenant_tokens" | "tenant_pages"``), so a client
    can tell global pressure from its own quota."""

    def __init__(self, status: int, reason: str, retry_after: int = 1,
                 **extra):
        super().__init__(reason)
        self.status = status
        self.reason = reason
        self.retry_after = retry_after
        self.extra = extra


class _Waiter:
    """Per-request rendezvous between the dispatch loop and its handler
    thread: token events stream through the queue, the result ends it."""

    def __init__(self):
        self.events: queue.Queue = queue.Queue()

    def put_token(self, tok: int) -> None:
        self.events.put(("token", tok))

    def put_done(self, result) -> None:
        self.events.put(("done", result))


class FrontEnd:
    """Owns the batcher, the dispatch loop thread and the watchdog.

    ``_mu`` serializes every batcher access that mutates it (the batcher
    is not thread-safe): the handlers' admission and submit, the loop's
    ``step()`` and result draining. Leaf locks, each taken last and never
    while waiting on ``_mu``: ``_uid_mu`` (the uid counter), ``_rej_mu``
    (the rejection counters: the "stalled" shed counts precisely when
    ``_mu`` was not acquired), ``_drain_mu`` (the drain flag) and
    ``_waiting_mu`` (the count of handlers waiting for ``_mu``, for whom
    the loop pauses ``HANDOFF_S`` between steps: Python's lock is not fair,
    and the loop would take it again before a woken handler runs).
    ``guard`` is a ``PreemptionGuard``, installed by the CLI on the main
    thread; tests call ``begin_drain`` directly."""

    def __init__(self, engine, params, *, seed: int = 0,
                 max_queue: int = 64, token_budget: Optional[int] = None,
                 default_timeout_s: Optional[float] = None,
                 stall_timeout_s: float = 60.0,
                 watchdog_poll_s: float = 0.25,
                 tenants=None, log=print):
        self.engine = engine
        self.obs = engine.obs  # one registry across engine, batcher, here
        self.max_queue = int(max_queue)
        self.token_budget = int(token_budget if token_budget is not None
                                else engine.slots * engine.max_seq_len)
        self.default_timeout_s = default_timeout_s
        self.stall_timeout_s = float(stall_timeout_s)
        self.watchdog_poll_s = float(watchdog_poll_s)
        self.guard = PreemptionGuard()
        self._log = log
        self._mu = threading.Lock()
        self._uid_mu = threading.Lock()
        # handlers waiting for _mu, under their own leaf lock: the loop takes
        # _mu again right after each step, so it steps aside while one waits
        self._waiting_mu = threading.Lock()
        self._waiting = 0
        self._wake = threading.Event()
        self._waiters: dict = {}
        self._batcher = ContinuousBatcher(engine, params, seed=seed,
                                          on_token=self._on_token)
        # resident weight bytes (int8 values and scales included), set
        # once: weights never change size mid-serve
        self.weight_bytes = param_bytes(params)
        self.obs.registry.gauge(
            "picotron_weight_bytes",
            "model weight bytes resident on this replica").set(
                float(self.weight_bytes))
        # the disaggregated serving role (inference.role): "both" serves
        # colocated; "prefill" prefills and hands pages off through
        # /kv/export (its /generate sheds); "decode" seats imported pages.
        # The gauge tells a router's scrape a prefill worker from an idle
        # decode target
        self.role = engine.cfg.inference.role
        self.obs.registry.gauge(
            "picotron_serve_role",
            "serving role of this replica", role=self.role).set(1.0)
        # None: single-tenant serving, every request anonymous base
        # traffic; a registry makes unknown tenant names a 400 (a typo must
        # not dodge its quota) and admission priority-aware
        self.tenants = tenants
        self.draining = False
        self._drain_mu = threading.Lock()
        self.drain_begins = 0  # winning drain initiations (must stay 1)
        self.stopped = threading.Event()  # the dispatch loop has exited
        self.dead = False  # the loop died on an exception
        self.stalled = False
        self.stalls = 0  # stall episodes the watchdog flagged
        self.rejections = self.obs.registry.counter_dict(
            "picotron_rejections_total",
            ("queue_full", "token_budget", "page_budget", "tenant_quota",
             "draining", "stalled", "dead", "role"),
            help="admission sheds by reason", label="reason")
        self._rej_mu = threading.Lock()
        self._uid_seq = 0
        self._start_t = time.monotonic()
        self._progress_t = time.monotonic()
        self._req_t: dict = {}  # uid -> monotonic submit time (request log)
        self._threads: list = []
        self._on_drained = None  # called once the loop exits (CLI: shutdown)

    # ---- lifecycle --------------------------------------------------------

    def start(self) -> None:
        for name, fn in (("serve-dispatch", self._loop),
                         ("serve-watchdog", self._watchdog)):
            t = threading.Thread(target=fn, name=name, daemon=True)
            t.start()
            self._threads.append(t)

    @property
    def started(self) -> bool:
        return bool(self._threads)

    def begin_drain(self) -> bool:
        """Stop admitting, shed the unstarted queue, finish the slots in
        flight, then stop the dispatch loop (readiness goes 503 at once).
        Exactly one caller wins the flag under the leaf lock, however many
        initiators race (POST /drain, SIGTERM). Returns whether this
        caller won."""
        with self._drain_mu:
            first = not self.draining
            self.draining = True
            if first:
                self.drain_begins += 1
        if first:
            self._event("drain_begin")
        self._wake.set()
        return first

    def drain(self) -> dict:
        """POST /drain: begin a graceful drain over HTTP. 409 when the loop
        already exited (dead or drained) or a drain already owns the
        flag."""
        if self.dead or self.stopped.is_set():
            raise AdmissionError(
                409, "dispatch loop already exited", retry_after=0,
                state="dead" if self.dead else "stopped")
        if not self.begin_drain():
            raise AdmissionError(409, "already draining", retry_after=0,
                                 state="draining")
        return {"ok": True, "state": "draining"}

    def join(self, timeout: Optional[float] = None) -> None:
        self.stopped.wait(timeout)

    # ---- admission --------------------------------------------------------

    def submit(self, spec: dict, _internal: bool = False) -> tuple:
        """Admission-check and submit one request. Returns (uid, waiter)
        or raises AdmissionError (the handler turns it into its status).
        Reads host state only: the prices come from the prompt, the host
        queue and the host page allocator. ``_internal`` marks
        ``kv_export``'s own one-token submission, which a prefill replica
        takes although its public /generate sheds."""
        if self.role == "prefill" and not _internal:
            # a decode stream on a prefill worker is the interference the
            # role split removes; 503: the router misplaced, not the client
            self._reject("role")
            raise AdmissionError(
                503, "replica serves prefill only (inference.role: "
                     "prefill); use POST /kv/export", retry_after=5)
        prompt = spec.get("prompt")
        if not isinstance(prompt, list) or not prompt \
                or not all(isinstance(t, int) for t in prompt):
            raise AdmissionError(400, "prompt must be a non-empty list of "
                                      "token ids", retry_after=0)
        kv = spec.get("kv")
        if kv is not None:
            # the handoff payload, checked before taking a slot. One this
            # replica can never use (contiguous layout, another page
            # geometry or dtype) is dropped, not refused: the request is
            # servable by prefilling here, and a mixed fleet degrades to
            # colocated serving, never to client 400s
            if not isinstance(kv, dict):
                raise AdmissionError(400, "kv must be a transport payload "
                                          "object", retry_after=0)
            why = None
            if self.engine.paged is None:
                why = "contiguous kv_layout (no page pool)"
            else:
                try:
                    page_transport.check_spec(self.engine, kv)
                except page_transport.TransportError as e:
                    why = str(e)
            if why is not None:
                self.obs.registry.counter(
                    "picotron_handoff_dropped_total",
                    "kv payloads dropped as locally unusable").inc()
                self._event("kv_dropped", why=why[:200])
                kv = None
        tenant, slot = self._resolve_tenant(spec.get("tenant"))
        timeout_s = spec.get("timeout_s", self.default_timeout_s)
        try:
            req = Request(
                uid=str(spec.get("uid") or self._next_uid()),
                prompt=list(prompt),
                max_new_tokens=int(spec.get("max_new_tokens", 32)),
                temperature=float(spec.get("temperature", 0.0)),
                top_k=int(spec.get("top_k", 0)),
                top_p=float(spec.get("top_p", 1.0)),
                eos_id=spec.get("eos_id"),
                timeout_s=None if timeout_s is None else float(timeout_s),
                kv_import=kv,
                tenant=self._tenant_salt(tenant),
                priority=tenant.priority if tenant is not None else 1,
                adapter_slot=slot,
                ttft_slo_ms=(tenant.ttft_slo_ms if tenant is not None
                             else None),
                tpot_slo_ms=(tenant.tpot_slo_ms if tenant is not None
                             else None))
        except (TypeError, ValueError) as e:
            raise AdmissionError(400, f"bad request field: {e}",
                                 retry_after=0)
        if req.max_new_tokens < 1:
            # a zero budget never completes; a negative one corrupts the
            # token-budget arithmetic
            raise AdmissionError(400, "max_new_tokens must be >= 1",
                                 retry_after=0)
        # the window-capped commitment: reads only the engine's window
        cost = self._batcher.commitment(req)
        # bounded wait for the batcher lock: during a wedged dispatch
        # admission sheds instead of parking handler threads forever
        if not self._acquire(timeout=10.0):
            self._reject("stalled")
            raise AdmissionError(
                503, "dispatch stalled (admission unavailable)",
                retry_after=10)
        try:
            self._admit(req, tenant, cost)
            waiter = _Waiter()
            self._waiters[req.uid] = waiter
            self._req_t[req.uid] = time.monotonic()
            try:
                self._batcher.submit(req)  # validates prompt vs the window
            except ValueError as e:
                self._waiters.pop(req.uid, None)
                self._req_t.pop(req.uid, None)
                raise AdmissionError(400, str(e), retry_after=0)
        finally:
            self._mu.release()
        self._wake.set()
        return req.uid, waiter

    def _acquire(self, timeout: float) -> bool:
        """A handler's bounded wait for ``_mu``, announced to the dispatch
        loop (which yields between steps while a handler waits)."""
        with self._waiting_mu:
            self._waiting += 1
        try:
            return self._mu.acquire(timeout=timeout)
        finally:
            with self._waiting_mu:
                self._waiting -= 1

    def _admit(self, req: Request, tenant, cost: int) -> None:
        """The checks under ``_mu``, in the JAX order; raises
        AdmissionError. A positive-class arrival over a global budget
        first sheds queued strictly-lower-class work until it fits."""
        b = self._batcher
        if self.stopped.is_set():
            # nothing will ever serve it: shed instead of stranding the
            # handler on a waiter no loop completes
            self._reject("dead")
            raise AdmissionError(
                503, "dispatch loop exited (restart required)",
                retry_after=30)
        if self.draining:
            self._reject("draining")
            raise AdmissionError(
                503, "draining (restart in progress)", retry_after=5)
        if b.queue_depth >= self.max_queue:
            self._reject("queue_full")
            raise AdmissionError(
                503, f"wait queue full ({self.max_queue})",
                retry_after=max(1, self.max_queue // 8))
        # a tenant over its own quota is its own problem: it sheds no one,
        # and Retry-After scales to its own deficit
        if tenant is not None and tenant.max_tokens is not None:
            tload = b.tenant_token_load(req.tenant)
            if tload + cost > tenant.max_tokens:
                deficit = tload + cost - tenant.max_tokens
                self._reject("tenant_quota")
                raise AdmissionError(
                    429,
                    f"tenant {tenant.name!r} token quota exhausted "
                    f"({tenant.max_tokens})",
                    retry_after=min(30, 1 + deficit
                                    // max(1, tenant.max_tokens // 4)),
                    budget="tenant_tokens", tenant=tenant.name)
        paged = self.engine.paged
        if (tenant is not None and tenant.max_pages is not None
                and paged is not None):
            pneed = b.page_commitment(req)
            pload = b.tenant_page_load(req.tenant)
            if pload + pneed > tenant.max_pages:
                deficit = pload + pneed - tenant.max_pages
                self._reject("tenant_quota")
                raise AdmissionError(
                    429,
                    f"tenant {tenant.name!r} page quota exhausted "
                    f"({tenant.max_pages})",
                    retry_after=min(30, 1 + deficit
                                    // max(1, tenant.max_pages // 4)),
                    budget="tenant_pages", tenant=tenant.name)
        if b.token_load() + cost > self.token_budget:
            if req.priority > 0:
                b.shed_lower_priority(
                    req.priority,
                    tokens=b.token_load() + cost - self.token_budget)
            if b.token_load() + cost > self.token_budget:
                self._reject("token_budget")
                raise AdmissionError(
                    429, f"token budget exhausted ({self.token_budget})",
                    retry_after=1, budget="tokens")
        if paged is not None:
            # priced in pool pages, Retry-After scaled to the deficit
            need = b.page_commitment(req)
            usable = paged.usable_pages
            load = b.page_load()
            if load + need > usable and req.priority > 0:
                b.shed_lower_priority(req.priority,
                                      pages=load + need - usable)
                load = b.page_load()
            if load + need > usable:
                deficit = load + need - usable
                self._reject("page_budget")
                raise AdmissionError(
                    429,
                    f"kv page pool exhausted (need {need} of "
                    f"{usable - min(load, usable)} pages free)",
                    retry_after=min(30, 1 + deficit // max(1, usable // 4)),
                    budget="pages")
        if req.uid in self._waiters:
            raise AdmissionError(400, f"duplicate uid {req.uid!r}",
                                 retry_after=0)

    def _reject(self, key: str) -> None:
        """Count one shed under the counters' own leaf lock (reachable
        with and without ``_mu`` held)."""
        with self._rej_mu:
            self.rejections[key] += 1

    def _next_uid(self) -> str:
        with self._uid_mu:
            self._uid_seq += 1
            return f"r{self._uid_seq}"

    # ---- multi-tenant serving ---------------------------------------------

    def _resolve_tenant(self, name) -> tuple:
        """(Tenant, adapter slot) for a request's ``tenant`` field, or
        (None, 0) for anonymous traffic on a single-tenant server. Unknown
        names are a 400, never a silent base fallback."""
        if name is not None and not isinstance(name, str):
            raise AdmissionError(400, "tenant must be a string",
                                 retry_after=0)
        if self.tenants is None:
            if name:
                raise AdmissionError(
                    400, f"no tenant registry configured (got tenant "
                         f"{name!r}; set inference.tenancy or "
                         f"--tenant-manifest)", retry_after=0)
            return None, 0
        try:
            return self.tenants.resolve(name)
        except KeyError:
            raise AdmissionError(
                400, f"unknown tenant {name!r} (register via POST "
                     f"/tenants)", retry_after=0)

    @staticmethod
    def _tenant_salt(tenant) -> str:
        """The radix-domain key of a tenant; the base identity salts as ""
        (anonymous traffic shares the default domain)."""
        if tenant is None or tenant.name == BASE_TENANT:
            return ""
        return tenant.name

    def _require_tenants(self, hint: str = "") -> None:
        if self.tenants is None:
            raise AdmissionError(400, "no tenant registry configured" + hint,
                                 retry_after=0)

    def tenants_snapshot(self) -> dict:
        """GET /tenants: every registered tenant and the pack's occupancy."""
        self._require_tenants()
        out = {"tenants": self.tenants.snapshot()}
        pack = self.tenants.pack
        if pack is not None:
            out["pack"] = {"slots": pack.slots, "rank": pack.rank,
                           "version": pack.version,
                           "adapter_bytes_per_token":
                               pack.bytes_per_token()}
        return out

    def tenants_add(self, spec: dict) -> dict:
        """POST /tenants: register one tenant; its adapter lands in a free
        pack slot on the host, and the dispatch loop uploads the pack
        before its next dispatch."""
        self._require_tenants(" (start with inference.tenancy or "
                              "--tenant-manifest)")
        try:
            tenant = Tenant.from_dict(spec)
            slot = self.tenants.add(tenant)
        except (TypeError, ValueError) as e:
            # a duplicate name, a full pack or a malformed entry: 409
            raise AdmissionError(409, str(e), retry_after=0)
        self._event("tenant_add", tenant=tenant.name, slot=slot,
                    priority=tenant.priority, rank=tenant.adapter_rank)
        return {"ok": True, "tenant": tenant.name, "adapter_slot": slot}

    def tenants_remove(self, name: str) -> dict:
        """DELETE /tenants/<name>: the slot zeroes back to null, so rows in
        flight degrade to base output, never to another tenant's."""
        self._require_tenants()
        try:
            self.tenants.remove(name)
        except KeyError:
            raise AdmissionError(404, f"no tenant {name!r}", retry_after=0)
        self._event("tenant_remove", tenant=name)
        return {"ok": True, "tenant": name}

    # ---- KV-page transport (prefill/decode disaggregation) -----------------

    def _require_paged(self) -> None:
        if self.engine.paged is None:
            raise AdmissionError(
                503, "kv transport requires inference.kv_layout: 'paged' "
                     "on this replica", retry_after=0)

    def kv_export(self, spec: dict) -> dict:
        """POST /kv/export: run ``spec``'s prompt through the normal
        admission and prefill with a one-token budget (that token is the
        handoff's seat state), then serialize the prompt's radix-cached
        pages as a transport payload. A repeated prompt prefills only its
        last token. Raises AdmissionError on a shed or a failure."""
        if self.role == "decode":
            raise AdmissionError(
                503, "replica serves decode only (inference.role: "
                     "decode); export from a prefill/both replica",
                retry_after=5)
        self._require_paged()
        prompt = spec.get("prompt")
        # the tenant salts the exported chunks as it salts the domain the
        # prefill lands in (submit resolves and checks it again)
        salt = self._tenant_salt(self._resolve_tenant(
            spec.get("tenant"))[0])
        sub = dict(spec)
        sub["max_new_tokens"] = 1
        sub.pop("stream", None)
        sub.pop("kv", None)
        uid, waiter = self.submit(sub, _internal=True)
        res = _await_result(waiter)
        if res.finish_reason == "shed":
            raise AdmissionError(503, "prefill shed (draining)",
                                 retry_after=5)
        if res.finish_reason not in ("length", "eos") or not res.tokens:
            raise AdmissionError(
                500, f"prefill finished {res.finish_reason!r}",
                retry_after=1)
        first = int(res.tokens[0])
        if not self._acquire(timeout=30.0):
            raise AdmissionError(503, "dispatch stalled (export "
                                      "unavailable)", retry_after=10)
        try:
            payload = self._batcher.export_prefix(prompt,
                                                  first_token=first,
                                                  tenant=salt)
        finally:
            self._mu.release()
        self._event("kv_export", uid=uid, tokens=len(payload["token_ids"]),
                    pages=len(payload["pages"]),
                    bytes=payload["bytes_total"],
                    ttft_s=_r(res.ttft_s))
        return {"uid": uid, "kv": payload,
                "queue_wait_s": _r(res.queue_wait_s),
                "ttft_s": _r(res.ttft_s)}

    def kv_import(self, payload: dict) -> dict:
        """POST /kv/import: land a transport payload in the local pool and
        radix cache (no slot: the cross-replica prefix transfer). A later
        /generate extending it hits it with no prefill for the covered
        prefix."""
        self._require_paged()
        if not self._acquire(timeout=10.0):
            raise AdmissionError(503, "dispatch stalled (import "
                                      "unavailable)", retry_after=10)
        try:
            if self.stopped.is_set() or self.draining:
                raise AdmissionError(503, "draining (restart in progress)",
                                     retry_after=5)
            try:
                info = self._batcher.import_prefix(payload)
            except page_transport.TransportError as e:
                raise AdmissionError(400, f"bad kv payload: {e}",
                                     retry_after=0)
            except PagePoolExhausted:
                raise AdmissionError(429, "kv page pool exhausted",
                                     retry_after=5)
        finally:
            self._mu.release()
        self._event("kv_import", **info)
        return info

    def kv_pages(self, ids, tenant=None) -> dict:
        """GET/POST /kv/pages: the cross-replica prefix lookup, the longest
        radix-cached prefix of ``ids`` as a payload (no first token: a
        lookup vouches for pages, not logits); ``matched`` 0 is a miss.
        ``tenant`` scopes the lookup to its domain."""
        self._require_paged()
        salt = self._tenant_salt(self._resolve_tenant(tenant)[0])
        if (not isinstance(ids, list) or not ids
                or not all(isinstance(t, int) for t in ids)):
            raise AdmissionError(400, "ids must be a non-empty list of "
                                      "token ids", retry_after=0)
        if not self._acquire(timeout=10.0):
            raise AdmissionError(503, "dispatch stalled (lookup "
                                      "unavailable)", retry_after=10)
        try:
            payload = self._batcher.export_prefix(ids, tenant=salt)
        finally:
            self._mu.release()
        return {"matched": len(payload["token_ids"]), "kv": payload}

    def kv_prefixes(self, limit: int = 4) -> dict:
        """GET /kv/prefixes: the hottest radix-cached prefixes (token ids
        and owning tenant), hottest first: what a drain-time cache handoff
        walks. A bounded wait for the lock: a wedged dispatch makes this
        a 503, never a deadlock."""
        self._require_paged()
        if limit < 1:
            raise AdmissionError(400, f"limit must be >= 1, got {limit}",
                                 retry_after=0)
        if not self._acquire(timeout=10.0):
            raise AdmissionError(503, "dispatch stalled (enumeration "
                                      "unavailable)", retry_after=10)
        try:
            entries = self.engine.paged.radix.cached_prefixes(limit)
        finally:
            self._mu.release()
        return {"prefixes": [{"ids": list(ids), "tenant": salt or None}
                             for salt, ids in entries]}

    # ---- dispatch loop ----------------------------------------------------

    def _on_token(self, uid: str, tok: int) -> None:
        # from inside batcher.step() (under _mu), once the batcher accepted
        # the token: a stream never shows a token its result lacks
        w = self._waiters.get(uid)
        if w is not None:
            w.put_token(tok)

    def _loop(self) -> None:
        try:
            while True:
                if self.guard.triggered and not self.draining:
                    self.begin_drain()
                with self._mu:
                    if self.draining:
                        self._batcher.shed_pending()
                    if self._batcher.busy:
                        # under overlap busy covers the round in flight, so
                        # a drain waits for its sync
                        self._batcher.step()
                    results = self._batcher.take_results()
                    busy = self._batcher.busy
                self._progress_t = time.monotonic()
                if busy and self._waiting:
                    # let the waiting handlers take _mu before the next step
                    time.sleep(HANDOFF_S)
                for uid, res in results.items():
                    self._deliver(uid, res)
                if self.draining and not busy:
                    self._event("drain_done")
                    return
                if not busy:
                    self._wake.wait(0.05)
                    self._wake.clear()
        except BaseException as e:  # noqa: BLE001 - loop death is fatal news
            self._event("dispatch_loop_died",
                        error=f"{type(e).__name__}: {e}")
            # its own latch: the watchdog clears `stalled` on its next tick
            self.dead = True
            raise
        finally:
            # every still-registered waiter gets a terminal "error" result.
            # stopped is set under _mu before the snapshot, and submit checks
            # it under the same lock: every admission either saw it (503) or
            # registered before the snapshot (delivered here)
            with self._mu:
                self.stopped.set()
                stranded = list(self._waiters)
            for uid in stranded:
                self._deliver(uid, GenerationResult(uid, [], [], "error"))
            if self._on_drained is not None:
                self._on_drained()

    def _deliver(self, uid: str, res) -> None:
        # the pops under _mu (submit inserts and reads these under it); the
        # log line and the hand-off outside it
        with self._mu:
            t0 = self._req_t.pop(uid, None)
            w = self._waiters.pop(uid, None)
        self._event(
            "request", uid=uid, finish_reason=res.finish_reason,
            prompt_tokens=len(res.prompt), new_tokens=len(res.tokens),
            queue_wait_s=_r(res.queue_wait_s), ttft_s=_r(res.ttft_s),
            total_s=_r(None if t0 is None else time.monotonic() - t0))
        if w is not None:
            w.put_done(res)

    def _watchdog(self) -> None:
        """Dispatch-stall detector: while work exists the loop must keep
        finishing steps; a gap past the threshold flips ``stalled``
        (healthz 503), and the next finished step clears it."""
        if self.stall_timeout_s <= 0:
            return
        while not self.stopped.is_set():
            time.sleep(self.watchdog_poll_s)
            busy = self._batcher.busy  # racy read: a threshold, not a ledger
            age = time.monotonic() - self._progress_t
            if busy and age > self.stall_timeout_s:
                if not self.stalled:
                    self.stalled = True
                    self.stalls += 1
                    self._event("stall", age_s=_r(age),
                                threshold_s=self.stall_timeout_s)
            elif self.stalled:
                self.stalled = False
                self._event("stall_recovered")

    # ---- observability ----------------------------------------------------

    def _event(self, evt: str, **fields) -> None:
        """One structured (JSON) log line per server event."""
        self._log(json.dumps({"evt": evt, "t": round(time.time(), 3),
                              **fields}), flush=True)

    def metrics_text(self) -> str:
        """Prometheus text: the server's registry, then the process-wide
        counters. No lock: every instrument reads under its own leaf lock,
        and the gauge refresh reads host state only."""
        self._batcher.refresh_gauges()
        self.obs.registry.gauge(
            "picotron_prefill_queue_depth",
            "requests waiting for a prefill slot").set(
                self._batcher.queue_depth)
        return self.obs.registry.prometheus() + GLOBAL_REGISTRY.prometheus()

    def healthy(self) -> bool:
        return not (self.stalled or self.dead)

    def ready(self) -> bool:
        return not (self.draining or self.stalled or self.dead)

    def stats(self) -> dict:
        # bounded wait: during a stall this answers, degraded, rather than
        # park on the lock the stalled loop holds
        if self._acquire(timeout=1.0):
            try:
                d = self._batcher.stats()
            finally:
                self._mu.release()
        else:
            d = {"snapshot": "partial (dispatch in progress)"}
        with self._rej_mu:
            d["rejected"] = dict(self.rejections)
        d["weight_bytes"] = self.weight_bytes
        d["weight_dtype"] = self.engine.weight_dtype
        d["role"] = self.role
        if self.tenants is not None:
            d["tenant_names"] = self.tenants.names()
        d["draining"] = self.draining
        d["dead"] = self.dead
        d["stalled"] = self.stalled
        d["stalls"] = self.stalls
        d["uptime_s"] = round(time.monotonic() - self._start_t, 3)
        return d


def _r(v: Optional[float]) -> Optional[float]:
    return None if v is None else round(v, 6)


MAX_BODY_BYTES = 8 << 20  # request-body cap: reject before allocating


_POST_UNPORTED = {"/profilez": NO_PROFILER}
_POST_KV = ("/kv/export", "/kv/import", "/kv/pages")


class _Handler(BaseHTTPRequestHandler):
    # close-delimited streaming: an HTTP/1.0 response ends at connection
    # close, so the token stream flushes row by row with no framing
    protocol_version = "HTTP/1.0"

    @property
    def front(self) -> FrontEnd:
        return self.server.front

    def log_message(self, *a):  # the front end's JSON lines replace these
        pass

    def _json(self, status: int, payload: dict, headers=()) -> None:
        body = (json.dumps(payload) + "\n").encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _error(self, e: AdmissionError, shed: bool = False) -> None:
        headers = ([("Retry-After", str(e.retry_after))]
                   if e.retry_after else [])
        self._json(e.status, {"error": e.reason,
                              **({"shed": True} if shed else {}),
                              **e.extra}, headers)

    def do_GET(self) -> None:
        f = self.front
        path = self.path
        if path == "/healthz":
            ok = f.healthy()
            self._json(200 if ok else 503,
                       {"ok": ok, "stalled": f.stalled, "dead": f.dead})
        elif path == "/readyz":
            # "state" tells a GRACEFUL drain (stop placing) from a failure
            ok = f.ready()
            state = ("dead" if f.dead else "stalled" if f.stalled
                     else "draining" if f.draining else "ready")
            self._json(200 if ok else 503,
                       {"ok": ok, "state": state, "role": f.role,
                        "draining": f.draining,
                        "stalled": f.stalled, "dead": f.dead})
        elif path == "/statz":
            self._json(200, f.stats())
        elif path == "/metrics":
            body = f.metrics_text().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif path == "/tracez":
            self._json(501, {"error": NO_TRACER})
        elif path.startswith("/kv/pages"):
            # GET /kv/pages?ids=1,2,3[&tenant=name]: the lookup for short
            # prompts (POST takes a JSON body for long ones)
            q = parse_qs(urlparse(path).query)
            try:
                ids = [int(t) for t in q.get("ids", [""])[0].split(",")
                       if t]
            except ValueError as e:
                self._json(400, {"error": f"bad ids: {e}"})
                return
            try:
                self._json(200, f.kv_pages(
                    ids, tenant=q.get("tenant", [None])[0]))
            except AdmissionError as e:
                self._error(e)
        elif path.startswith("/kv/prefixes"):
            q = parse_qs(urlparse(path).query)
            try:
                limit = int(q.get("limit", ["4"])[0])
            except ValueError as e:
                self._json(400, {"error": f"bad limit: {e}"})
                return
            try:
                self._json(200, f.kv_prefixes(limit))
            except AdmissionError as e:
                self._error(e)
        elif path == "/tenants":
            try:
                self._json(200, f.tenants_snapshot())
            except AdmissionError as e:
                self._error(e)
        else:
            self._json(404, {"error": f"unknown path {self.path}"})

    def do_DELETE(self) -> None:
        if not self.path.startswith("/tenants/"):
            self._json(404, {"error": f"unknown path {self.path}"})
            return
        from urllib.parse import unquote

        name = unquote(self.path[len("/tenants/"):])
        try:
            self._json(200, self.front.tenants_remove(name))
        except AdmissionError as e:
            self._error(e)

    def do_POST(self) -> None:
        if self.path not in ("/generate", "/tenants", "/drain",
                             *_POST_UNPORTED, *_POST_KV):
            self._json(404, {"error": f"unknown path {self.path}"})
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
        except ValueError as e:
            self._json(400, {"error": f"bad Content-Length: {e}"})
            return
        if n < 0:
            self._json(400, {"error": f"bad Content-Length: {n}"})
            return
        if n > MAX_BODY_BYTES:
            # cap the declared length BEFORE allocating for it
            self._json(413, {"error": f"request body too large "
                                      f"({n} > {MAX_BODY_BYTES} bytes)"})
            return
        try:
            spec = json.loads(self.rfile.read(n) or b"{}")
        except (ValueError, json.JSONDecodeError) as e:
            self._json(400, {"error": f"bad request body: {e}"})
            return
        if not isinstance(spec, dict):
            self._json(400, {"error": "request body must be a JSON object"})
            return
        if self.path in _POST_UNPORTED:
            self._json(501, {"error": _POST_UNPORTED[self.path]})
            return
        if self.path == "/drain":
            try:
                self._json(202, self.front.drain())
            except AdmissionError as e:
                self._error(e)
            return
        if self.path == "/tenants":
            try:
                self._json(200, self.front.tenants_add(spec))
            except AdmissionError as e:
                self._error(e)
            return
        if self.path in _POST_KV:
            f = self.front
            try:
                if self.path == "/kv/export":
                    out = f.kv_export(spec)
                elif self.path == "/kv/import":
                    out = f.kv_import(spec.get("kv") or spec)
                else:
                    out = f.kv_pages(spec.get("ids"),
                                     tenant=spec.get("tenant"))
            except AdmissionError as e:
                self._error(e)
                return
            self._json(200, out)
            return
        try:
            uid, waiter = self.front.submit(spec)
        except AdmissionError as e:
            self._error(e, shed=True)
            return
        # the client's correlation id, echoed on every row
        rid = str(spec.get("request_id") or uid)
        if spec.get("stream"):
            self._stream(uid, waiter, rid)
            return
        res = _await_result(waiter)
        payload = {"uid": uid, "request_id": rid,
                   "tokens": list(res.tokens),
                   "finish_reason": res.finish_reason,
                   "queue_wait_s": _r(res.queue_wait_s),
                   "ttft_s": _r(res.ttft_s)}
        if res.finish_reason == "shed":
            self._json(503, payload, [("Retry-After", "5")])
        elif res.finish_reason == "error":
            self._json(500, payload)
        else:
            self._json(200, payload)

    def _stream(self, uid: str, waiter: _Waiter, request_id: str) -> None:
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.end_headers()
        while True:
            kind, val = waiter.events.get()
            if kind == "token":
                row = {"event": "token", "uid": uid,
                       "request_id": request_id, "token": int(val)}
            else:
                row = {"event": "done", "uid": uid,
                       "request_id": request_id,
                       "tokens": list(val.tokens),
                       "finish_reason": val.finish_reason,
                       "queue_wait_s": _r(val.queue_wait_s),
                       "ttft_s": _r(val.ttft_s)}
            try:
                self.wfile.write((json.dumps(row) + "\n").encode())
                self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                # the client left: the batcher still owns the request (its
                # timeout_s bounds the waste); drain the events to the end
                pass
            if kind == "done":
                return


def _await_result(waiter: _Waiter):
    while True:
        kind, val = waiter.events.get()
        if kind == "done":
            return val


class Server:
    """FrontEnd + ThreadingHTTPServer, both on background threads: the
    embedding entry point of the CLI, the smoke drive and the tests.
    ``start()`` serves; ``serve_http()`` alone opens the socket without
    starting the dispatch loop (``front.start()`` starts it later)."""

    def __init__(self, engine, params, *, host: str = "127.0.0.1",
                 port: int = 0, **front_kw):
        self.front = FrontEnd(engine, params, **front_kw)
        self.httpd = ThreadingHTTPServer((host, port), _Handler)
        self.httpd.front = self.front
        self.port = self.httpd.server_address[1]
        self._http_thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self.serve_http()
        self.front.start()

    def serve_http(self) -> None:
        # once the dispatch loop has exited, stop accepting sockets
        self.front._on_drained = lambda: threading.Thread(
            target=self.httpd.shutdown, daemon=True).start()
        self._http_thread = threading.Thread(
            target=self.httpd.serve_forever, name="serve-http", daemon=True)
        self._http_thread.start()

    def close(self, timeout: Optional[float] = None) -> None:
        """Stop the socket thread (if it runs) and close the socket."""
        if self._http_thread is not None:
            self.httpd.shutdown()
            self._http_thread.join(timeout)
        self.httpd.server_close()

    def drain_and_join(self, timeout: Optional[float] = None) -> None:
        self.front.begin_drain()
        if self.front.started:
            self.front.join(timeout)
        self.close(timeout)


# --------------------------------------------------------------------------- #
# CLI
# --------------------------------------------------------------------------- #

# --smoke's model: one that kernels A, B and C take on the card (head_dim
# 64, bf16, flash prefill and decode); fp32 on the CPU
SMOKE_CONFIG = {
    "model": dict(
        name="tiny-smoke", num_hidden_layers=4, num_attention_heads=8,
        num_key_value_heads=4, hidden_size=512, intermediate_size=1024,
        vocab_size=256, max_position_embeddings=128, dtype="bfloat16",
        attention_impl="flash"),
    "inference": {"attend_impl": "flash"},
}


def _build(args, ap, device):
    """(engine, params, registry) from the parsed arguments."""
    from picotron_tpu_torch.config import Config
    from picotron_tpu_torch.inference import tenancy
    from picotron_tpu_torch.inference.engine import InferenceEngine
    from picotron_tpu_torch.resilience.chaos import ServingChaos
    from picotron_tpu_torch.tools.generate import _load_weights
    from picotron_tpu_torch.utils import resolve_device

    dev = resolve_device(device)
    if args.smoke:
        raw = json.loads(json.dumps(SMOKE_CONFIG))
        if dev.type == "cpu":
            raw["model"]["dtype"] = "float32"
        cfg = Config.from_dict(raw)
        args.random_init = True
    elif args.config:
        cfg = Config.from_json(args.config)
    else:
        ap.error("pass --config (or --smoke)")
    if sum(map(bool, (args.load_path, args.hf_path, args.random_init))) != 1:
        ap.error("pass exactly one of --load-path / --hf-path / "
                 "--random-init")
    if args.load_path and cfg.resilience.ckpt_mirror_dir:
        ap.error("resilience.ckpt_mirror_dir: the PyTorch port keeps no "
                 "checkpoint mirror tier yet; --load-path reads the "
                 "directory it is given")
    if args.kv_layout:
        cfg.inference.kv_layout = args.kv_layout
    if args.role:
        cfg.inference.role = args.role
    if args.overlap:
        # the pipelined scheduler; streams stay the serial ones
        cfg.inference.overlap = True
    try:
        cfg.validate()
    except ValueError as e:
        ap.error(str(e))
    chaos = ServingChaos(cfg.resilience)
    adapters, registry = tenancy.build_tenancy(cfg, args.tenant_manifest)
    engine = InferenceEngine(cfg, dev, slots=args.slots,
                             max_seq_len=args.max_seq_len,
                             hooks=chaos if chaos.active else None,
                             adapters=adapters)
    params = _load_weights(args, engine, engine.weight_dtype)
    return engine, params, registry


def _request(port: int, method: str, path: str, body=None,
             timeout: float = 300.0):
    """Stdlib client for the smoke drive: (status, body text)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path,
                     None if body is None else json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read().decode("utf-8", errors="replace")
    finally:
        conn.close()


def _call(port: int, method: str, path: str, body=None):
    """(status, parsed JSON body)."""
    st, text = _request(port, method, path, body)
    return st, json.loads(text or "{}")


def _smoke(server: Server) -> int:
    """The scripted drive: health, one POST, the same POST streamed,
    ``/metrics`` agreeing with ``/statz``, the refused surfaces' 501s, with
    ``--overlap`` the gap check, then a SIGTERM drain with a streamed
    request in flight and full accounting. Returns an exit code."""
    import http.client
    import os
    import signal

    from picotron_tpu_torch.obs import parse_prometheus

    port = server.port
    fail = []

    def check(name, ok):
        print(f"serve-smoke: {name}: {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail.append(name)

    check("healthz", _call(port, "GET", "/healthz")[0] == 200)
    check("readyz", _call(port, "GET", "/readyz")[0] == 200)

    spec = {"prompt": [1, 2, 3, 4, 5], "max_new_tokens": 8}
    st, body = _call(port, "POST", "/generate", spec)
    check("generate", st == 200 and len(body.get("tokens", ())) == 8
          and body.get("finish_reason") == "length")
    st, text = _request(port, "POST", "/generate", {**spec, "stream": True})
    rows = [json.loads(line) for line in text.splitlines() if line]
    done = [r for r in rows if r["event"] == "done"]
    toks = [r["token"] for r in rows if r["event"] == "token"]
    check("stream", st == 200 and len(done) == 1
          and done[0]["tokens"] == toks
          and toks == body.get("tokens"))  # greedy: the same tokens

    st, stats = _call(port, "GET", "/statz")
    mst, mtext = _request(port, "GET", "/metrics")
    prom = parse_prometheus(mtext)
    check("metrics_agrees_with_statz",
          st == mst == 200
          and prom.get('picotron_requests_total{state="completed"}')
          == stats.get("completed")
          and prom.get("picotron_generated_tokens_total")
          == stats.get("generated_tokens"))
    check("tracez_refused", _call(port, "GET", "/tracez")[0] == 501)
    check("profilez_refused",
          _call(port, "POST", "/profilez", {"seconds": 0.2})[0] == 501)
    ov = stats.get("overlap", {})
    if ov.get("enabled"):
        # a full pipeline issues each round while the last is in flight:
        # its gap falls below the host's read-back wait it used to follow
        gap = (ov.get("dispatch_gap_s") or {}).get("p50")
        check("overlap_gap_lt_host_sync",
              gap is not None
              and gap < max(stats.get("last_host_sync_s", 0.0), 1e-6))

    # drain: a streamed request in flight (its first token seen) + SIGTERM
    # -> it finishes, admission stops, the loop exits cleanly
    slow: dict = {}
    first = threading.Event()

    def bg():
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        try:
            conn.request("POST", "/generate", json.dumps(
                {"prompt": [7, 8, 9], "max_new_tokens": 24,
                 "stream": True}))
            resp = conn.getresponse()
            slow["status"] = resp.status
            while True:
                line = resp.readline()
                if not line:
                    break
                row = json.loads(line)
                if row["event"] == "token":
                    first.set()
                else:
                    slow["done"] = row
        finally:
            first.set()
            conn.close()

    t = threading.Thread(target=bg)
    t.start()
    check("slow_request_in_flight", first.wait(120))
    os.kill(os.getpid(), signal.SIGTERM)
    server.front.join(timeout=120)
    check("drain_finished", server.front.stopped.is_set())
    t.join(timeout=120)
    done = slow.get("done") or {}
    check("inflight_served_through_drain",
          slow.get("status") == 200 and done.get("finish_reason") == "length"
          and len(done.get("tokens", ())) == 24)
    stats = server.front.stats()
    terminal = stats["completed"] + stats["expired"] + stats["errored"]
    check("accounting", terminal == stats["admitted"] == 3
          and stats["queued"] == 0 and stats["active_slots"] == 0)
    check("no_stalls", stats["stalls"] == 0)
    return 1 if fail else 0


def main(argv=None, device=None) -> int:
    """CLI entry. ``device`` (not a flag: the CLI serves on the card) lets
    a caller run the server on the CPU with ``device="cpu"``."""
    ap = argparse.ArgumentParser(
        description="HTTP serving front end over the PyTorch port's "
                    "continuous batcher (admission control, load "
                    "shedding, graceful drain)")
    ap.add_argument("--config", help="experiment config.json (model shape, "
                                     "inference)")
    ap.add_argument("--load-path", default="",
                    help="the port's training checkpoint directory")
    ap.add_argument("--hf-path", default="",
                    help="HF-format safetensors file or directory")
    ap.add_argument("--random-init", action="store_true",
                    help="seed-derived random weights (smoke)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000,
                    help="0 = ephemeral (printed in the 'serving' line)")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max-seq-len", type=int, default=None)
    ap.add_argument("--role", choices=("prefill", "decode", "both"),
                    default=None,
                    help="disaggregated serving role (overrides "
                         "inference.role; prefill/decode require "
                         "inference.kv_layout: paged)")
    ap.add_argument("--kv-layout", choices=("contiguous", "paged"),
                    default=None, help="KV cache layout override")
    ap.add_argument("--overlap", action="store_true",
                    help="pipelined scheduling: issue round N+1 before "
                         "reading round N back (sets inference.overlap; "
                         "the same streams)")
    ap.add_argument("--max-queue", type=int, default=64,
                    help="bounded wait queue: excess submissions get 503")
    ap.add_argument("--token-budget", type=int, default=None,
                    help="cap on live prompt+generation tokens (default: "
                         "slots * max_seq_len); excess gets 429")
    ap.add_argument("--default-timeout-s", type=float, default=None,
                    help="per-request wall-clock deadline when the request "
                         "sets none (finish_reason 'timeout')")
    ap.add_argument("--stall-timeout", type=float, default=60.0,
                    help="dispatch-stall watchdog threshold (0 = off); a "
                         "stall flips /healthz to 503")
    ap.add_argument("--tenant-manifest", default="",
                    help="JSON tenant manifest ({\"tenants\": [...]}) — "
                         "overrides inference.tenancy.manifest; enables "
                         "the adapter pack, /tenants and per-tenant "
                         "quotas and SLOs")
    ap.add_argument("--smoke", action="store_true",
                    help="built-in tiny model + scripted client drive")
    ap.add_argument("--obs-dump", default="",
                    help="save the smoke's trace and metrics (needs the "
                         "span tracer: refused)")
    args = ap.parse_args(argv)
    if args.obs_dump:
        ap.error(f"--obs-dump: {NO_TRACER}")

    engine, params, registry = _build(args, ap, device)
    server = Server(
        engine, params, host=args.host,
        port=0 if args.smoke else args.port, seed=args.seed,
        max_queue=args.max_queue, token_budget=args.token_budget,
        default_timeout_s=args.default_timeout_s,
        stall_timeout_s=args.stall_timeout, tenants=registry)
    # SIGTERM/SIGINT -> graceful drain; installed on the main thread
    server.front.guard.install()
    try:
        server.start()
        server.front._event(
            "serving", port=server.port, slots=engine.slots,
            max_seq_len=engine.max_seq_len, max_queue=args.max_queue,
            token_budget=server.front.token_budget,
            attend_impl=engine.attend_impl, role=server.front.role,
            kv=str(engine.cache_dtype).removeprefix("torch."),
            kv_layout=engine.kv_layout, tp=1,
            device=str(engine.device),
            tenants=(registry.names() if registry is not None else None))
        if args.smoke:
            rc = _smoke(server)
            print(f"serve-smoke: {'PASS' if rc == 0 else 'FAIL'}",
                  flush=True)
            return rc
        # foreground: wait for the drain. 0 only for a clean drain: a dead
        # loop exits 1, so a supervisor restarts the replica
        try:
            while not server.front.stopped.is_set():
                server.front.join(timeout=1.0)
        except KeyboardInterrupt:
            pass  # second signal: abort now
        return 1 if server.front.dead else 0
    finally:
        server.front.guard.uninstall()
        server.close(timeout=10.0)


if __name__ == "__main__":
    sys.exit(main())
