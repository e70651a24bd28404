"""The port's HTTP front end (``picotron_tpu_torch/tools/serve.py``) against
the JAX package's, on the CPU.

Weights are drawn by the JAX package (a tiny fp32 model) and carried across
with ``convert.params_from_jax``; both servers run the per-slot key schedule
(``inference.key_schedule: "slot"``) with one LoRA tenant in a four-slot
pack. Requests go to one server and then the other, each after the last
one's answer, so both admit the same sequence:

- the same POSTs, greedy and sampled (temperature 0.8, top-p 0.9), streamed
  and not, give the same tokens, finish reasons and statuses, and a tenant
  hot-added through ``POST /tenants`` the same tokens as on the JAX server;
- ``FrontEnd.submit`` with the dispatch loop not started gives the same
  statuses, ``"budget"``/``"tenant"`` fields, ``Retry-After`` and
  rejection counters for every admission rule; the HTTP body checks (413,
  a non-object body) the same answers;
- ``/metrics`` agrees with ``/statz``, and with the JAX page for every
  family the port writes.

The port's own cases hold a request in flight with an engine ``hooks``
object whose ``before_dispatch`` blocks on an event the test sets (never a
sleep): the drain (``/readyz`` "draining", the queued request shed with 503
and ``Retry-After: 5``, the one in flight served, ``/drain`` 202 then
409), a dispatch loop that dies (stranded streams get "error", 409
"dead", admission sheds), the stall watchdog, the refused surfaces (501;
the /kv plane and a ``"kv"`` payload as the JAX server answers them), and
the CLI in a subprocess (``--smoke``; a served POST, then
SIGTERM and exit 0). Every wait is bounded and every server is drained and
closed.
"""

import http.client
import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from conftest import make_config
from picotron_tpu.inference import InferenceEngine as JaxEngine
from picotron_tpu.inference import tenancy as jax_tenancy
from picotron_tpu.models import llama as jax_llama
from picotron_tpu.tools import serve as jax_serve
from picotron_tpu_torch import convert
from picotron_tpu_torch.config import Config
from picotron_tpu_torch.inference import tenancy
from picotron_tpu_torch.inference.engine import InferenceEngine
from picotron_tpu_torch.obs import GLOBAL_REGISTRY, parse_prometheus
from picotron_tpu_torch.tools import serve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = dict(num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, hidden_size=32, intermediate_size=64,
             vocab_size=128, max_position_embeddings=96, rope_theta=10000.0,
             dtype="float32", attention_impl="sdpa")
MAX_LEN = 96
SLOTS = 3
ACME = {"name": "acme", "adapter_rank": 4, "adapter_seed": 1,
        "priority": 2}
GLOBEX = {"name": "globex", "adapter_rank": 2, "adapter_seed": 2,
          "adapter_scale": 0.5, "priority": 1}
WAIT_S = 60.0  # the bound on every wait in this file


@pytest.fixture(autouse=True)
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _quiet(*a, **k):
    pass


def _port_cfg(**inf) -> Config:
    return Config.from_dict({"model": MODEL, "inference": {
        "decode_block_len": 4, "prefill_chunk": 8, "attend_impl": "flash",
        "key_schedule": "slot", "kv_page_len": 8, **inf}})


def _port_engine(slots=SLOTS, hooks=None, adapters=None, **inf):
    return InferenceEngine(_port_cfg(**inf), "cpu", slots=slots,
                           max_seq_len=MAX_LEN, hooks=hooks,
                           adapters=adapters)


def _jax_engine(jcfg, slots=SLOTS, adapters=None, **inf):
    for k, v in inf.items():
        setattr(jcfg.inference, k, v)
    return JaxEngine(jcfg, slots=slots, max_seq_len=MAX_LEN,
                     decode_block_len=4, prefill_chunk=8,
                     attend_impl="dense", key_schedule="slot",
                     adapters=adapters)


@pytest.fixture(scope="module")
def tiny():
    """(JAX config, JAX params, port params)."""
    jcfg = make_config(MODEL, seq=MAX_LEN)
    jparams = jax.jit(lambda k: jax_llama.init_params(k, jcfg.model))(
        jax.random.PRNGKey(0))
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, params


def _jax_tenants(jcfg):
    pack = jax_tenancy.AdapterPack(jcfg.model, slots=4, rank=4)
    reg = jax_tenancy.TenantRegistry(pack)
    reg.add(jax_tenancy.Tenant.from_dict(ACME))
    return pack, reg


@pytest.fixture(scope="module")
def servers(tiny):
    """The JAX server and the port's, started, over the same weights and
    the same tenant; drained and closed at the end of the module."""
    jcfg, jparams, params = tiny
    jpack, jreg = _jax_tenants(make_config(MODEL, seq=MAX_LEN))
    jeng = _jax_engine(make_config(MODEL, seq=MAX_LEN), adapters=jpack)
    pack, reg = tenancy.build_tenancy(_port_cfg(tenancy={
        "tenants": [ACME], "adapter_slots": 4, "adapter_rank": 4}))
    peng = _port_engine(adapters=pack)
    js = jax_serve.Server(jeng, jeng.shard_params(jparams), tenants=jreg,
                          log=_quiet)
    ps = serve.Server(peng, params, tenants=reg, log=_quiet)
    try:
        js.start()
        ps.start()
        yield js, ps
    finally:
        for s in (ps, js):
            s.drain_and_join(timeout=WAIT_S)


# --------------------------------------------------------------------------- #
# a stdlib client with bounded waits
# --------------------------------------------------------------------------- #


def _http(port, method, path, body=None, headers=None):
    """(status, headers, parsed JSON or text) of one request."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT_S)
    try:
        data = body if isinstance(body, (bytes, type(None))) \
            else json.dumps(body)
        conn.request(method, path, data, headers or {})
        resp = conn.getresponse()
        text = resp.read().decode()
        try:
            out = json.loads(text)
        except ValueError:
            out = text
        return resp.status, dict(resp.getheaders()), out
    finally:
        conn.close()


TIMES = ("queue_wait_s", "ttft_s")  # wall-clock fields, never compared


def _post(port, spec):
    """A /generate POST: (status, Retry-After, result without its times)
    where a streamed result is (token rows, done rows)."""
    st, hdr, out = _http(port, "POST", "/generate", spec)
    if spec.get("stream"):
        rows = [json.loads(line) for line in out.splitlines() if line]
        out = ([r["token"] for r in rows if r["event"] == "token"],
               [{k: v for k, v in r.items() if k not in TIMES}
                for r in rows if r["event"] == "done"])
    elif isinstance(out, dict):
        out = {k: v for k, v in out.items() if k not in TIMES}
    return st, hdr.get("Retry-After"), out


def _stream_in_thread(port, spec, first=None):
    """Start a streamed POST on its own thread; returns (thread, out dict
    with "status", "tokens", "done"). ``first`` is set at the first row."""
    out = {"tokens": []}

    def run():
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT_S)
        try:
            conn.request("POST", "/generate", json.dumps(
                {**spec, "stream": True}))
            resp = conn.getresponse()
            out["status"] = resp.status
            while True:
                line = resp.readline()
                if not line:
                    break
                row = json.loads(line)
                if row["event"] == "token":
                    out["tokens"].append(row["token"])
                else:
                    out["done"] = row
                if first is not None:
                    first.set()
        finally:
            conn.close()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, out


def _post_in_thread(port, spec):
    out = {}

    def run():
        out["resp"] = _post(port, spec)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, out


def _until(cond, what):
    """Wait (bounded) for a condition that, once true, stays true until the
    test acts: a request the loop cannot consume yet, a gate held."""
    deadline = time.monotonic() + WAIT_S
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)


# --------------------------------------------------------------------------- #
# parity with the JAX server over HTTP
# --------------------------------------------------------------------------- #


def _specs(temperature, stream, tag):
    k = dict(top_p=0.9) if temperature > 0 else {}
    return [{"prompt": [5, 9, 5, 9, 5], "max_new_tokens": 9,
             "temperature": temperature, "stream": stream,
             "request_id": f"{tag}-a", **k},
            {"prompt": [7, 3, 7], "max_new_tokens": 6, "eos_id": 3,
             "temperature": temperature, "stream": stream, **k},
            {"prompt": [11, 12, 11, 12, 11, 12, 11, 12], "max_new_tokens": 7,
             "temperature": temperature, "stream": stream,
             "tenant": "acme", **k}]


def _both(servers, spec):
    """The same POST to the JAX server, then the port's: (jax, port)."""
    js, ps = servers
    return _post(js.port, spec), _post(ps.port, spec)


def test_streams_match_the_jax_server(servers):
    """Greedy and sampled, streamed and not, a base request, one with an
    EOS id and one under a tenant's adapter: the same tokens, finish
    reasons and statuses; a stream's token rows are its done row's tokens
    and the same as the non-streamed result of the JAX server."""
    for temperature in (0.0, 0.8):
        for stream in (False, True):
            for spec in _specs(temperature, stream, f"{temperature}{stream}"):
                want, got = _both(servers, spec)
                assert got == want, spec
                st, _, out = got
                assert st == 200
                if stream:
                    toks, done = out
                    assert len(done) == 1 and done[0]["tokens"] == toks
                    assert done[0]["request_id"] == spec.get(
                        "request_id", done[0]["uid"])
                    assert done[0]["finish_reason"] in ("length", "eos")
                else:
                    assert out["finish_reason"] in ("length", "eos")
                    assert out["request_id"] == spec.get("request_id",
                                                         out["uid"])


def test_tenants_hot_add_list_and_remove_match_jax(servers):
    """POST /tenants adds globex to both servers (the same pack slot), its
    greedy and sampled tokens equal the JAX server's and differ from the
    base model's, GET /tenants lists the same tenants and slots, and
    after DELETE a request naming it is a 400 on both."""
    js, ps = servers
    add = [_http(s.port, "POST", "/tenants", GLOBEX) for s in (js, ps)]
    assert add[0][::2] == add[1][::2] == (
        200, {"ok": True, "tenant": "globex", "adapter_slot": 2})
    lists = [_http(s.port, "GET", "/tenants")[2] for s in (js, ps)]
    assert [(t["name"], t["adapter_slot"]) for t in lists[1]["tenants"]] \
        == [(t["name"], t["adapter_slot"]) for t in lists[0]["tenants"]] \
        == [("acme", 1), ("globex", 2)]
    assert lists[1]["pack"] == lists[0]["pack"]
    spec = {"prompt": [21, 22, 23, 24], "max_new_tokens": 8}
    for extra in ({"tenant": "globex"}, {"tenant": "globex",
                                         "temperature": 0.8, "top_p": 0.9}):
        want, got = _both(servers, {**spec, **extra})
        assert got == want and got[0] == 200
    base = _both(servers, spec)
    assert base[0] == base[1]
    tenant = _both(servers, {**spec, "tenant": "globex"})
    assert tenant[1][2]["tokens"] != base[1][2]["tokens"]
    assert _http(js.port, "POST", "/tenants", GLOBEX)[0] \
        == _http(ps.port, "POST", "/tenants", GLOBEX)[0] == 409
    for s in (js, ps):
        assert _http(s.port, "DELETE", "/tenants/globex")[::2] == (
            200, {"ok": True, "tenant": "globex"})
        assert _http(s.port, "DELETE", "/tenants/globex")[0] == 404
    gone = _both(servers, {**spec, "tenant": "globex"})
    assert gone[0] == gone[1] and gone[1][0] == 400


def _families(text) -> dict:
    """Parsed samples of a Prometheus page, without the histograms' bucket
    and sum lines (wall-clock values) and the process-wide counters."""
    glob = {line.split()[2] for line in GLOBAL_REGISTRY.prometheus()
            .splitlines() if line.startswith("# TYPE")}
    glob |= {"picotron_retries_total", "picotron_emergency_saves_total"}
    return {k: v for k, v in parse_prometheus(text).items()
            if not k.split("{")[0].endswith(("_bucket", "_sum"))
            and k.split("{")[0] not in glob}


def test_metrics_agree_with_statz_and_the_jax_page(servers):
    """After the same traffic (and one shed at the door on each), the
    port's /metrics holds /statz's request counts, generated tokens and
    rejections, and the JAX page holds the same value for every sample
    the port writes (histograms by their counts)."""
    js, ps = servers
    for spec in ({"prompt": [3, 4, 5], "max_new_tokens": 5},
                 {"prompt": [3, 4], "max_new_tokens": 5, "tenant": "acme",
                  "temperature": 0.8},
                 {"prompt": [3], "max_new_tokens": 10 ** 6}):
        want, got = _both(servers, spec)
        assert got == want
    pages = [_http(s.port, "GET", "/metrics")[2] for s in (js, ps)]
    st, _, stats = _http(ps.port, "GET", "/statz")
    prom = parse_prometheus(pages[1])
    assert st == 200 and stats["completed"] > 0
    for state in ("admitted", "completed", "expired", "errored", "shed"):
        assert prom[f'picotron_requests_total{{state="{state}"}}'] \
            == stats[state]
    assert prom["picotron_generated_tokens_total"] \
        == stats["generated_tokens"]
    for reason, n in stats["rejected"].items():
        assert prom[f'picotron_rejections_total{{reason="{reason}"}}'] == n
    assert stats["ttft_s"]["n"] == prom["picotron_ttft_seconds_count"]
    ours, theirs = _families(pages[1]), _families(pages[0])
    missing = sorted(set(ours) - set(theirs))
    assert not missing, missing
    assert {k: v for k, v in ours.items() if theirs[k] != v} == {}
    for fam in ("picotron_dispatch_total", "picotron_tenant_requests_total",
                "picotron_tenant_tokens_total", "picotron_queue_depth",
                "picotron_weight_bytes", "picotron_serve_role",
                "picotron_shard_occupancy", "picotron_ttft_seconds_count"):
        assert any(k.split("{")[0] == fam for k in ours), fam


def test_process_wide_counters_match_jax():
    """``retry`` counts every failed attempt into
    ``picotron_retries_total{desc}`` and ``emergency_save`` each outcome
    into ``picotron_emergency_saves_total{outcome}``, as the JAX
    package's do (deltas of the process-wide registries)."""
    from picotron_tpu.obs import GLOBAL_REGISTRY as JAX_GLOBAL
    from picotron_tpu.resilience.preemption import (
        PreemptionGuard as JaxGuard,
    )
    from picotron_tpu.resilience.retry import retry as jax_retry
    from picotron_tpu_torch.resilience.preemption import PreemptionGuard
    from picotron_tpu_torch.resilience.retry import retry

    def flaky(n):
        left = [n]

        def fn():
            if left[0]:
                left[0] -= 1
                raise OSError("flake")
            return "ok"
        return fn

    def boom():
        raise OSError("disk")

    def drive(retry_fn, guard):
        assert retry_fn(flaky(2), attempts=3, desc="serve-test",
                        sleep=lambda s: None) == "ok"
        with pytest.raises(OSError):
            retry_fn(flaky(5), attempts=2, desc="serve-test",
                     sleep=lambda s: None)
        assert guard.emergency_save(lambda: None)
        with pytest.raises(OSError):
            guard.emergency_save(boom)

    def page(text):
        return {k: v for k, v in parse_prometheus(text).items()
                if "serve-test" in k or "emergency" in k}

    j0, p0 = page(JAX_GLOBAL.prometheus()), page(GLOBAL_REGISTRY.prometheus())
    drive(jax_retry, JaxGuard())
    drive(retry, PreemptionGuard())
    j1, p1 = page(JAX_GLOBAL.prometheus()), page(GLOBAL_REGISTRY.prometheus())
    delta = {k: v - p0.get(k, 0.0) for k, v in p1.items()}
    assert delta == {k: v - j0.get(k, 0.0) for k, v in j1.items()}
    assert delta['picotron_retries_total{desc="serve-test"}'] == 4


def test_the_handlers_read_no_tensor(tiny, monkeypatch):
    """What the HTTP threads call (admission with every price, ``stats``
    under the lock, ``/metrics`` without it, the tenant admin plane, the
    watchdog's ``busy``) reads no tensor: spies on every ``torch.Tensor``
    read-back stay silent while slots are live on a paged pool."""
    reg = tenancy.TenantRegistry()
    for t in TIERS:
        reg.add(tenancy.Tenant.from_dict(t))
    front = serve.FrontEnd(_port_engine(slots=2, kv_layout="paged"),
                           tiny[2], tenants=reg, log=_quiet,
                           token_budget=120)
    for spec in ({"prompt": [1, 2, 3], "tenant": "bulk"},
                 {"prompt": [4, 5, 6, 7], "tenant": "capped"}):
        front.submit({**spec, "max_new_tokens": 8})
    front._batcher.step()
    assert front._batcher.stats()["active_slots"] == 2
    reads = ("cpu", "item", "tolist", "numpy", "__int__", "__float__",
             "__bool__", "__index__")
    calls = []

    def spy(name):
        orig = getattr(torch.Tensor, name)

        def read(self, *a, **k):
            calls.append(name)
            return orig(self, *a, **k)
        return read

    for name in reads:
        monkeypatch.setattr(torch.Tensor, name, spy(name))
    outcomes = [_outcome(front.submit, spec) for spec in (
        {"prompt": [1, 2], "max_new_tokens": 30, "tenant": "bulk"},
        {"prompt": [1, 2], "max_new_tokens": 30, "tenant": "capped"},
        {"prompt": [1, 2], "max_new_tokens": 90, "tenant": "gold"},
        {"prompt": [9, 9], "max_new_tokens": 4})]
    stats = front.stats()
    text = front.metrics_text()
    front.tenants_snapshot()
    busy = front._batcher.busy
    monkeypatch.undo()
    assert calls == []
    assert {o[0] for o in outcomes} >= {429, "ok"} and busy
    assert stats["active_slots"] == 2 and "picotron_kv_pages_live" in text


# --------------------------------------------------------------------------- #
# admission against the JAX front end
# --------------------------------------------------------------------------- #


TIERS = ({"name": "gold", "priority": 2},
         {"name": "bulk", "priority": 0, "max_tokens": 40, "max_pages": 5},
         {"name": "capped", "priority": 1, "max_pages": 3})

# scenario -> (front end options, engine options, submissions); a
# submission is a /generate spec
SCENARIOS = {
    "queue_full": ({"max_queue": 2}, {}, [
        {"prompt": [1, 2, 3]}, {"prompt": [4, 5]}, {"prompt": [6]}]),
    "token_budget": ({"token_budget": 30}, {}, [
        {"prompt": [1, 2, 3, 4], "max_new_tokens": 10},
        {"prompt": [5, 6, 7, 8], "max_new_tokens": 10},
        {"prompt": [9, 10, 11, 12], "max_new_tokens": 10}]),
    "window_capped": ({"token_budget": 100}, {}, [
        {"prompt": [1, 2, 3, 4], "max_new_tokens": 10 ** 6},
        {"prompt": [1, 2], "max_new_tokens": 3}]),
    "page_budget": ({}, {"kv_layout": "paged", "kv_num_pages": 6}, [
        {"prompt": [1, 2, 3], "max_new_tokens": 10},
        {"prompt": [4, 5, 6], "max_new_tokens": 10},
        {"prompt": [7, 8, 9], "max_new_tokens": 10},
        {"prompt": [1], "max_new_tokens": 80}]),
    "tenant_quotas": ({}, {"kv_layout": "paged"}, [
        {"prompt": [1, 2, 3, 4], "max_new_tokens": 20, "tenant": "bulk"},
        {"prompt": [5, 6, 7, 8], "max_new_tokens": 20, "tenant": "bulk"},
        {"prompt": [1, 2], "max_new_tokens": 30, "tenant": "capped"},
        {"prompt": [1, 2], "max_new_tokens": 5, "tenant": "capped"}]),
    "lower_class_shedding": ({"token_budget": 40}, {}, [
        {"prompt": [1, 2, 3, 4], "max_new_tokens": 10, "tenant": "bulk",
         "uid": "b1"},
        {"prompt": [5, 6, 7, 8], "max_new_tokens": 10, "tenant": "bulk",
         "uid": "b2"},
        {"prompt": [9, 10, 11, 12], "max_new_tokens": 20, "tenant": "gold"},
        {"prompt": [1, 2, 3, 4], "max_new_tokens": 30}]),
    "page_shedding": ({}, {"kv_layout": "paged", "kv_num_pages": 7}, [
        {"prompt": [1, 2, 3], "max_new_tokens": 10, "tenant": "bulk"},
        {"prompt": [4, 5, 6], "max_new_tokens": 10, "tenant": "bulk"},
        {"prompt": [7, 8, 9], "max_new_tokens": 20, "tenant": "gold"},
        {"prompt": [7, 8, 9], "max_new_tokens": 20},
        {"prompt": [7, 8, 9], "max_new_tokens": 20}]),
    "duplicate_uid": ({}, {}, [
        {"prompt": [1, 2], "uid": "x"}, {"prompt": [3, 4], "uid": "x"}]),
    "bad_requests": ({}, {}, [
        {"prompt": [1, 2], "max_new_tokens": 0},
        {"prompt": [1, 2], "max_new_tokens": -3},
        {"prompt": []}, {"prompt": [1, "a"]}, {"prompt": "12"},
        {"prompt": [1], "temperature": "hot"},
        {"prompt": [1], "tenant": "nobody"}, {"prompt": [1], "tenant": 7},
        {"prompt": list(range(1, MAX_LEN + 1))}]),
    "draining": ({}, {}, ["drain", {"prompt": [1, 2]}]),
}


def _outcome(submit, spec):
    try:
        submit(spec)
        return ("ok",)
    except (serve.AdmissionError, jax_serve.AdmissionError) as e:
        return (e.status, e.retry_after, e.extra)


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_admission_matches_the_jax_front_end(tiny, scenario):
    """The same submissions, with the dispatch loop not started, give the
    same status, Retry-After and body fields, the same rejection counters,
    and the same shed and queued requests."""
    jcfg, jparams, params = tiny
    front_kw, inf, subs = SCENARIOS[scenario]
    jreg = jax_tenancy.TenantRegistry()
    reg = tenancy.TenantRegistry()
    for t in TIERS:
        jreg.add(jax_tenancy.Tenant.from_dict(t))
        reg.add(tenancy.Tenant.from_dict(t))
    jeng = _jax_engine(make_config(MODEL, seq=MAX_LEN), slots=2,
                       kv_page_len=8, **inf)
    jfront = jax_serve.FrontEnd(jeng, jparams, tenants=jreg, log=_quiet,
                                **front_kw)
    front = serve.FrontEnd(_port_engine(slots=2, **inf), params,
                           tenants=reg, log=_quiet, **front_kw)
    want, got = [], []
    for spec in subs:
        if spec == "drain":
            jfront.begin_drain()
            front.begin_drain()
            continue
        want.append(_outcome(jfront.submit, spec))
        got.append(_outcome(front.submit, spec))
    assert got == want
    # every scenario trips its rule; the window-capped budget is admitted
    # (counted raw it would 429 forever) and fills the budget
    assert any(o != ("ok",) for o in got)
    if scenario == "window_capped":
        assert got[0] == ("ok",)
    assert dict(front.rejections) == dict(jfront.rejections)
    jb, b = jfront._batcher, front._batcher
    assert dict(b.counters) == dict(jb.counters)
    assert [r.uid for r in b._pending] == [r.uid for r in jb._pending]
    assert sorted(b._results) == sorted(jb._results)


def test_http_body_checks_match_jax(servers):
    """A non-object body, bad JSON, a 9 MiB Content-Length (413, refused
    before the body is read), a negative one and an unknown path: the
    same answers from both servers."""
    js, ps = servers
    cases = [("POST", "/generate", b"[1, 2]", {}),
             ("POST", "/generate", b"{not json", {}),
             ("POST", "/generate", b"3", {}),
             ("POST", "/generate", None, {"Content-Length": str(9 << 20)}),
             ("POST", "/generate", None, {"Content-Length": "-1"}),
             ("POST", "/nowhere", b"{}", {}),
             ("GET", "/nowhere", None, {}),
             ("DELETE", "/nowhere", None, {})]
    for method, path, body, headers in cases:
        want = _http(js.port, method, path, body, headers)
        got = _http(ps.port, method, path, body, headers)
        assert (got[0], got[2]) == (want[0], want[2]), (method, path)
        assert got[0] >= 400
    assert _http(ps.port, "POST", "/generate", None, {
        "Content-Length": str(9 << 20)})[0] == 413


# --------------------------------------------------------------------------- #
# the port's own: drain, death, watchdog, refusals, the CLI
# --------------------------------------------------------------------------- #


class _Gate:
    """Engine hooks that hold the first dispatch of ``kind`` until the test
    releases it; then, with ``fail``, that dispatch raises it."""

    def __init__(self, kind="decode", fail=None):
        self.kind, self.fail = kind, fail
        self.entered = threading.Event()
        self.release = threading.Event()
        self._fired = False

    def before_dispatch(self, kind, slots):
        if kind != self.kind or self._fired:
            return
        self._fired = True
        self.entered.set()
        if not self.release.wait(WAIT_S):
            raise RuntimeError("gate never released")
        if self.fail is not None:
            raise self.fail

    def poison_logits(self, kind):
        return False


def _gated_server(tiny, gate, slots=1, **front_kw):
    return serve.Server(_port_engine(slots=slots, hooks=gate), tiny[2],
                        log=_quiet, **front_kw)


def test_drain_sheds_the_queue_and_serves_the_slot_in_flight(tiny):
    """One slot: A in flight (held at its first decode dispatch), B queued.
    /drain answers 202, then 409 "draining"; /readyz 503 "draining"; on
    release B finishes "shed" with 503 and Retry-After 5, A is served, the
    loop stops and admission sheds "dead"."""
    gate = _Gate()
    srv = _gated_server(tiny, gate, stall_timeout_s=0)
    try:
        srv.serve_http()
        ta, a = _post_in_thread(srv.port, {"prompt": [1, 2, 3],
                                           "max_new_tokens": 9})
        _until(lambda: srv.front._batcher.queue_depth == 1, "A queued")
        tb, b = _post_in_thread(srv.port, {"prompt": [4, 5],
                                           "max_new_tokens": 4})
        _until(lambda: srv.front._batcher.queue_depth == 2, "B queued")
        srv.front.start()
        assert gate.entered.wait(WAIT_S)
        assert _http(srv.port, "GET", "/readyz")[2]["state"] == "ready"
        assert _http(srv.port, "POST", "/drain", {})[::2] == (
            202, {"ok": True, "state": "draining"})
        st, _, body = _http(srv.port, "POST", "/drain", {})
        assert (st, body["state"]) == (409, "draining")
        st, _, body = _http(srv.port, "GET", "/readyz")
        assert (st, body["state"], body["ok"]) == (503, "draining", False)
        gate.release.set()
        for t in (ta, tb):
            t.join(WAIT_S)
            assert not t.is_alive()
        st, retry, res = b["resp"]
        assert (st, retry, res["finish_reason"], res["tokens"]) == (
            503, "5", "shed", [])
        st, retry, res = a["resp"]
        assert (st, res["finish_reason"], len(res["tokens"])) == (
            200, "length", 9)
        assert srv.front.stopped.wait(WAIT_S)
        assert not srv.front.dead and srv.front.drain_begins == 1
        with pytest.raises(serve.AdmissionError) as e:
            srv.front.submit({"prompt": [1]})
        assert (e.value.status, e.value.retry_after) == (503, 30)
        with pytest.raises(serve.AdmissionError) as e:
            srv.front.drain()
        assert (e.value.status, e.value.extra) == (409, {"state": "stopped"})
        stats = srv.front.stats()
        assert {k: stats[k] for k in ("admitted", "completed", "shed",
                                      "queued", "active_slots")} == {
            "admitted": 1, "completed": 1, "shed": 1, "queued": 0,
            "active_slots": 0}
        assert stats["rejected"]["dead"] == 1
    finally:
        gate.release.set()
        srv.drain_and_join(timeout=WAIT_S)


@pytest.mark.parametrize("overlap", [False, True])
def test_loop_death_strands_no_waiter(tiny, overlap):
    """A lost device (a CUDA error out of ``step()``) kills the loop: the
    stream in flight ends "error" (500 for a plain POST), /healthz and
    /readyz answer 503 "dead", /drain 409 "dead", and a new POST is shed
    with 503."""
    gate = _Gate(fail=RuntimeError(
        "CUDA error: an illegal memory access was encountered"))
    srv = serve.Server(_port_engine(slots=2, hooks=gate, overlap=overlap),
                       tiny[2], log=_quiet, stall_timeout_s=0)
    try:
        srv.serve_http()
        srv.front._on_drained = None  # keep the socket open after the loop
        first = threading.Event()
        ts, s = _stream_in_thread(srv.port, {"prompt": [1, 2, 3],
                                             "max_new_tokens": 9}, first)
        _until(lambda: srv.front._batcher.queue_depth == 1, "the stream")
        tp, p = _post_in_thread(srv.port, {"prompt": [4, 5],
                                           "max_new_tokens": 9})
        _until(lambda: srv.front._batcher.queue_depth == 2, "the POST")
        srv.front.start()
        assert gate.entered.wait(WAIT_S) and first.wait(WAIT_S)
        assert _http(srv.port, "GET", "/healthz")[0] == 200
        gate.release.set()
        for t in (ts, tp):
            t.join(WAIT_S)
            assert not t.is_alive()
        assert srv.front.stopped.wait(WAIT_S) and srv.front.dead
        assert s["status"] == 200 and s["done"]["finish_reason"] == "error"
        assert p["resp"][0] == 500
        assert p["resp"][2]["finish_reason"] == "error"
        st, _, body = _http(srv.port, "GET", "/healthz")
        assert (st, body["dead"]) == (503, True)
        st, _, body = _http(srv.port, "GET", "/readyz")
        assert (st, body["state"]) == (503, "dead")
        st, _, body = _http(srv.port, "POST", "/drain", {})
        assert (st, body["state"]) == (409, "dead")
        st, retry, body = _post(srv.port, {"prompt": [1]})
        assert (st, retry, body["shed"]) == (503, "30", True)
        assert srv.front.stats()["rejected"]["dead"] == 1
    finally:
        gate.release.set()
        srv.drain_and_join(timeout=WAIT_S)


def test_watchdog_flags_a_held_dispatch_and_recovers(tiny):
    """A dispatch held past ``stall_timeout_s`` flips /healthz and /readyz
    to 503 "stalled"; /statz answers a partial snapshot and /metrics the
    live gauges without the lock; on release the request is served and
    health recovers."""
    gate = _Gate()
    srv = _gated_server(tiny, gate, stall_timeout_s=0.2,
                        watchdog_poll_s=0.02)
    try:
        srv.start()
        first = threading.Event()
        t, s = _stream_in_thread(srv.port, {"prompt": [1, 2, 3],
                                            "max_new_tokens": 6}, first)
        assert gate.entered.wait(WAIT_S)
        _until(lambda: _http(srv.port, "GET", "/healthz")[0] == 503,
               "the watchdog")
        st, _, body = _http(srv.port, "GET", "/readyz")
        assert (st, body["state"]) == (503, "stalled")
        st, _, body = _http(srv.port, "GET", "/statz")
        assert st == 200 and body["snapshot"].startswith("partial")
        assert body["stalled"] and body["stalls"] == 1
        st, _, text = _http(srv.port, "GET", "/metrics")
        assert st == 200 and parse_prometheus(text)[
            "picotron_active_slots"] == 1
        gate.release.set()
        t.join(WAIT_S)
        assert not t.is_alive()
        assert s["done"]["finish_reason"] == "length"
        assert s["tokens"] == s["done"]["tokens"] and len(s["tokens"]) == 6
        _until(lambda: _http(srv.port, "GET", "/healthz")[0] == 200,
               "recovery")
        assert srv.front.stats()["stalls"] == 1
    finally:
        gate.release.set()
        srv.drain_and_join(timeout=WAIT_S)


def test_tenant_removed_mid_flight_degrades_to_the_base_adapter(tiny):
    """DELETE /tenants/<name> while its request is held at its first decode
    dispatch: the request is served in full, its first token (from the
    prefill under the adapter) is the tenant's, the rest come from the
    null adapter (the pack slot is zero on the host), so the stream parts
    from the one the tenant would have had."""
    spec = {"prompt": [3, 1, 4, 1, 5, 9], "max_new_tokens": 8,
            "tenant": "globex"}
    cfg = _port_cfg(tenancy={"tenants": [GLOBEX], "adapter_slots": 4,
                             "adapter_rank": 4})
    ref_pack, ref_reg = tenancy.build_tenancy(cfg)
    ref = serve.Server(_port_engine(slots=1, adapters=ref_pack), tiny[2],
                       tenants=ref_reg, log=_quiet)
    try:
        ref.start()
        st, _, want = _post(ref.port, spec)
        assert st == 200
    finally:
        ref.drain_and_join(timeout=WAIT_S)
    gate = _Gate()
    pack, reg = tenancy.build_tenancy(cfg)
    srv = serve.Server(_port_engine(slots=1, hooks=gate, adapters=pack),
                       tiny[2], tenants=reg, log=_quiet, stall_timeout_s=0)
    try:
        srv.start()
        first = threading.Event()
        t, s = _stream_in_thread(srv.port, spec, first)
        assert gate.entered.wait(WAIT_S) and first.wait(WAIT_S)
        assert _http(srv.port, "DELETE", "/tenants/globex")[0] == 200
        assert all(not a[:, 1].any() and not b[:, 1].any()
                   for a, b in pack._host.values())
        gate.release.set()
        t.join(WAIT_S)
        assert not t.is_alive()
        got = s["done"]
        assert (s["status"], got["finish_reason"]) == (200, "length")
        assert got["tokens"] == s["tokens"] and len(got["tokens"]) == 8
        assert got["tokens"][0] == want["tokens"][0]
        assert got["tokens"] != want["tokens"]
    finally:
        gate.release.set()
        srv.drain_and_join(timeout=WAIT_S)


@pytest.mark.parametrize("method,path", [
    ("GET", "/tracez"), ("POST", "/profilez"), ("GET", "/kv/pages?ids=1,2"),
    ("GET", "/kv/prefixes"), ("POST", "/kv/export"), ("POST", "/kv/import"),
    ("POST", "/kv/pages")])
def test_unported_surfaces_answer_501(servers, method, path):
    """The tracer and the profiler answer 501 naming the obs slice. The /kv
    plane is ported: it answers what the JAX server answers to the same
    request (on this contiguous pair, 503: the transport needs pages)."""
    body = {} if method == "POST" else None
    st, hdr, out = _http(servers[1].port, method, path, body)
    if path.startswith("/kv/"):
        jst, jhdr, jout = _http(servers[0].port, method, path, body)
        assert (st, hdr.get("Retry-After"), out) == (
            jst, jhdr.get("Retry-After"), jout)
        assert st == 503 and "paged" in out["error"]
        return
    body = out
    assert st == 501
    assert "not in the PyTorch port yet" in body["error"]
    assert ("obs slice" in body["error"]) == (path in ("/tracez",
                                                       "/profilez"))


def test_kv_payload_and_tenantless_requests_are_refused(tiny):
    """A handoff payload this contiguous replica cannot use is dropped and
    counted, and the request queued to prefill here, as the JAX server
    does; a payload that is no object is a 400 on both. Without a registry
    a tenant name is a 400 and /tenants a 400."""
    jcfg, jparams, params = tiny
    jfront = jax_serve.FrontEnd(_jax_engine(make_config(MODEL, seq=MAX_LEN)),
                                jparams, log=_quiet)
    front = serve.FrontEnd(_port_engine(), tiny[2], log=_quiet)
    for f in (jfront, front):
        uid, _ = f.submit({"prompt": [1, 2], "kv": {"pages": []},
                           "uid": "k"})
        assert uid == "k" and f._batcher.queue_depth == 1
        assert f._batcher._pending[0].kv_import is None
        assert f.obs.registry.counter(
            "picotron_handoff_dropped_total").value == 1
        with pytest.raises(Exception) as e:
            f.submit({"prompt": [1, 2], "kv": [1]})
        assert (e.value.status, e.value.reason) == (
            400, "kv must be a transport payload object")
    for fn in (lambda: front.submit({"prompt": [1], "tenant": "acme"}),
               front.tenants_snapshot, lambda: front.tenants_add(ACME),
               lambda: front.tenants_remove("acme")):
        with pytest.raises(serve.AdmissionError) as e:
            fn()
        assert e.value.status == 400
    assert front._batcher.queue_depth == 1


@pytest.mark.parametrize("argv,message", [
    # the smoke's contiguous layout cannot take a disaggregated role: the
    # JAX CLI's own refusal of the same argv (None: read from it)
    pytest.param(["--smoke", "--role", "prefill"], None,
                 id="argv0-disaggregation"),
    pytest.param(["--smoke", "--role", "decode"], None,
                 id="argv1-disaggregation"),
    (["--smoke", "--obs-dump", "dump"], "span tracer"),
    (["--random-init"], "pass --config"),
])
def test_cli_refuses_what_the_port_lacks(capsys, argv, message):
    if message is None:
        with pytest.raises(ValueError) as theirs:
            jax_serve.main(argv)
        message = str(theirs.value)
        assert "requires the paged KV layout" in message
    with pytest.raises(SystemExit):
        serve.main(argv, device="cpu")
    assert message in capsys.readouterr().err


def test_cli_needs_a_card_unless_told_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the CLI serves on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--smoke"])


def _child(code: str):
    """A Python child on the CPU with one torch thread, its output piped."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    return subprocess.Popen(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def test_cli_smoke_passes_on_the_cpu():
    proc = _child("import sys; from picotron_tpu_torch.tools.serve import "
                  "main; sys.exit(main(['--smoke'], device='cpu'))")
    try:
        out, _ = proc.communicate(timeout=180)
    finally:
        proc.kill()
    assert proc.returncode == 0, out
    assert "serve-smoke: PASS" in out
    assert "FAIL" not in out.replace("serve-smoke: PASS", "")


def test_cli_serves_then_drains_on_sigterm(tmp_path):
    """``--config ... --random-init --port 0``: the "serving" line carries
    the bound port, a POST is served, and SIGTERM exits 0."""
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps({"model": MODEL, "inference": {
        "attend_impl": "flash", "prefill_chunk": 8}}))
    proc = _child("import sys; from picotron_tpu_torch.tools.serve import "
                  f"main; sys.exit(main(['--config', {str(path)!r}, "
                  "'--random-init', '--port', '0', '--slots', '2'], "
                  "device='cpu'))")
    lines: queue.Queue = queue.Queue()
    reader = threading.Thread(
        target=lambda: [lines.put(line) for line in proc.stdout],
        daemon=True)
    reader.start()
    try:
        port = None
        while port is None:
            line = lines.get(timeout=120)
            if line.startswith("{"):
                evt = json.loads(line)
                if evt["evt"] == "serving":
                    port = evt["port"]
        st, _, res = _post(port, {"prompt": [1, 2, 3], "max_new_tokens": 5})
        assert (st, res["finish_reason"], len(res["tokens"])) == (
            200, "length", 5)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        proc.kill()
        proc.wait(timeout=30)
