"""KV-page transport: the unit of the prefill/decode disaggregation handoff.

Port of ``picotron_tpu/inference/page_transport.py``, with its wire format
byte for byte, so a payload exported by either package imports into the
other. A prefilled request's K/V leaves the prefill replica as a
self-describing JSON-safe payload and lands in a decode replica's pool
with the same bytes:

- ``export_prefix(engine, cache, ids)``: radix-match ``ids``, pin the
  matched pages (transient pool references, so no eviction frees them
  while they are read), read them off the card in one gather and one copy
  to the host, and base64 each page's raw bytes per storage leaf: K and V
  in the cache's storage dtype, the int8 scales, and both representations
  of the ``hot_bf16`` pool. The payload carries the covered token ids,
  the page and leaf spec (dtype and per-page shape of each leaf), a CRC-32
  over the raw bytes chained over pages, then leaves, in the spec's leaf
  order, the raw byte count and the tenant, and the first sampled token
  when the match covers the whole prompt.
- ``import_prefix(engine, cache, payload)``: check the spec against the
  local engine, decode and CRC-check every page, plan the chunks the local
  radix lacks, allocate exactly those pages (all or nothing), write them
  into the pool in place and graft them into the radix trie held by the
  cache alone: the state of a locally prefilled and registered prompt.

Every ``TransportError`` is raised before a pool page is allocated. The
pool is written in place (there is no donated buffer to fall back on), so
every page is decoded and checked, and every page allocated, before the
first write; a write that raises releases the fresh pages, which no table
points at yet. The JAX package pads each gather and write to a power-of-two
page count for its compiled shapes; the port moves exactly the pages it
needs, and the bytes that land are the same.

Leaf dtypes travel under numpy's names (``"bfloat16"``, ``"float32"``,
``"int8"``); the port keeps its own table of them and moves raw bytes
through ``uint8`` views, so it needs no ``ml_dtypes`` for bfloat16.
"""

from __future__ import annotations

import base64
import zlib

import numpy as np
import torch

TRANSPORT_VERSION = 1

# the wire's leaf dtype names (numpy's) -> (torch dtype, bytes an element)
WIRE_DTYPES = {
    "bfloat16": (torch.bfloat16, 2),
    "float16": (torch.float16, 2),
    "float32": (torch.float32, 4),
    "int8": (torch.int8, 1),
}
_WIRE_NAME = {dt: name for name, (dt, _) in WIRE_DTYPES.items()}

BYTES_HELP = "raw KV page bytes moved by the transport, by direction"


class TransportError(ValueError):
    """A payload the local engine cannot accept: a wrong version, a spec
    mismatch (page_len, dtype, layout, policy) or corrupt bytes (CRC).
    Raised before any pool page is allocated."""


def _require_paged(engine):
    if engine.paged is None:
        raise TransportError(
            "page transport requires kv_layout='paged' (the contiguous "
            "layout has no pages to ship); set inference.kv_layout: "
            "'paged' on every disaggregated replica")


def transport_spec(engine) -> dict:
    """The engine's page-layout fingerprint: each storage leaf's dtype and
    per-page global shape, in the order the CRC chains them. Exporter and
    importer must agree exactly: byte transport cannot convert."""
    _require_paged(engine)
    m = engine.cfg.model
    kv_shape = [m.num_hidden_layers, engine.page_len,
                m.num_key_value_heads, m.head_dim]
    sc_shape = kv_shape[:-1]
    leaves = {}

    def leaf(name, shape, dtype):
        leaves[name] = {"dtype": _WIRE_NAME[dtype], "shape": list(shape)}

    if engine.quantized:
        leaf("k", kv_shape, torch.int8)
        leaf("v", kv_shape, torch.int8)
        leaf("k_scale", sc_shape, torch.float32)
        leaf("v_scale", sc_shape, torch.float32)
    else:
        leaf("k", kv_shape, engine.cache_dtype)
        leaf("v", kv_shape, engine.cache_dtype)
        if engine.page_policy:
            leaf("k_q", kv_shape, torch.int8)
            leaf("v_q", kv_shape, torch.int8)
            leaf("k_scale", sc_shape, torch.float32)
            leaf("v_scale", sc_shape, torch.float32)
    return {
        "version": TRANSPORT_VERSION,
        "page_len": engine.page_len,
        "quantized": bool(engine.quantized),
        "policy": bool(engine.page_policy),
        "leaves": leaves,
    }


def leaf_bytes(leaf: dict) -> int:
    """Raw bytes of one page of a spec leaf."""
    return WIRE_DTYPES[leaf["dtype"]][1] * int(np.prod(leaf["shape"]))


def check_spec(engine, payload: dict) -> dict:
    """Check a payload's spec against the local engine; returns the local
    spec. Raises TransportError naming the first disagreement."""
    local = transport_spec(engine)
    if payload.get("version") != local["version"]:
        raise TransportError(
            f"transport version {payload.get('version')!r} != "
            f"{local['version']} (mixed-build fleet?)")
    for key in ("page_len", "quantized", "policy"):
        if payload.get(key) != local[key]:
            raise TransportError(
                f"transport {key} mismatch: payload {payload.get(key)!r} "
                f"vs local {local[key]!r} — disaggregated replicas must "
                f"share inference.kv_page_len / kv_cache_dtype / "
                f"kv_page_policy")
    if payload.get("leaves") != local["leaves"]:
        raise TransportError(
            f"transport leaf spec mismatch: payload "
            f"{payload.get('leaves')!r} vs local {local['leaves']!r}")
    return local


def _handoff_bytes(engine, direction: str, total: int) -> None:
    engine.obs.registry.counter("picotron_handoff_bytes_total", BYTES_HELP,
                                dir=direction).inc(total)


def _page_bytes_on_host(engine, cache: dict, pids: list, spec: dict):
    """Pool pages ``pids`` as one host array [n, page bytes] (each page's
    leaves back to back in the spec's order), from one gather and one
    copy to the host."""
    idx = torch.tensor(pids, dtype=torch.int64, device=cache["k"].device)
    batch = engine._gather_pages(cache, idx)
    rows = [batch[name].view(torch.uint8).reshape(len(pids), -1)
            for name in spec["leaves"]]
    return torch.cat(rows, dim=1).cpu().numpy()


def export_prefix(engine, cache, ids, first_token=None,
                  tenant: str = "") -> dict:
    """Serialize the longest radix-cached prefix of ``ids`` out of
    ``cache``'s pool. The matched pages are pinned while they are read;
    the payload's ``token_ids`` are the covered prefix (it may end
    mid-page: the importer adopts the tail as a partial leaf).
    ``first_token`` rides along only when the match covers all of ``ids``.
    ``tenant`` scopes the lookup and rides in the payload, so the pages
    graft only into the importer's same-tenant domain. ``bytes_total`` is
    the raw (pre-base64) page byte count."""
    _require_paged(engine)
    p = engine.paged
    ids = [int(t) for t in ids]
    spec = transport_spec(engine)
    pids, matched = p.acquire_prefix(ids, salt=tenant)
    try:
        host = (_page_bytes_on_host(engine, cache, pids, spec) if pids
                else None)
    finally:
        p.release_pages(pids)
    sizes = [leaf_bytes(leaf) for leaf in spec["leaves"].values()]
    pages, crc, total = [], 0, 0
    for i in range(len(pids)):
        enc, at = {}, 0
        for name, size in zip(spec["leaves"], sizes):
            raw = host[i, at: at + size].tobytes()
            at += size
            crc = zlib.crc32(raw, crc)
            total += size
            enc[name] = base64.b64encode(raw).decode("ascii")
        pages.append(enc)
    payload = dict(spec)
    payload.update(token_ids=ids[:matched], pages=pages, crc32=crc,
                   bytes_total=total, tenant=str(tenant))
    if first_token is not None and matched == len(ids):
        payload["first_token"] = int(first_token)
    _handoff_bytes(engine, "export", total)
    return payload


def _decode_pages(spec: dict, payload: dict) -> list:
    """base64 -> raw bytes per page and leaf, CRC-checked. A torn or
    corrupt transfer dies here, before any pool page exists to leak."""
    ids = payload.get("token_ids") or []
    pages_b64 = payload.get("pages") or []
    page_len = spec["page_len"]
    need = -(-len(ids) // page_len) if ids else 0
    if len(pages_b64) != need:
        raise TransportError(
            f"payload covers {len(ids)} tokens but carries "
            f"{len(pages_b64)} pages (need {need})")
    crc = 0
    out = []
    for enc in pages_b64:
        page = {}
        for name, leaf in spec["leaves"].items():
            if name not in enc:
                raise TransportError(f"payload page missing leaf {name!r}")
            try:
                raw = base64.b64decode(enc[name], validate=True)
            except (ValueError, TypeError) as e:
                raise TransportError(f"leaf {name!r}: bad base64: {e}")
            crc = zlib.crc32(raw, crc)
            shape = tuple(leaf["shape"])
            expect = leaf_bytes(leaf)
            if len(raw) != expect:
                raise TransportError(
                    f"leaf {name!r}: {len(raw)} bytes, expected {expect} "
                    f"for shape {shape} {leaf['dtype']}")
            page[name] = raw
        out.append(page)
    if out and crc != payload.get("crc32"):
        raise TransportError(
            f"payload CRC mismatch ({crc} != {payload.get('crc32')}): "
            f"torn or corrupt page stream")
    return out


def import_prefix(engine, cache, payload) -> tuple:
    """Land a payload's pages in the local pool and radix cache (in place).
    Only the chunks the local trie lacks are allocated and written (an
    already cached prefix costs nothing); grafted pages end held by the
    cache alone, evictable like any registered prompt. All or nothing:
    exhaustion, a write that raises, and CRC or spec errors leave the pool
    as it was. Returns (cache, info) with info = {"tokens",
    "pages_imported", "created", "bytes_total"}."""
    spec = check_spec(engine, payload)
    p = engine.paged
    ids = [int(t) for t in payload.get("token_ids") or []]
    tenant = str(payload.get("tenant") or "")
    pages = _decode_pages(spec, payload)
    if not ids:
        return cache, {"tokens": 0, "pages_imported": 0, "created": 0,
                       "bytes_total": 0}
    need = p.radix.plan_adopt(ids, salt=tenant)
    if not need:
        # the local radix already covers the payload: a remote hit that
        # cost no page
        return cache, {"tokens": len(ids), "pages_imported": 0,
                       "created": 0, "bytes_total": 0}
    # every leaf's pages stacked on the host before the first allocation
    stacked, total = {}, 0
    for name, leaf in spec["leaves"].items():
        raw = b"".join(pages[i][name] for i in need)
        total += len(raw)
        dtype = WIRE_DTYPES[leaf["dtype"]][0]
        stacked[name] = (np.frombuffer(bytearray(raw), np.uint8), dtype,
                         [len(need), *leaf["shape"]])
    pids = p.alloc_import(len(need))
    try:
        batch = {name: engine._upload(raw, np.uint8).view(dtype)
                 .reshape(shape) for name, (raw, dtype, shape)
                 in stacked.items()}
        cache = engine._write_pages(cache, batch,
                                    engine._upload(pids, np.int64))
    except Exception:
        # fresh pages no table points at: release them and the pool is as
        # it was before the import
        p.release_pages(pids)
        raise
    created = p.finish_import(ids, dict(zip(need, pids)), salt=tenant)
    _handoff_bytes(engine, "import", total)
    return cache, {"tokens": len(ids), "pages_imported": len(need),
                   "created": created, "bytes_total": total}
