"""Multi-tenant serving: the tenant registry and the adapter pack.

Port of ``picotron_tpu/inference/tenancy.py``. A **tenant** is a named
serving identity: an optional LoRA adapter (rank, seed or ``.npz``
weights) added as a residual on the seven decoder-layer projections, a
priority class (higher holds admission longer; the lowest queued class is
shed first), quotas (in-flight token and KV-page ceilings) and SLO
targets (TTFT / TPOT milliseconds).

The **AdapterPack** keeps, per projection leaf, fixed-capacity stacks
``a [L, T, in, R]`` / ``b [L, T, R, out]`` in an fp32 numpy host master,
zero wherever a slot is free; slot 0 is the reserved null adapter. Adding
or removing a tenant writes one slot and bumps ``version``;
``device_leaves(device)`` re-uploads the pack only after such a change.
One dispatch mixes tenants: every row names its slot, and kernel H reads
each row's pair from the pack in place (``ops/lora_matmul.py``).

The **TenantRegistry** maps names to (Tenant, pack slot), loaded from the
config or a JSON manifest::

    {"tenants": [
        {"name": "acme", "priority": 2, "adapter_rank": 8,
         "adapter_seed": 7, "max_tokens": 4096, "max_pages": 256,
         "ttft_slo_ms": 300.0, "tpot_slo_ms": 50.0},
        {"name": "bulk", "priority": 0}
    ]}

Rank-0 tenants (no adapter) share slot 0. A tenant's name also salts the
radix prefix cache (``paged_kv.RadixCache``), so identical prompts of two
tenants never share pages: the adapter changes every activation a cached
page holds.

``build_tenancy(cfg, manifest)`` builds both from ``inference.tenancy``
(a manifest path overrides its ``manifest``), as the JAX package's
``tools/serve.py::_build_tenancy`` does; the port's ``tools/serve.py``
serves them, with ``/tenants`` hot add and remove.
"""

from __future__ import annotations

import dataclasses
import json
import threading

import numpy as np
import torch

from picotron_tpu_torch.models.llama import QUANT_WEIGHT_LEAVES
from picotron_tpu_torch.ops.lora_matmul import ADAPTER_DTYPE, NULL_ADAPTER

# The seven projection leaves an adapter modifies (the LM head stays
# base-only, the classic LoRA placement).
LORA_LEAVES = QUANT_WEIGHT_LEAVES

# The identity of requests that name no tenant: base model, no adapter,
# middle priority, no quotas, no SLOs.
BASE_TENANT = "base"

# The scale of seed-derived adapters (smoke, bench and test path).
DEFAULT_ADAPTER_SCALE = 0.05


def adapter_dims(m) -> dict:
    """Per-leaf ``(in_features, out_features)`` of the seven projection
    weights, from the model config."""
    H, I, D = m.hidden_size, m.intermediate_size, m.head_dim
    Hq, Hkv = m.num_attention_heads * D, m.num_key_value_heads * D
    return {
        "wq": (H, Hq), "wk": (H, Hkv), "wv": (H, Hkv), "wo": (Hq, H),
        "w_gate": (H, I), "w_up": (H, I), "w_down": (I, H),
    }


@dataclasses.dataclass
class Tenant:
    """One serving identity. ``priority``: higher holds admission longer
    under pressure (0 = best-effort, shed first). ``adapter_rank`` 0
    means base-only (slot 0). Quotas are in-flight ceilings (None =
    unlimited); SLO targets are milliseconds (None = no target)."""
    name: str
    priority: int = 1
    adapter_rank: int = 0
    adapter_seed: int = 0
    adapter_scale: float = DEFAULT_ADAPTER_SCALE
    adapter_npz: str | None = None
    max_tokens: int | None = None
    max_pages: int | None = None
    ttft_slo_ms: float | None = None
    tpot_slo_ms: float | None = None

    def __post_init__(self):
        if not self.name or "/" in self.name or '"' in self.name:
            raise ValueError(
                f"tenant name {self.name!r} must be non-empty and free of "
                f"'/' and '\"' (it labels metrics and salts cache keys)")
        if self.priority < 0:
            raise ValueError(
                f"tenant {self.name}: priority must be >= 0 "
                f"(0 = best-effort, shed first)")
        if self.adapter_rank < 0:
            raise ValueError(
                f"tenant {self.name}: adapter_rank must be >= 0 "
                f"(0 = base-only)")
        for f in ("max_tokens", "max_pages"):
            v = getattr(self, f)
            if v is not None and v < 1:
                raise ValueError(
                    f"tenant {self.name}: {f} must be >= 1 or absent")
        for f in ("ttft_slo_ms", "tpot_slo_ms"):
            v = getattr(self, f)
            if v is not None and v <= 0:
                raise ValueError(
                    f"tenant {self.name}: {f} must be > 0 ms or absent")

    @classmethod
    def from_dict(cls, d: dict) -> "Tenant":
        known = {f.name for f in dataclasses.fields(cls)}
        bad = set(d) - known
        if bad:
            raise ValueError(
                f"unknown tenant field(s) {sorted(bad)} for "
                f"{d.get('name', '?')!r} (known: {sorted(known)})")
        return cls(**d)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class AdapterPack:
    """Fixed-capacity stacked adapter storage for one model shape.

    ``slots`` adapter slots in all (slot 0 the null adapter), ``rank`` the
    capacity rank R: a tenant of rank r <= R fills the first r columns of
    its slot and the rest stay zero (exact: zero columns add nothing).
    Mutations write the host master and bump ``version``;
    ``device_leaves`` re-uploads only after one. Shapes never change
    after construction."""

    def __init__(self, m, *, slots: int = 8, rank: int = 16,
                 rows: int | None = None):
        self._init(adapter_dims(m), slots, rank,
                   int(rows or m.num_hidden_layers))

    @classmethod
    def from_host(cls, host: dict) -> "AdapterPack":
        """A pack around an existing host master ``{leaf: (a [rows, T,
        in, R], b [rows, T, R, out])}`` (copied), e.g. the JAX package's
        ``AdapterPack._host`` (``convert.adapter_pack_from_jax``)."""
        a0 = np.asarray(host["wq"][0])
        dims = {name: (np.shape(a)[2], np.shape(b)[3])
                for name, (a, b) in host.items()}
        pack = cls.__new__(cls)
        pack._init(dims, a0.shape[1], a0.shape[3], a0.shape[0])
        for name, (a, b) in host.items():
            ha, hb = pack._host[name]
            ha[...] = np.asarray(a, np.float32)
            hb[...] = np.asarray(b, np.float32)
        return pack

    def _init(self, dims: dict, slots: int, rank: int, rows: int) -> None:
        if slots < 2:
            raise ValueError(
                f"adapter_slots must be >= 2 (slot 0 is the reserved "
                f"null adapter); got {slots}")
        if rank < 1:
            raise ValueError(f"adapter_rank capacity must be >= 1; "
                             f"got {rank}")
        self.slots, self.rank, self.rows = int(slots), int(rank), int(rows)
        self.dims = dict(dims)
        self._host = {
            name: (np.zeros((self.rows, self.slots, din, self.rank),
                            np.float32),
                   np.zeros((self.rows, self.slots, self.rank, dout),
                            np.float32))
            for name, (din, dout) in self.dims.items()
        }
        self.version = 0
        self._device = None
        self._device_key = None
        self._lock = threading.Lock()

    # -- mutation (host master; the device copy follows lazily) -------------

    def set_slot(self, slot: int, leaves: dict) -> None:
        """Install adapter weights into ``slot``. ``leaves`` maps leaf name
        -> (a [rows, in, r], b [rows, r, out]) with r <= capacity; missing
        leaves are zero (the adapter does not touch them)."""
        self._check_slot(slot)
        with self._lock:
            for name, (ha, hb) in self._host.items():
                ha[:, slot] = 0.0
                hb[:, slot] = 0.0
                if name not in leaves:
                    continue
                a, b = leaves[name]
                a = np.asarray(a, np.float32)
                b = np.asarray(b, np.float32)
                din, dout = self.dims[name]
                r = a.shape[-1]
                if (a.shape != (self.rows, din, r)
                        or b.shape != (self.rows, r, dout)
                        or r > self.rank):
                    raise ValueError(
                        f"adapter leaf {name}: got a {a.shape} / b "
                        f"{b.shape}; want a [{self.rows}, {din}, r] / "
                        f"b [{self.rows}, r, {dout}] with r <= "
                        f"{self.rank}")
                ha[:, slot, :, :r] = a
                hb[:, slot, :r, :] = b
            self.version += 1

    def clear_slot(self, slot: int) -> None:
        """Zero a slot back to null (hot remove)."""
        self._check_slot(slot)
        with self._lock:
            for ha, hb in self._host.values():
                ha[:, slot] = 0.0
                hb[:, slot] = 0.0
            self.version += 1

    def random_leaves(self, rank: int, seed: int,
                      scale: float = DEFAULT_ADAPTER_SCALE) -> dict:
        """Seed-derived adapter weights, the same draws as the JAX
        package's (one ``np.random.default_rng(seed)``, leaves in order)."""
        if not 1 <= rank <= self.rank:
            raise ValueError(
                f"adapter rank {rank} outside [1, capacity {self.rank}]")
        rng = np.random.default_rng(seed)
        out = {}
        for name, (din, dout) in self.dims.items():
            out[name] = (
                rng.normal(0.0, scale,
                           (self.rows, din, rank)).astype(np.float32),
                rng.normal(0.0, scale,
                           (self.rows, rank, dout)).astype(np.float32))
        return out

    def npz_leaves(self, path: str) -> dict:
        """Adapter weights from an ``.npz`` archive with ``{leaf}.a`` /
        ``{leaf}.b`` arrays (offline-trained adapters)."""
        with np.load(path) as z:
            out = {}
            for name in self.dims:
                ka, kb = f"{name}.a", f"{name}.b"
                if ka in z and kb in z:
                    out[name] = (z[ka], z[kb])
            if not out:
                raise ValueError(
                    f"adapter archive {path} has no '<leaf>.a'/'<leaf>.b' "
                    f"arrays for leaves {sorted(self.dims)}")
        return out

    # -- device side ---------------------------------------------------------

    def device_leaves(self, device=None) -> dict:
        """The pack as fp32 tensors on ``device`` (default CPU), ``{leaf:
        {"a": [L, T, in, R], "b": [L, T, R, out]}}``, cached until the next
        mutation."""
        device = torch.device(device if device is not None else "cpu")
        with self._lock:
            key = (self.version, device)
            if self._device is not None and self._device_key == key:
                return self._device
            self._device = None  # drop the old copy before the upload

            def put(arr):  # a copy, never a view of the host master
                return torch.tensor(arr, dtype=ADAPTER_DTYPE, device=device)

            self._device = {name: {"a": put(ha), "b": put(hb)}
                            for name, (ha, hb) in self._host.items()}
            self._device_key = key
            return self._device

    def bytes_per_token(self) -> int:
        """Adapter bytes one decoded token streams for one adapter-bound
        row: each layer reads its [in, R] + [R, out] fp32 pair per leaf."""
        per_layer = sum((din + dout) * self.rank
                        for din, dout in self.dims.values())
        return self.rows * per_layer * np.dtype(np.float32).itemsize

    def nbytes(self) -> int:
        """Bytes of the whole pack (every slot, every layer, a and b)."""
        return sum(ha.nbytes + hb.nbytes for ha, hb in self._host.values())

    def _check_slot(self, slot: int) -> None:
        if not NULL_ADAPTER < slot < self.slots:
            raise ValueError(
                f"adapter slot {slot} outside (0, {self.slots}) — slot 0 "
                f"is the reserved null adapter")


class TenantRegistry:
    """name -> (Tenant, adapter slot), with hot add and remove.

    The registry assigns slots on its AdapterPack (rank-0 tenants share
    the null slot 0). The implicit ``base`` tenant always resolves, unless
    the manifest defines its own ``base`` entry, which then governs."""

    def __init__(self, pack: AdapterPack | None = None):
        self.pack = pack
        self._tenants: dict = {}
        self._slots: dict = {}
        self._lock = threading.Lock()
        self._base = Tenant(name=BASE_TENANT)

    @classmethod
    def from_manifest(cls, path: str,
                      pack: AdapterPack | None = None) -> "TenantRegistry":
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
        if not isinstance(doc, dict) or not isinstance(
                doc.get("tenants", None), list):
            raise ValueError(
                f"tenant manifest {path} must be a JSON object with a "
                f"'tenants' list")
        reg = cls(pack)
        for entry in doc["tenants"]:
            reg.add(Tenant.from_dict(entry))
        return reg

    def add(self, tenant: Tenant) -> int:
        """Register a tenant; returns its adapter slot. Raises on a
        duplicate name, a missing pack or a full pack."""
        with self._lock:
            if tenant.name in self._tenants:
                raise ValueError(f"tenant {tenant.name!r} already exists")
            slot = NULL_ADAPTER
            if tenant.adapter_rank > 0:
                if self.pack is None:
                    raise ValueError(
                        f"tenant {tenant.name!r} wants adapter rank "
                        f"{tenant.adapter_rank} but no adapter pack is "
                        f"configured (inference.tenancy.adapter_slots)")
                used = set(self._slots.values())
                free = [s for s in range(1, self.pack.slots)
                        if s not in used]
                if not free:
                    raise ValueError(
                        f"adapter pack full ({self.pack.slots - 1} "
                        f"slots); remove a tenant first")
                slot = free[0]
                if tenant.adapter_npz:
                    leaves = self.pack.npz_leaves(tenant.adapter_npz)
                else:
                    leaves = self.pack.random_leaves(
                        tenant.adapter_rank, tenant.adapter_seed,
                        tenant.adapter_scale)
                self.pack.set_slot(slot, leaves)
                self._slots[tenant.name] = slot
            self._tenants[tenant.name] = tenant
            return slot

    def remove(self, name: str) -> None:
        """Deregister: the slot zeroes back to null, so rows still pointing
        at it get base-model output, never another tenant's adapter."""
        with self._lock:
            if name not in self._tenants:
                raise KeyError(f"no tenant {name!r}")
            del self._tenants[name]
            slot = self._slots.pop(name, None)
            if slot is not None and self.pack is not None:
                self.pack.clear_slot(slot)

    def resolve(self, name: str | None) -> tuple:
        """(Tenant, adapter slot) for a request's tenant field; None or ""
        resolves to the base identity. KeyError on an unknown name (a
        misspelt tenant must not dodge its quota)."""
        name = name or BASE_TENANT
        with self._lock:
            if name in self._tenants:
                return (self._tenants[name],
                        self._slots.get(name, NULL_ADAPTER))
        if name == BASE_TENANT:
            return self._base, NULL_ADAPTER
        raise KeyError(f"unknown tenant {name!r}")

    def names(self) -> list:
        with self._lock:
            return sorted(self._tenants)

    def snapshot(self) -> list:
        """Every tenant and its slot (the base tenant implied)."""
        with self._lock:
            return [{**t.to_dict(), "adapter_slot":
                     self._slots.get(n, NULL_ADAPTER)}
                    for n, t in sorted(self._tenants.items())]


def build_tenancy(cfg, manifest: str = "") -> tuple:
    """(AdapterPack, TenantRegistry) from ``cfg.inference.tenancy`` and an
    optional manifest path that overrides its ``manifest``, or (None,
    None) when no tenancy is configured (no pack: every path runs as
    without tenancy). The pack is built whenever a registry is, so a
    tenant with an adapter can be added later."""
    tcfg = cfg.inference.tenancy
    manifest = manifest or tcfg.manifest
    if not manifest and not tcfg.tenants:
        return None, None
    pack = AdapterPack(cfg.model, slots=tcfg.adapter_slots,
                       rank=tcfg.adapter_rank)
    if manifest:
        registry = TenantRegistry.from_manifest(manifest, pack)
    else:
        registry = TenantRegistry(pack)
    for entry in tcfg.tenants:  # the config extends (or replaces) a manifest
        registry.add(Tenant.from_dict(entry))
    return pack, registry
