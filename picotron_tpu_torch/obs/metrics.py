"""Thread-safe metrics registry: counters, gauges, log-bucketed histograms.

The port's own copy of ``picotron_tpu/obs/metrics.py`` (stdlib and numpy
only): the same instruments render the same Prometheus text, so a scraper
of the JAX server reads the port's ``/metrics`` unchanged. Three
instrument types behind one snapshot:

- ``Counter``: monotonically increasing float (requests, retries, tokens).
- ``Gauge``: a settable level (queue depth, active slots, pool pages).
- ``Histogram``: fixed log-spaced buckets (Prometheus-cumulative on
  export) plus a bounded window of recent raw samples, so the SAME
  instrument serves ``/metrics`` (bucket counts) and ``/statz``
  (exact p50/p95/p99 over the retained window).

Labels: every instrument can carry label key/values
(``registry.counter("x_total", state="shed")``); children with one name
form a family that renders as ``x_total{state="shed"} 3`` in the
Prometheus text exposition. ``CounterDict`` wraps a one-label family in
plain-dict semantics so existing counter dicts (``batcher.counters``,
``serve.rejections``) keep their exact read/compare surface while every
write mirrors into the registry.

Locking discipline: the registry lock guards only the name table; each
instrument has its own leaf lock guarding only its numbers. No lock is
ever held across user code, I/O, or another instrument's lock —
``snapshot()`` copies the table under the registry lock, releases it,
then reads each instrument under its own lock.
"""

from __future__ import annotations

import bisect
import threading
from collections import deque
from typing import Optional

import numpy as np

# Default histogram bounds: log-spaced (x2 per bucket) from 100 us to
# ~105 s — wide enough for queue waits, TTFTs, dispatch and step times
# without per-site tuning. 21 finite buckets + the implicit +Inf.
DEFAULT_BUCKETS = tuple(1e-4 * (2.0 ** i) for i in range(21))

# Raw samples a histogram retains for exact percentiles (oldest dropped
# past the cap: a recent window).
DEFAULT_SAMPLE_WINDOW = 4096


def percentiles_of(samples) -> Optional[dict]:
    """{p50, p95, p99, n} of a sample sequence (seconds), or None when
    empty — the ``/statz`` percentile payload shape."""
    if not len(samples):
        return None
    a = np.asarray(samples, np.float64)
    p50, p95, p99 = np.percentile(a, [50, 95, 99])
    return {"p50": float(p50), "p95": float(p95), "p99": float(p99),
            "n": int(a.size)}


class Counter:
    """Monotonic counter. ``inc`` only; negative deltas are clamped to 0
    so a buggy caller can never make a counter run backwards."""

    __slots__ = ("_mu", "_v")

    def __init__(self):
        self._mu = threading.Lock()
        self._v = 0.0

    def inc(self, delta: float = 1.0) -> None:
        if delta < 0:
            delta = 0.0
        with self._mu:
            self._v += delta

    @property
    def value(self) -> float:
        with self._mu:
            return self._v


class Gauge:
    """A settable level."""

    __slots__ = ("_mu", "_v")

    def __init__(self):
        self._mu = threading.Lock()
        self._v = 0.0

    def set(self, v: float) -> None:
        with self._mu:
            self._v = float(v)

    def inc(self, delta: float = 1.0) -> None:
        with self._mu:
            self._v += delta

    @property
    def value(self) -> float:
        with self._mu:
            return self._v


class Histogram:
    """Fixed log-spaced buckets + a bounded recent-sample window.

    ``bucket_counts[i]`` counts observations ``<= bounds[i]`` EXCLUSIVE
    of earlier buckets (per-bucket, not cumulative — the Prometheus
    renderer accumulates); observations above the last bound land in the
    implicit +Inf bucket. ``percentiles()`` is exact over the retained
    window (recent ``sample_window`` observations)."""

    __slots__ = ("_mu", "bounds", "_counts", "_inf", "_sum", "_count",
                 "_samples")

    def __init__(self, buckets=DEFAULT_BUCKETS,
                 sample_window: int = DEFAULT_SAMPLE_WINDOW):
        bounds = tuple(float(b) for b in buckets)
        if not bounds or any(b2 <= b1 for b1, b2 in zip(bounds, bounds[1:])):
            raise ValueError("histogram buckets must be strictly increasing "
                             f"and non-empty, got {buckets!r}")
        self._mu = threading.Lock()
        self.bounds = bounds
        self._counts = [0] * len(bounds)
        self._inf = 0
        self._sum = 0.0
        self._count = 0
        self._samples: deque = deque(maxlen=max(1, int(sample_window)))

    def observe(self, v: float) -> None:
        v = float(v)
        i = bisect.bisect_left(self.bounds, v)  # v <= bounds[i]
        with self._mu:
            if i < len(self._counts):
                self._counts[i] += 1
            else:
                self._inf += 1
            self._sum += v
            self._count += 1
            self._samples.append(v)

    def percentiles(self) -> Optional[dict]:
        with self._mu:
            window = list(self._samples)
        return percentiles_of(window)

    def read(self) -> dict:
        """One consistent view: per-bucket counts, sum, count."""
        with self._mu:
            return {"bounds": self.bounds, "counts": list(self._counts),
                    "inf": self._inf, "sum": self._sum,
                    "count": self._count}

    @property
    def count(self) -> int:
        with self._mu:
            return self._count

    @property
    def sum(self) -> float:
        with self._mu:
            return self._sum


class _NullInstrument:
    """No-op stand-in for every instrument type (``obs.enabled: false``):
    accepts the full write surface, reports empty."""

    __slots__ = ()

    def inc(self, delta: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def percentiles(self) -> Optional[dict]:
        return None

    def read(self) -> dict:
        return {"bounds": (), "counts": [], "inf": 0, "sum": 0.0,
                "count": 0}

    @property
    def value(self) -> float:
        return 0.0

    @property
    def count(self) -> int:
        return 0

    @property
    def sum(self) -> float:
        return 0.0


NULL_INSTRUMENT = _NullInstrument()

_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


class MetricsRegistry:
    """Name table of instrument families. ``counter``/``gauge``/
    ``histogram`` are get-or-create (same name + labels returns the same
    instrument), so call sites never coordinate registration."""

    def __init__(self, sample_window: int = DEFAULT_SAMPLE_WINDOW):
        self._mu = threading.Lock()
        self._sample_window = int(sample_window)
        # name -> {"type": str, "help": str, "children": {label_key: obj}}
        self._families: dict = {}

    # ---- get-or-create -----------------------------------------------------

    def _get(self, kind: str, name: str, help_: str, labels: dict,
             **kw):
        key = _label_key(labels)
        with self._mu:
            fam = self._families.get(name)
            if fam is None:
                fam = {"type": kind, "help": help_, "children": {}}
                self._families[name] = fam
            if fam["type"] != kind:
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{fam['type']}, not {kind}")
            if help_ and not fam["help"]:
                fam["help"] = help_
            child = fam["children"].get(key)
            if child is None:
                child = _TYPES[kind](**kw)
                fam["children"][key] = child
            return child

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get("counter", name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get("gauge", name, help, labels)

    def histogram(self, name: str, help: str = "", buckets=None,
                  sample_window: Optional[int] = None,
                  **labels) -> Histogram:
        return self._get(
            "histogram", name, help, labels,
            buckets=buckets if buckets is not None else DEFAULT_BUCKETS,
            sample_window=(sample_window if sample_window is not None
                           else self._sample_window))

    def counter_dict(self, name: str, keys, help: str = "",
                     label: str = "state") -> "CounterDict":
        return CounterDict(self, name, keys, help=help, label=label)

    # ---- read side ---------------------------------------------------------

    def _copy_table(self) -> list:
        """(name, type, help, [(labels, instrument)]) rows — taken under
        the registry lock, read without it."""
        with self._mu:
            return [(name, fam["type"], fam["help"],
                     sorted(fam["children"].items()))
                    for name, fam in sorted(self._families.items())]

    def snapshot(self) -> dict:
        """Full structured read: {name: {"type", "help", "values":
        {label_str: value | histogram-read}}}. No lock held across
        instrument reads."""
        out = {}
        for name, kind, help_, children in self._copy_table():
            values = {}
            for key, inst in children:
                lbl = ",".join(f'{k}="{v}"' for k, v in key)
                if kind == "histogram":
                    values[lbl] = inst.read()
                else:
                    values[lbl] = inst.value
            out[name] = {"type": kind, "help": help_, "values": values}
        return out

    def summary(self) -> dict:
        """Compact flat view for embedding in bench JSON: counters and
        gauges as numbers, histograms as {count, sum, p50, p95, p99}.
        Keys are ``name`` or ``name{label="v"}``."""
        out = {}
        for name, kind, _help, children in self._copy_table():
            for key, inst in children:
                lbl = ",".join(f'{k}="{v}"' for k, v in key)
                full = f"{name}{{{lbl}}}" if lbl else name
                if kind == "histogram":
                    pct = inst.percentiles() or {}
                    out[full] = {
                        "count": inst.count,
                        "sum": round(inst.sum, 6),
                        **{p: round(pct[p], 6)
                           for p in ("p50", "p95", "p99") if p in pct}}
                else:
                    v = inst.value
                    out[full] = int(v) if float(v).is_integer() else v
        return out

    def prometheus(self) -> str:
        """Prometheus text exposition (format 0.0.4) of every family."""
        lines = []
        for name, kind, help_, children in self._copy_table():
            if help_:
                lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {kind}")
            for key, inst in children:
                lbl = ",".join(f'{k}="{v}"' for k, v in key)
                if kind != "histogram":
                    lines.append(_sample_line(name, lbl, inst.value))
                    continue
                h = inst.read()
                cum = 0
                for bound, c in zip(h["bounds"], h["counts"]):
                    cum += c
                    le = _fmt_float(bound)
                    blbl = (f'{lbl},le="{le}"' if lbl else f'le="{le}"')
                    lines.append(_sample_line(f"{name}_bucket", blbl, cum))
                blbl = (f'{lbl},le="+Inf"' if lbl else 'le="+Inf"')
                lines.append(_sample_line(f"{name}_bucket", blbl,
                                          h["count"]))
                lines.append(_sample_line(f"{name}_sum", lbl, h["sum"]))
                lines.append(_sample_line(f"{name}_count", lbl,
                                          h["count"]))
        return "\n".join(lines) + ("\n" if lines else "")


def _fmt_float(v: float) -> str:
    return repr(float(v))


def _sample_line(name: str, lbl: str, v) -> str:
    v = float(v)
    sval = str(int(v)) if v.is_integer() else repr(v)
    return (f"{name}{{{lbl}}} {sval}" if lbl else f"{name} {sval}")


def parse_prometheus(text: str) -> dict:
    """Inverse of ``prometheus()`` for tests and the smoke drive:
    {sample-name-with-labels: float}. Comment lines are skipped; the last
    occurrence of a duplicated sample wins (as a scraper would see)."""
    out = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        key, _, val = line.rpartition(" ")
        try:
            out[key] = float(val)
        except ValueError:
            continue
    return out


class NullRegistry(MetricsRegistry):
    """Registry for ``obs.enabled: false``: hands out shared no-op
    instruments, snapshots empty. CounterDicts built on it degrade to
    plain dicts (their authoritative local values still work)."""

    def __init__(self):
        super().__init__()

    def _get(self, kind, name, help_, labels, **kw):
        return NULL_INSTRUMENT

    def snapshot(self) -> dict:
        return {}

    def summary(self) -> dict:
        return {}

    def prometheus(self) -> str:
        return ""


class CounterDict(dict):
    """A plain dict whose writes mirror into a one-label counter family.

    Existing code keeps its exact surface — ``d[k] += 1``, ``dict(d)``,
    ``d == {...}`` — while every increment lands in the registry as
    ``name{label=k}``. The dict itself stays the authoritative read side
    (tests and ``/statz`` compare against it); the registry child only
    ever receives the positive deltas, so the two can never disagree for
    monotonic counters. NOT internally locked: callers serialize writes
    exactly as they did for the plain dict this replaces."""

    def __init__(self, registry: MetricsRegistry, name: str, keys,
                 help: str = "", label: str = "state"):
        super().__init__({k: 0 for k in keys})
        self._registry = registry
        self._name = name
        self._help = help
        self._label = label
        self._children = {
            k: registry.counter(name, help, **{label: k}) for k in keys}

    def __setitem__(self, k, v) -> None:
        old = self.get(k, 0)
        dict.__setitem__(self, k, v)
        child = self._children.get(k)
        if child is None:
            child = self._registry.counter(
                self._name, self._help, **{self._label: k})
            self._children[k] = child
        child.inc(v - old)
