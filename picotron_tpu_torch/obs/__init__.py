"""Telemetry for the port: the metrics registry and its export surface.

Port of the metrics half of ``picotron_tpu/obs``: ``obs.metrics`` (the
thread-safe counters, gauges and histograms, their Prometheus text, and
``CounterDict``) and the ``Obs`` bundle a subsystem carries. The span
tracer and the on-demand profiler are not ported yet (the serve front end
answers ``/tracez`` and ``/profilez`` with 501).

Ownership, as in the JAX package:

- each ``InferenceEngine`` owns a FRESH registry via
  ``Obs.from_config(cfg.obs)``; its batcher and serve front end record
  into it, so one server's ``GET /metrics`` agrees with its ``/statz``
  even when several engines share a process (tests);
- ``GLOBAL_REGISTRY`` holds process-wide counters owned by no run in
  particular (retried I/O and dispatches, emergency saves); the serve
  front end renders it after its own registry.

``obs.enabled: false`` swaps in null instruments: every record call is a
no-op and the ``CounterDict`` views stay plain dicts.
"""

from __future__ import annotations

from typing import Optional

from picotron_tpu_torch.obs.metrics import (  # noqa: F401 - public surface
    Counter,
    CounterDict,
    Gauge,
    Histogram,
    MetricsRegistry,
    NullRegistry,
    parse_prometheus,
    percentiles_of,
)

# Process-wide counters (see the module docstring).
GLOBAL_REGISTRY = MetricsRegistry()


class Obs:
    """The bundle a subsystem carries: its registry, with the ``enabled``
    flag that chose it."""

    def __init__(self, enabled: bool = True,
                 registry: Optional[MetricsRegistry] = None):
        self.enabled = bool(enabled)
        if registry is None:
            registry = MetricsRegistry() if self.enabled else NullRegistry()
        self.registry = registry

    @classmethod
    def from_config(cls, ocfg) -> "Obs":
        """Build from a config ``obs`` section (``config.ObsConfig``)."""
        if not ocfg.enabled:
            return cls(enabled=False)
        return cls(enabled=True, registry=MetricsRegistry(
            sample_window=ocfg.sample_window))


def null_obs() -> Obs:
    return Obs(enabled=False)


def global_counter(name: str, help: str = "", **labels) -> Counter:
    """A counter on the process-wide registry (retries, emergency saves:
    owned by no single run)."""
    return GLOBAL_REGISTRY.counter(name, help, **labels)
