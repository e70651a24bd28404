"""Bounded retry with exponential backoff and jitter for flaky I/O and
serving dispatches.

Port of ``picotron_tpu/resilience/retry.py``: checkpoint saves and
restores and safetensors opens cross network mounts where transient
errors are routine, and the batcher retries a failed dispatch before it
isolates the failure. Attempts are bounded (a deterministic failure surfaces
quickly, with the original exception), delays grow exponentially, and
jitter decorrelates processes that hit the same flake at once. Every
failed attempt counts into ``picotron_retries_total{desc}`` on the
process-wide registry (``obs.GLOBAL_REGISTRY``).
"""

from __future__ import annotations

import random
import time
from typing import Callable

from picotron_tpu_torch.obs import global_counter
from picotron_tpu_torch.utils import log0


def retry(
    fn: Callable,
    attempts: int = 3,
    backoff: float = 0.5,
    jitter: float = 0.25,
    desc: str = "",
    sleep: Callable[[float], None] = time.sleep,
    rng: Callable[[], float] = random.random,
    fatal: Callable[[Exception], bool] | None = None,
):
    """Call ``fn()`` up to ``attempts`` times; return its result.

    The delay before attempt k + 1 is ``backoff * 2**(k-1)`` scaled by a
    uniform jitter in [1, 1 + jitter]. The last failure re-raises the
    original exception unchanged. ``KeyboardInterrupt`` and ``SystemExit``
    are never swallowed (they are not ``Exception``s), and an exception
    for which ``fatal`` holds re-raises at once: another attempt could
    not succeed. ``sleep`` and ``rng`` are injectable so tests run at once
    and deterministically.
    """
    if attempts < 1:
        raise ValueError(f"retry needs attempts >= 1, got {attempts}")
    for attempt in range(1, attempts + 1):
        try:
            return fn()
        except Exception as e:
            # retry() has no per-run registry to hand its numbers to, so
            # failed attempts count process-wide, labeled by call site
            global_counter("picotron_retries_total",
                           "failed attempts absorbed by retry()",
                           desc=desc or "unnamed").inc()
            if attempt == attempts or (fatal is not None and fatal(e)):
                raise
            delay = backoff * (2 ** (attempt - 1)) * (1.0 + jitter * rng())
            log0(f"retry{f' [{desc}]' if desc else ''}: attempt "
                 f"{attempt}/{attempts} failed ({type(e).__name__}: {e}); "
                 f"retrying in {delay:.2f}s", flush=True)
            sleep(delay)
