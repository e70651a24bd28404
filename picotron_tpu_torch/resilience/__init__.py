"""Fault tolerance of the port: retried checkpoint I/O, the SIGTERM/SIGINT
guard that flushes a checkpoint and exits ``EXIT_PREEMPTED``, and the
serving chaos hooks (``ServingChaos``) that drive the batcher's retries,
per-slot isolation and the samplers' non-finite gate.

Port of the parts of ``picotron_tpu/resilience/`` that checkpoints and
serving need (``retry``, ``preemption``, ``chaos.ServingChaos``). The
loss-anomaly policies, training chaos and the cluster control plane are
not ported (``Config.check_trainable`` refuses their options).
"""

from picotron_tpu_torch.resilience.chaos import (  # noqa: F401
    ChaosError,
    ServingChaos,
)
from picotron_tpu_torch.resilience.preemption import (  # noqa: F401
    EXIT_PREEMPTED,
    PreemptionGuard,
    was_preempted,
)
from picotron_tpu_torch.resilience.retry import retry  # noqa: F401
