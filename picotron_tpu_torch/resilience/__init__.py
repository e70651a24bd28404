"""Fault tolerance of the port's trainer: retried checkpoint I/O and the
SIGTERM/SIGINT guard that flushes a checkpoint and exits
``EXIT_PREEMPTED``.

Port of the parts of ``picotron_tpu/resilience/`` that checkpoints need
(``retry``, ``preemption``). The loss-anomaly policies, chaos injection
and the cluster control plane are not ported (``Config.check_trainable``
refuses their options).
"""

from picotron_tpu_torch.resilience.preemption import (  # noqa: F401
    EXIT_PREEMPTED,
    PreemptionGuard,
    was_preempted,
)
from picotron_tpu_torch.resilience.retry import retry  # noqa: F401
