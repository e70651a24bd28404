"""Preemption safety: catch SIGTERM/SIGINT, finish the step, save, exit.

Port of ``picotron_tpu/resilience/preemption.py`` for one process. The
first signal only sets a flag: the train loop checks it between steps,
writes a checkpoint, and ``train.main`` returns ``EXIT_PREEMPTED`` so a
supervisor can tell "run the same command again" from a crash. A second
signal raises ``KeyboardInterrupt`` (the operator means it). The handlers
are installed only on the main thread, and the previous ones come back on
``uninstall``, so an embedding process (pytest, a notebook) is left as it
was. Each emergency save counts into
``picotron_emergency_saves_total{outcome}`` on the process-wide registry.
"""

from __future__ import annotations

import signal
import threading
from typing import Callable, Optional

from picotron_tpu_torch.obs import global_counter
from picotron_tpu_torch.utils import log0

# EX_TEMPFAIL from sysexits.h: "transient failure, invoke again later", what
# a preempted run whose checkpoint was flushed is
EXIT_PREEMPTED = 75

_LAST: Optional["PreemptionGuard"] = None
# the verdict of the last guard after its uninstall (train's finally
# uninstalls before main reads the exit code); install and uninstall both
# overwrite it, so a later run in the same process never reads a stale one
_LAST_VERDICT = False


class PreemptionGuard:
    """``guard = PreemptionGuard().install()``; poll ``guard.triggered``
    between steps; ``uninstall()`` in a ``finally``."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._signals = tuple(signals)
        self._prev: dict = {}
        self.triggered = False
        self.signame: Optional[str] = None

    def install(self) -> "PreemptionGuard":
        global _LAST, _LAST_VERDICT
        _LAST_VERDICT = False
        if threading.current_thread() is not threading.main_thread():
            # signal handlers can only be set from the main thread
            log0("preemption guard: not on the main thread, signal "
                 "handling disabled")
        else:
            for s in self._signals:
                self._prev[s] = signal.signal(s, self._handle)
        _LAST = self
        return self

    def uninstall(self) -> None:
        global _LAST, _LAST_VERDICT
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()
        _LAST_VERDICT = self.triggered
        if _LAST is self:
            _LAST = None

    def _handle(self, signum, frame) -> None:
        if self.triggered:
            # second signal: restore the defaults and interrupt, so even a
            # wedged loop dies
            self.uninstall()
            raise KeyboardInterrupt(f"second {signal.Signals(signum).name}")
        self.triggered = True
        self.signame = signal.Signals(signum).name

    def emergency_save(self, fn: Callable[[], None],
                       timeout_s: float = 0.0) -> bool:
        """Run the checkpoint flush ``fn`` on a background thread and join
        it with a deadline, so a save wedged on a dead mount costs at most
        ``timeout_s`` seconds of the grace window (0 = wait for it). The
        save layer's atomic rename means an abandoned save never leaves a
        step a resume would trust. Returns True when ``fn`` finished in
        time; its exception, if any, is raised again on this thread.
        False: the deadline passed and the daemon thread dies with the
        process."""
        state: dict = {}

        def run():
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 - raised again below
                state["err"] = e

        t = threading.Thread(target=run, name="emergency-save", daemon=True)
        t.start()
        t.join(timeout_s if timeout_s and timeout_s > 0 else None)
        if t.is_alive():
            log0(f"emergency save still running after {timeout_s}s "
                 f"deadline; exiting without it (the last periodic "
                 f"checkpoint stands)", flush=True)
            _count_save("abandoned")
            return False
        if "err" in state:
            _count_save("failed")
            raise state["err"]
        _count_save("completed")
        return True


def _count_save(outcome: str) -> None:
    global_counter("picotron_emergency_saves_total",
                   "emergency checkpoint flushes by outcome",
                   outcome=outcome).inc()


def was_preempted() -> bool:
    """Whether the current (or the last finished) run's guard caught a
    signal: ``train.main`` keys its exit code off this."""
    return _LAST.triggered if _LAST is not None else _LAST_VERDICT
