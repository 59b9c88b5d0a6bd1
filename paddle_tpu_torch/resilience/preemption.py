"""PreemptionGuard — turn SIGTERM into an orderly checkpoint-and-exit
(copy of ``paddle_tpu/resilience/preemption.py``).

Maintenance and spot-reclaim events arrive as SIGTERM with a short grace window
(the reference's elastic manager sees the same shape: etcd watcher +
process kill). The guard latches the signal; the training loop polls
``preempted`` at each step boundary, writes one final synchronous
checkpoint, and raises :class:`TrainingPreempted` — a ``SystemExit``
carrying :data:`RESUMABLE_EXIT_CODE` so the process exit status tells the
relauncher "resume me" rather than "I failed".

This module is deliberately stdlib-only.
"""

from __future__ import annotations

import os
import signal
import threading
from typing import Iterable, Optional

__all__ = ["PreemptionGuard", "TrainingPreempted", "RESUMABLE_EXIT_CODE",
           "exit_resumable"]

# os.EX_TEMPFAIL: "temporary failure, retry" — distinct from 0 (done),
# generic 1 (bug), and 124 (watchdog hard-exit on a hung step)
RESUMABLE_EXIT_CODE = 75


class TrainingPreempted(SystemExit):
    """Raised at a step boundary after the final checkpoint is durable.

    Subclasses SystemExit with RESUMABLE_EXIT_CODE: unhandled, the process
    exits with the resumable status; in-process relaunchers
    (ElasticManager.run) catch it and resume without burning the restart
    budget."""

    def __init__(self, step: Optional[int] = None):
        super().__init__(RESUMABLE_EXIT_CODE)
        self.step = step

    def __str__(self):
        return (f"training preempted at step {self.step}; state checkpointed,"
                f" exit {RESUMABLE_EXIT_CODE} (resumable)")


class PreemptionGuard:
    """Latching signal handler usable as a context manager::

        with PreemptionGuard() as guard:
            trainer.fit(..., preemption_guard=guard)

    A second SIGINT bypasses the orderly path (user really wants out, now).
    Installing from a non-main thread is a no-op (signal API limitation);
    :meth:`trigger` still works, so tests and external pollers can latch it
    manually.
    """

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM,
                                                 signal.SIGINT)):
        self.signals = tuple(signals)
        self._flag = threading.Event()
        self._prev = {}
        self._counts = {}
        self.installed = False

    # -- lifecycle ----------------------------------------------------------

    def install(self) -> "PreemptionGuard":
        if self.installed:
            return self
        try:
            for sig in self.signals:
                self._prev[sig] = signal.signal(sig, self._handler)
            self.installed = True
        except ValueError:       # not the main thread
            self._prev.clear()
        return self

    def uninstall(self) -> None:
        if not self.installed:
            return
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
        self._prev.clear()
        self.installed = False

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, *exc) -> bool:
        self.uninstall()
        return False

    # -- state --------------------------------------------------------------

    @property
    def preempted(self) -> bool:
        return self._flag.is_set()

    def trigger(self) -> None:
        """Latch without a signal (tests; external maintenance-event
        pollers that learn of preemption out-of-band)."""
        self._flag.set()

    def clear(self) -> None:
        """Reset the latch for a new run attempt. A guard REUSED across
        in-process relaunches (one guard outside ElasticManager.run) must
        be cleared per attempt, or the resumed fit re-preempts at its
        first step boundary; per-attempt guards don't need this."""
        self._flag.clear()

    def _handler(self, signum, frame):
        n = self._counts.get(signum, 0) + 1
        self._counts[signum] = n
        self._flag.set()
        if signum == signal.SIGINT and n >= 2:
            raise KeyboardInterrupt   # second ^C: skip the orderly path


def exit_resumable() -> None:
    """Hard process exit with the resumable status (for code paths that
    cannot raise through, e.g. daemon threads)."""
    os._exit(RESUMABLE_EXIT_CODE)
