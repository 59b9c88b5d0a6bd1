"""Step/collective hang watchdog (copy of
``paddle_tpu/distributed/watchdog.py``).

Reference analogue: paddle/phi/core/distributed/comm_task_manager.cc (the
CommTaskManager loop that watches enqueued NCCL tasks and aborts/logs when
one exceeds its timeout) and the FLAGS_enable_async_trace stack dumps.
Elastic heartbeats detect dead *processes*; a *hung step* — a wedged
collective or device sync — blocks inside a synchronize forever with the
process perfectly alive.

The observable unit is the TRAINING STEP: the trainer ticks the watchdog
at each step boundary; a daemon thread fires when no tick arrives within
the timeout. On fire it dumps all python thread stacks (the hung frame
shows which sync wedged), runs the user callback, and — when
``action='kill'`` — hard-exits (code 124) so a relauncher restarts the
worker, which is the reference's abort-on-timeout posture
(comm_task_manager.cc store-based barrier abort).

Enable globally via env PT_STEP_TIMEOUT_S (picked up by Trainer) or
explicitly:

    wd = StepWatchdog(timeout_s=300, action="log")
    wd.start()
    for batch in loader:
        with wd.step():
            trainer.train_step(batch)
"""

from __future__ import annotations

import faulthandler
import os
import sys
import threading
import time
from typing import Callable, Optional

__all__ = ["StepWatchdog", "watchdog_from_env"]


class StepWatchdog:
    def __init__(self, timeout_s: float, action: str = "log",
                 on_timeout: Optional[Callable[[float], None]] = None,
                 poll_interval_s: Optional[float] = None):
        if action not in ("log", "kill"):
            raise ValueError("action must be 'log' or 'kill'")
        self.timeout_s = float(timeout_s)
        self.action = action
        self.on_timeout = on_timeout
        self._poll = poll_interval_s or max(self.timeout_s / 10.0, 0.05)
        self._last_tick: Optional[float] = None
        self._step_id = 0
        self._fired = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "StepWatchdog":
        if self._thread is not None:
            return self
        self._stop.clear()          # restartable after stop()
        self._fired = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="pt-step-watchdog")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self._poll)
            self._thread = None

    # -- step boundary ------------------------------------------------------

    def tick(self):
        """Mark a step boundary: the previous step completed."""
        with self._lock:
            self._last_tick = time.monotonic()
            self._step_id += 1

    def step(self):
        """Context manager ticking on entry and exit."""
        wd = self

        class _Ctx:
            def __enter__(self):
                wd.tick()

            def __exit__(self, *exc):
                wd.tick()
                return False

        return _Ctx()

    @property
    def fired(self) -> bool:
        return self._fired

    # -- internals ----------------------------------------------------------

    def _loop(self):
        fired_step = None
        while not self._stop.wait(self._poll):
            with self._lock:
                last, step = self._last_tick, self._step_id
            if last is None:
                continue
            if fired_step is not None:
                # already reported this stall: stay alive but only re-arm
                # once progress resumes (a new tick) — with action='log' a
                # later, separate hang must still be caught
                if step != fired_step:
                    fired_step = None
                continue
            stalled = time.monotonic() - last
            if stalled > self.timeout_s:
                self._fire(step, stalled)
                fired_step = step

    def _fire(self, step, stalled):
        self._fired = True
        sys.stderr.write(
            f"[paddle_tpu_torch watchdog] step {step} has made no progress for "
            f"{stalled:.1f}s (timeout {self.timeout_s}s) — likely a hung "
            f"collective or device sync. Thread stacks follow.\n")
        sys.stderr.flush()
        try:
            faulthandler.dump_traceback(file=sys.stderr)
        except Exception:
            pass
        if self.on_timeout is not None:
            try:
                self.on_timeout(stalled)
            except Exception:
                pass
        if self.action == "kill":
            # hard exit: a wedged device sync ignores KeyboardInterrupt; the
            # elastic agent observes the death and relaunches (reference
            # posture: comm_task_manager abort + store barrier)
            os._exit(124)


def watchdog_from_env() -> Optional[StepWatchdog]:
    """StepWatchdog configured from PT_STEP_TIMEOUT_S / PT_STEP_TIMEOUT_ACTION
    (unset -> None). Used by Trainer."""
    t = os.environ.get("PT_STEP_TIMEOUT_S")
    if not t:
        return None
    action = os.environ.get("PT_STEP_TIMEOUT_ACTION", "log")
    return StepWatchdog(float(t), action=action).start()
