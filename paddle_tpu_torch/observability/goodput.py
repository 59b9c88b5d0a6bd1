"""Goodput ledger — split training wall-time into accounted buckets
(copy of ``paddle_tpu/observability/goodput.py``).

Large-scale training accounting in the Google style: *goodput* is the
fraction of wall-clock a run spends making forward progress that survives
to the final checkpoint. Everything else — compiling, checkpointing,
restoring, replaying rolled-back steps, winding down for a preemption — is
overhead the resilience/compile subsystems exist to shrink, and a number
nobody measures never shrinks.

The ledger is a wall-clock *state machine*, not a profiler: at any instant
exactly one bucket owns the clock (default ``productive_step`` while a run
is active), and :meth:`span` switches attribution for its dynamic extent.
Buckets therefore sum to the run's measured wall-time *exactly* — the
acceptance invariant — and metering happens only at the boundaries the
training loop already crosses (dispatch, log, checkpoint, restore), never
adding a device fence.

Rollback accounting works by *reclassification*: :meth:`note_checkpoint`
watermarks the productive seconds at each committed step; when the runtime
rolls back to step S, the productive time accrued since S's watermark is
moved into ``rollback_wasted`` — those steps will be replayed, so their
first execution bought nothing.

Buckets:

``productive_step``   default attribution while a run is active
``compile``           trace + compile (a compile cache meters it)
``checkpoint_save``   host-blocking part of CheckpointManager.save/finalize
``restore``           CheckpointManager.restore (resume + rollback loads)
``rollback_wasted``   productive time reclassified by note_rollback
``preemption_lost``   SIGTERM latch → orderly exit (minus nested saves)
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, Optional

from .metrics import REGISTRY

__all__ = ["BUCKETS", "GoodputLedger", "ledger"]

BUCKETS = ("productive_step", "compile", "checkpoint_save", "restore",
           "rollback_wasted", "preemption_lost")


class GoodputLedger:
    def __init__(self):
        self._lock = threading.RLock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.buckets: Dict[str, float] = {b: 0.0 for b in BUCKETS}
            self._stack = []          # nested span bucket names
            self._last_t: Optional[float] = None
            self._depth = 0           # nested run_start (fit-in-fit probes)
            self._marks: Dict[int, float] = {}   # step -> productive@mark
            self.rollbacks = 0

    # -- internal clock ------------------------------------------------------

    def _settle(self, now: float) -> None:
        """Credit the elapsed slice to the currently-owning bucket."""
        if self._last_t is None:
            return
        cur = self._stack[-1] if self._stack else "productive_step"
        self.buckets[cur] += max(0.0, now - self._last_t)
        self._last_t = now

    # -- run lifecycle -------------------------------------------------------

    @property
    def running(self) -> bool:
        return self._depth > 0

    def run_start(self) -> None:
        with self._lock:
            self._depth += 1
            if self._depth == 1:
                self._last_t = time.perf_counter()

    def run_end(self) -> None:
        with self._lock:
            if self._depth == 0:
                return
            self._settle(time.perf_counter())
            self._depth -= 1
            if self._depth == 0:
                self._last_t = None

    # -- attribution ---------------------------------------------------------

    @contextmanager
    def span(self, bucket: str):
        """Attribute the enclosed wall-time to ``bucket``. Nestable: an
        inner span owns the clock for its extent (a checkpoint save inside
        a preemption wind-down books as checkpoint_save). Outside an
        active run this is a timing no-op — the sum-to-wall-time invariant
        holds over the run window only."""
        if bucket not in self.buckets:
            raise ValueError(f"unknown goodput bucket {bucket!r}")
        with self._lock:
            if not self.running:
                active = False
            else:
                active = True
                self._settle(time.perf_counter())
                self._stack.append(bucket)
        try:
            yield self
        finally:
            if active:
                with self._lock:
                    if self.running:
                        self._settle(time.perf_counter())
                    if self._stack and self._stack[-1] == bucket:
                        self._stack.pop()

    def note_checkpoint(self, step: int) -> None:
        """Watermark the productive seconds at a committed step — the
        anchor a later rollback reclassifies against."""
        with self._lock:
            if not self.running:
                return
            self._settle(time.perf_counter())
            self._marks[int(step)] = self.buckets["productive_step"]

    def note_rollback(self, step: int) -> None:
        """Move the productive time accrued since ``step``'s watermark
        into ``rollback_wasted`` (no watermark — e.g. resumed from a
        previous process — wastes everything since run start, which is
        exactly what gets replayed)."""
        with self._lock:
            if not self.running:
                return
            self._settle(time.perf_counter())
            mark = self._marks.get(int(step), 0.0)
            wasted = max(0.0, self.buckets["productive_step"] - mark)
            self.buckets["productive_step"] -= wasted
            self.buckets["rollback_wasted"] += wasted
            self.rollbacks += 1
            # replayed ground re-marks as it is re-checkpointed
            self._marks = {s: m for s, m in self._marks.items()
                           if s <= int(step)}

    # -- reporting -----------------------------------------------------------

    def totals(self) -> Dict[str, float]:
        """Bucket seconds + ``total_s`` + ``goodput_fraction`` (productive
        over total; 0 when nothing elapsed). Settles the clock first so a
        snapshot mid-run is exact."""
        with self._lock:
            if self.running:
                self._settle(time.perf_counter())
            out = {b: round(v, 6) for b, v in self.buckets.items()}
        total = sum(out.values())
        out["total_s"] = round(total, 6)
        out["goodput_fraction"] = (
            round(out["productive_step"] / total, 6) if total > 0 else 0.0)
        return out

    def publish(self) -> None:
        """Push the bucket totals into the metrics registry (gauges
        ``pt_goodput_seconds{bucket=}`` + ``pt_goodput_fraction``)."""
        if not REGISTRY.enabled:
            return
        t = self.totals()
        g = REGISTRY.gauge("pt_goodput_seconds",
                           "wall-time per goodput bucket", "s")
        for b in BUCKETS:
            g.set(t[b], bucket=b)
        REGISTRY.gauge("pt_goodput_fraction",
                       "productive_step / total wall-time").set(
            t["goodput_fraction"])
        REGISTRY.gauge("pt_goodput_total_seconds",
                       "accounted wall-time", "s").set(t["total_s"])


_LEDGER = GoodputLedger()


def ledger() -> GoodputLedger:
    """The process-wide ledger (one training loop per process — same
    single-writer shape as the CheckpointManager)."""
    return _LEDGER
