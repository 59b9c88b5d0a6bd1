"""Crash flight recorder — bounded ring of recent telemetry, dumped on
abort (copy of ``paddle_tpu/observability/flight_recorder.py``).

A post-mortem of a multi-day run needs the last few seconds of context, not
a live dashboard: what the loss was doing, which spans were in flight,
where the serving engine's queues stood. The recorder keeps two bounded
rings — recent metric samples (wired into the registry) and recent
``RecordEvent`` spans (wired into the profiler's flight sink, recorded even
when no Profiler is running) — and serializes both plus a full registry
snapshot to ``flight_<ts>.json`` when something dies:

* **anomaly abort** — ``AnomalyGuard.raise_divergence`` dumps with the
  final loss window attached;
* **unhandled exception** — a chained ``sys.excepthook``;
* **SIGTERM** — a chained signal handler (installed only when the slot is
  free or chainable; the PreemptionGuard's orderly path dumps explicitly
  from the trainer instead, since its TrainingPreempted exit never reaches
  the excepthook).

``Trainer.fit(checkpoint_manager=...)`` points the dump directory next to
the manager's quarantine dir (``<root>/_flight/``), so the post-mortem
ships with the checkpoint state it describes.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
import traceback
from collections import deque
from typing import Optional

from .metrics import REGISTRY

__all__ = ["FlightRecorder", "recorder", "install", "maybe_dump", "set_dir"]

_SPAN_RING = 512         # recent RecordEvent spans kept
_SAMPLE_RING = 4096      # recent metric samples kept


def _strict_json(obj):
    """Replace non-finite floats with strings so the dump stays STRICT
    JSON (a NaN loss is exactly what an anomaly dump carries, and bare
    ``NaN`` tokens break every non-Python parser)."""
    if isinstance(obj, float):
        return obj if obj == obj and obj not in (float("inf"),
                                                 float("-inf")) else repr(obj)
    if isinstance(obj, dict):
        return {k: _strict_json(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_strict_json(v) for v in obj]
    return obj


class FlightRecorder:
    def __init__(self, dir: str = ".", span_capacity: int = _SPAN_RING,
                 sample_capacity: int = _SAMPLE_RING):
        self.dir = dir
        self.spans = deque(maxlen=span_capacity)
        self.samples = deque(maxlen=sample_capacity)
        self.active = False
        self.installed = False
        # RLock: a SIGTERM arriving mid-dump must not deadlock the
        # handler's own dump on the same (main) thread
        self._lock = threading.RLock()
        self._prev_excepthook = None
        self._prev_sigterm = None
        self.last_dump_path: Optional[str] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "FlightRecorder":
        """Begin recording: metric samples flow into the sample ring (this
        enables the registry) and RecordEvent spans into the span ring."""
        from .. import profiler as _prof
        REGISTRY.attach_ring(self.samples)
        _prof.set_flight_sink(self.spans)
        self.active = True
        return self

    def stop(self) -> None:
        from .. import profiler as _prof
        if REGISTRY._ring is self.samples:
            REGISTRY.detach_ring()
        _prof.set_flight_sink(None)
        self.active = False

    def install(self, excepthook: bool = True, sigterm: bool = True
                ) -> "FlightRecorder":
        """Hook the process-death paths. Both hooks CHAIN the previous
        handler, so installing never hides an existing crash reporter."""
        if not self.active:
            self.start()
        if self.installed:
            return self
        if excepthook:
            self._prev_excepthook = sys.excepthook
            sys.excepthook = self._excepthook
        if sigterm:
            try:
                self._prev_sigterm = signal.signal(signal.SIGTERM,
                                                   self._sigterm)
            except ValueError:       # not the main thread
                self._prev_sigterm = None
        self.installed = True
        return self

    def uninstall(self) -> None:
        if not self.installed:
            return
        if self._prev_excepthook is not None:
            sys.excepthook = self._prev_excepthook
            self._prev_excepthook = None
        if self._prev_sigterm is not None:
            try:
                signal.signal(signal.SIGTERM, self._prev_sigterm)
            except (ValueError, OSError):
                pass
            self._prev_sigterm = None
        self.installed = False

    # -- triggers ------------------------------------------------------------

    def _excepthook(self, exc_type, exc, tb):
        if not issubclass(exc_type, (SystemExit, KeyboardInterrupt)):
            try:
                self.dump("unhandled_exception", extra={
                    "exception": "".join(
                        traceback.format_exception_only(exc_type, exc))
                    .strip(),
                    "traceback": "".join(
                        traceback.format_tb(tb))[-4000:],
                })
            except Exception:
                pass
        prev = self._prev_excepthook or sys.__excepthook__
        prev(exc_type, exc, tb)

    def _sigterm(self, signum, frame):
        try:
            self.dump("sigterm")
        except Exception:
            pass
        prev = self._prev_sigterm
        if callable(prev):
            prev(signum, frame)
        elif prev == signal.SIG_DFL:
            signal.signal(signum, signal.SIG_DFL)
            os.kill(os.getpid(), signum)

    # -- dump ----------------------------------------------------------------

    def dump(self, reason: str, extra: Optional[dict] = None) -> str:
        """Serialize rings + a full registry snapshot to
        ``flight_<ts>.json`` (atomic rename) and return the path."""
        with self._lock:
            spans = [{"name": n, "start_ns": s, "end_ns": e, "tid": t,
                      "cat": c} for (n, s, e, t, c) in list(self.spans)]
            samples = [{"ts": ts, "name": n, "labels": dict(lb), "value": v}
                       for (ts, n, lb, v) in list(self.samples)]
        try:
            from .goodput import ledger
            goodput = ledger().totals()
        except Exception:
            goodput = {}
        try:
            # distributed tracing: the tracer's bounded ring
            # of complete request traces rides into the dump — serving
            # post-mortems carry request context, not just samples
            from .tracing import TRACER
            traces = TRACER.recent_traces() if TRACER.enabled else []
        except Exception:
            traces = []
        payload = {
            "reason": reason,
            "ts": time.time(),
            "pid": os.getpid(),
            "goodput": goodput,
            "metrics_snapshot": REGISTRY.collect(),
            "recent_samples": samples,
            "recent_spans": spans,
            "recent_traces": traces,
            "extra": extra or {},
        }
        os.makedirs(self.dir, exist_ok=True)
        stamp = time.strftime("%Y%m%dT%H%M%S")
        base = os.path.join(self.dir, f"flight_{stamp}")
        path, k = base + ".json", 0
        while os.path.exists(path):
            k += 1
            path = f"{base}-{k}.json"
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(_strict_json(payload), f, default=str,
                      allow_nan=False)
        os.replace(tmp, path)
        self.last_dump_path = path
        return path


_RECORDER = FlightRecorder()


def recorder() -> FlightRecorder:
    return _RECORDER


def install(dir: Optional[str] = None, **kw) -> FlightRecorder:
    if dir is not None:
        _RECORDER.dir = dir
    return _RECORDER.install(**kw)


def set_dir(dir: str) -> None:
    """Re-point dumps (Trainer.fit wires this next to the checkpoint
    quarantine dir)."""
    _RECORDER.dir = dir


def maybe_dump(reason: str, extra: Optional[dict] = None) -> Optional[str]:
    """Dump iff the recorder is active — the hook instrumented code calls
    unconditionally (AnomalyGuard abort, preemption exit); a run that never
    opted into observability writes nothing."""
    if not _RECORDER.active:
        return None
    try:
        return _RECORDER.dump(reason, extra=extra)
    except Exception:
        return None
