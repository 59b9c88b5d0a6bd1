"""paddle_tpu_torch.profiler — host tracing with the reference's API shape
(copy of ``paddle_tpu/profiler/__init__.py``).

Host events are collected in-process (perf_counter_ns spans per thread);
the device side is ``torch.profiler`` (CPU and CUDA activities, its chrome
trace written into ``device_trace_dir``). The scheduler state machine,
the RecordEvent instrumentation API, the chrome-trace export and the
summary keep the reference's shape, so profiling code ports 1:1.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import defaultdict
from enum import Enum, IntEnum
from typing import Callable, Iterable, Optional

__all__ = [
    "ProfilerTarget", "ProfilerState", "make_scheduler", "RecordEvent",
    "Profiler", "export_chrome_tracing", "export_protobuf", "load_profiler_result",
    "SummaryView", "SortedKeys", "benchmark", "SERVING_EVENTS",
    "serving_trace",
]

# tick-level spans the async ContinuousBatchingEngine emits through
# RecordEvent (near-zero cost unless a Profiler is recording): request
# admission, per-slot prefill (full or chunked), decode-block dispatch,
# and the async device→host drain/reconcile. A chrome trace of one
# serving run shows dispatch N+1 opening before drain N closes — the
# overlap the engine's in-flight window exists to create.
SERVING_EVENTS = ("serving::admit", "serving::prefill",
                  "serving::dispatch", "serving::drain")


class ProfilerTarget(Enum):
    CPU = 0
    GPU = 1
    TPU = 2
    CUSTOM_DEVICE = 3


class ProfilerState(Enum):
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3  # last RECORD step of a cycle: trace is handed out


def make_scheduler(*, closed: int, ready: int, record: int, repeat: int = 0,
                   skip_first: int = 0) -> Callable[[int], ProfilerState]:
    """Step→state schedule (reference profiler.py:117): skip_first CLOSED
    steps once, then cycles of [closed CLOSED | ready READY | record RECORD],
    the last record step returning RECORD_AND_RETURN. repeat=0 → forever."""
    if closed < 0 or ready < 0 or record <= 0:
        raise ValueError("make_scheduler: closed/ready >= 0, record >= 1")
    span = closed + ready + record

    def schedule(step: int) -> ProfilerState:
        if step < skip_first:
            return ProfilerState.CLOSED
        step -= skip_first
        if repeat and step >= repeat * span:
            return ProfilerState.CLOSED
        pos = step % span
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == span - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD

    return schedule


def _default_scheduler(step: int) -> ProfilerState:
    # reference default: record everything from start()
    return ProfilerState.RECORD


# ---------------------------------------------------------------------------
# host event collection
# ---------------------------------------------------------------------------

class _HostEvent:
    __slots__ = ("name", "start_ns", "end_ns", "tid", "event_type")

    def __init__(self, name, start_ns, end_ns, tid, event_type):
        self.name = name
        self.start_ns = start_ns
        self.end_ns = end_ns
        self.tid = tid
        self.event_type = event_type


class _Collector:
    """Process-wide host-event sink; enabled only while a Profiler records."""

    def __init__(self):
        self.events: list[_HostEvent] = []
        self.enabled = False
        self._lock = threading.Lock()

    def add(self, ev: _HostEvent):
        with self._lock:
            if self.enabled:
                self.events.append(ev)

    def drain(self) -> list[_HostEvent]:
        with self._lock:
            evs, self.events = self.events, []
        return evs


_collector = _Collector()

# optional second sink: a bounded deque the observability flight recorder
# attaches so the last few hundred spans survive to a crash dump EVEN when
# no Profiler is recording. None (the default) keeps RecordEvent's
# near-zero disabled cost: one module-global load + None check.
_flight_sink = None


def set_flight_sink(sink) -> None:
    """Attach/detach (None) the flight-recorder span ring. Entries are
    ``(name, start_ns, end_ns, tid, event_type)`` tuples appended at span
    end; the deque's maxlen bounds memory."""
    global _flight_sink
    _flight_sink = sink


class RecordEvent:
    """Instrumentation span (reference: paddle.profiler.RecordEvent; C++
    platform/profiler RecordEvent). Usable as context manager or
    begin()/end() pair; near-zero overhead when no profiler is recording."""

    def __init__(self, name: str, event_type: str = "UserDefined"):
        self.name = name
        self.event_type = event_type
        self._start_ns = None

    def begin(self):
        self._start_ns = time.perf_counter_ns()

    def end(self):
        if self._start_ns is None:
            return
        if _collector.enabled:
            _collector.add(_HostEvent(self.name, self._start_ns,
                                      time.perf_counter_ns(),
                                      threading.get_ident(), self.event_type))
        sink = _flight_sink
        if sink is not None:
            sink.append((self.name, self._start_ns, time.perf_counter_ns(),
                         threading.get_ident(), self.event_type))
        self._start_ns = None

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False


# ---------------------------------------------------------------------------
# trace result + exporters
# ---------------------------------------------------------------------------

class ProfilerResult:
    def __init__(self, events: list[_HostEvent], step_range, device_trace_dir):
        self.events = events
        self.step_range = step_range
        self.device_trace_dir = device_trace_dir

    def chrome_trace(self) -> dict:
        items = []
        for ev in self.events:
            items.append({
                "name": ev.name, "ph": "X", "cat": ev.event_type,
                "pid": os.getpid(), "tid": ev.tid,
                "ts": ev.start_ns / 1000.0,
                "dur": (ev.end_ns - ev.start_ns) / 1000.0,
            })
        return {"traceEvents": items,
                "metadata": {"framework": "paddle_tpu_torch",
                             "steps": list(self.step_range)}}

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)


def export_chrome_tracing(dir_name: str, worker_name: Optional[str] = None):
    """on_trace_ready handler writing chrome://tracing JSON
    (reference profiler.py:215)."""
    os.makedirs(dir_name, exist_ok=True)

    def handler(prof: "Profiler"):
        name = worker_name or f"host_{os.getpid()}"
        n = prof._export_count
        path = os.path.join(dir_name, f"{name}_step{n}.json")
        prof.result.save(path)
        return path

    return handler


def export_protobuf(dir_name: str, worker_name: Optional[str] = None):
    """Parity shim for the reference's protobuf exporter: the device side is
    written as a chrome trace by torch.profiler into the trace dir; the host
    side exports chrome JSON next to it."""
    return export_chrome_tracing(dir_name, worker_name)


def load_profiler_result(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class SummaryView(Enum):
    DeviceView = 0
    OverView = 1
    ModelView = 2
    DistributedView = 3
    KernelView = 4
    OperatorView = 5
    MemoryView = 6
    MemoryManipulationView = 7
    UDFView = 8


class SortedKeys(IntEnum):
    """Summary sort orders (reference: python/paddle/profiler/profiler.py
    SortedKeys enum). IntEnum: reference code compares members to ints.
    Host events are the only table here (the device side is torch.profiler's
    own trace), so
    the GPU* keys sort by the same host aggregates as their CPU twins."""
    CPUTotal = 0
    CPUAvg = 1
    CPUMax = 2
    CPUMin = 3
    GPUTotal = 4
    GPUAvg = 5
    GPUMax = 6
    GPUMin = 7


# sort key per order: aggregate of the per-name duration list, table sorted
# DESCENDING on it (largest first — the reference's convention); *Min uses
# the smallest single call so "which op has the worst best-case" reads off
# the top.
_SORT_AGG = {
    SortedKeys.CPUTotal: sum, SortedKeys.GPUTotal: sum,
    SortedKeys.CPUAvg: lambda d: sum(d) / len(d),
    SortedKeys.GPUAvg: lambda d: sum(d) / len(d),
    SortedKeys.CPUMax: max, SortedKeys.GPUMax: max,
    SortedKeys.CPUMin: min, SortedKeys.GPUMin: min,
}


# ---------------------------------------------------------------------------
# Profiler
# ---------------------------------------------------------------------------

class Profiler:
    """Reference-shaped profiler (profiler.py:346).

        p = Profiler(scheduler=make_scheduler(closed=1, ready=1, record=2),
                     on_trace_ready=export_chrome_tracing("./prof"))
        p.start()
        for step, batch in enumerate(loader):
            train(batch)
            p.step()
        p.stop()
        print(p.summary())

    ``timer_only=True`` collects ips/step timing without event tracing.
    Device-side tracing (``torch.profiler``, CPU and CUDA activities)
    activates when ``trace_device=True`` and writes its chrome trace into
    ``device_trace_dir`` at the end of each recording cycle.
    """

    def __init__(self, *, targets: Optional[Iterable[ProfilerTarget]] = None,
                 scheduler=None, on_trace_ready: Optional[Callable] = None,
                 timer_only: bool = False, trace_device: bool = False,
                 device_trace_dir: str = "./profiler_device_trace"):
        del targets  # host events always on; device via trace_device
        if scheduler is None:
            self.scheduler = _default_scheduler
        elif callable(scheduler):
            self.scheduler = scheduler
        elif isinstance(scheduler, (tuple, list)) and len(scheduler) == 2:
            lo, hi = scheduler
            self.scheduler = make_scheduler(closed=max(lo, 0), ready=0,
                                            record=hi - lo, repeat=1)
        else:
            raise TypeError(f"bad scheduler {scheduler!r}")
        self.on_trace_ready = on_trace_ready
        self.timer_only = timer_only
        self.trace_device = trace_device
        self.device_trace_dir = device_trace_dir
        self.step_num = 0
        self.result: Optional[ProfilerResult] = None
        self._state = ProfilerState.CLOSED
        self._record_start_step = 0
        self._export_count = 0
        self._step_times: list[float] = []
        self._samples_total = 0
        self._last_step_t: Optional[float] = None
        self._device_tracing = False
        self._device_prof = None

    # -- state machine -----------------------------------------------------

    def _transition(self, new_state: ProfilerState):
        old = self._state
        recording = lambda s: s in (ProfilerState.RECORD,
                                    ProfilerState.RECORD_AND_RETURN)
        # RECORD_AND_RETURN marks the *last* step of a cycle: its trace is
        # exported on the next transition regardless of destination state,
        # so back-to-back cycles (RAR→RECORD, RAR→RAR) each export.
        was_recording = recording(old)
        if old == ProfilerState.RECORD_AND_RETURN:
            self._finish_cycle()
            was_recording = False
        if old == new_state and new_state != ProfilerState.RECORD_AND_RETURN \
                and was_recording == recording(new_state):
            return
        if not was_recording and recording(new_state):
            self._record_start_step = self.step_num
            if not self.timer_only:
                _collector.enabled = True
                _collector.drain()
            if self.trace_device:
                self._start_device_trace()
        elif was_recording and not recording(new_state):
            self._finish_cycle()
        self._state = new_state

    def _start_device_trace(self):
        try:
            import torch
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            os.makedirs(self.device_trace_dir, exist_ok=True)
            self._device_prof = torch.profiler.profile(activities=acts)
            self._device_prof.__enter__()
            self._device_tracing = True
        except Exception:
            self._device_prof = None
            self._device_tracing = False

    def _stop_device_trace(self):
        if self._device_tracing:
            try:
                self._device_prof.__exit__(None, None, None)
                self._device_prof.export_chrome_trace(os.path.join(
                    self.device_trace_dir,
                    f"device_{os.getpid()}_step{self._export_count}.json"))
            except Exception:
                pass
            self._device_tracing = False

    def _finish_cycle(self):
        _collector.enabled = False
        events = _collector.drain()
        self._stop_device_trace()
        self.result = ProfilerResult(
            events, range(self._record_start_step, self.step_num + 1),
            self.device_trace_dir if self.trace_device else None)
        if self.on_trace_ready is not None:
            self.on_trace_ready(self)
        self._export_count += 1

    # -- user API ----------------------------------------------------------

    def start(self):
        self._last_step_t = time.perf_counter()
        self._transition(self.scheduler(self.step_num))

    def step(self, num_samples: Optional[int] = None):
        now = time.perf_counter()
        if self._last_step_t is not None:
            self._step_times.append(now - self._last_step_t)
            if num_samples is not None:
                # samples processed by the step that just finished —
                # accumulated so step_info can report TRUE samples/sec
                self._samples_total += int(num_samples)
        self._last_step_t = now
        self.step_num += 1
        self._transition(self.scheduler(self.step_num))

    def stop(self):
        self._transition(ProfilerState.CLOSED)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- reporting ---------------------------------------------------------

    def step_info(self, unit: str = "samples/sec") -> str:
        """Throughput line. When ``step(num_samples=...)`` supplied sample
        counts, reports accumulated-samples / elapsed ("<rate> <unit>");
        otherwise the rate is steps/sec and is LABELED steps/sec — the old
        behavior reported steps/sec under a "samples/sec" banner."""
        if not self._step_times:
            return "no steps recorded"
        total = sum(self._step_times)
        avg = total / len(self._step_times)
        if self._samples_total and total > 0:
            rate, label = self._samples_total / total, unit
        else:
            rate, label = 1.0 / avg, "steps/sec"
        return f"avg step time {avg * 1000:.2f} ms ({rate:.2f} {label})"

    def summary(self, sorted_by=None, views=None) -> str:
        """Aggregated per-name host-event table (profiler_statistic shape),
        sorted by ``sorted_by`` (a :class:`SortedKeys`, its int value, or
        None = CPUTotal)."""
        if sorted_by is None:
            sorted_by = SortedKeys.CPUTotal
        elif not isinstance(sorted_by, SortedKeys):
            sorted_by = SortedKeys(sorted_by)
        agg_fn = _SORT_AGG[sorted_by]
        agg: dict[str, list[float]] = defaultdict(list)
        events = self.result.events if self.result else []
        for ev in events:
            agg[ev.name].append((ev.end_ns - ev.start_ns) / 1e6)
        rows = sorted(agg.items(), key=lambda kv: -agg_fn(kv[1]))
        lines = [f"{'Name':<40} {'Calls':>6} {'Total(ms)':>12} "
                 f"{'Avg(ms)':>10} {'Max(ms)':>10} {'Min(ms)':>10}"]
        for name, durs in rows:
            lines.append(f"{name[:40]:<40} {len(durs):>6} {sum(durs):>12.3f} "
                         f"{sum(durs) / len(durs):>10.3f} {max(durs):>10.3f} "
                         f"{min(durs):>10.3f}")
        lines.append(self.step_info())
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# ips benchmark timer (reference: python/paddle/profiler/timer.py, used by
# hapi to report ips)
# ---------------------------------------------------------------------------

class _BenchmarkTimer:
    def __init__(self):
        self.reset()

    def reset(self):
        self._times: list[float] = []
        self._samples: list[int] = []
        self._t0: Optional[float] = None

    def begin(self):
        self._t0 = time.perf_counter()

    def step(self, num_samples: int = 1):
        now = time.perf_counter()
        if self._t0 is not None:
            self._times.append(now - self._t0)
            self._samples.append(num_samples)
        self._t0 = now

    def report(self) -> dict:
        if not self._times:
            return {"ips": 0.0, "avg_step_ms": 0.0, "steps": 0}
        total = sum(self._times)
        return {"ips": sum(self._samples) / total if total else 0.0,
                "avg_step_ms": total / len(self._times) * 1000.0,
                "steps": len(self._times)}


_benchmark = _BenchmarkTimer()


def benchmark() -> _BenchmarkTimer:
    """Global ips timer (reference: paddle.profiler.utils.benchmark)."""
    return _benchmark


class serving_trace:
    """Context manager tracing a serving-engine run into a chrome trace:

        with profiler.serving_trace("./prof") as p:
            engine.run()
        # ./prof/<worker>_step0.json: admit/prefill/dispatch/drain spans

    Wraps a RECORD-always Profiler wired to ``export_chrome_tracing`` so
    the engine's SERVING_EVENTS spans (and any other RecordEvent in the
    process) land in one chrome://tracing JSON per recording."""

    def __init__(self, dir_name: str, worker_name: Optional[str] = None,
                 trace_device: bool = False):
        self._prof = Profiler(
            on_trace_ready=export_chrome_tracing(dir_name, worker_name),
            trace_device=trace_device)

    def __enter__(self) -> Profiler:
        self._prof.start()
        return self._prof

    def __exit__(self, *exc):
        self._prof.stop()
        return False
