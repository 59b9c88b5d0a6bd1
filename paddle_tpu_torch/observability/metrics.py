"""Process-wide metrics registry: Counter / Gauge / Histogram with labels
(copy of ``paddle_tpu/observability/metrics.py``).

A metric mutation while the registry is disabled is one attribute load
and a branch, so instrumented hot paths (the serving engine's ticks, the
fabric's passes) cost nothing in runs that do not opt in.

The registry is stdlib-only and pull-based:

* **Instruments** — :class:`Counter` (monotonic), :class:`Gauge`
  (point-in-time), :class:`Histogram` (bucketed counts + sum/count + a
  bounded reservoir for percentile summaries). Label sets are kwargs; each
  distinct label combination is its own series.
* **Collection** — :meth:`MetricsRegistry.collect` snapshots every series
  into plain dicts; whatever renders them reads the snapshot, never live
  state.
* **Sample ring** — when a ring is attached, every accepted mutation also
  appends ``(ts, name, labels, value)`` to a bounded deque.

Threading: one registry lock taken only on the enabled path.
"""

from __future__ import annotations

import math
import threading
import time
import warnings
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
           "registry", "enabled", "DEFAULT_BUCKETS", "MAX_LABEL_SETS"]

# Prometheus-style default latency buckets (seconds), inf implied
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

_RESERVOIR = 1024        # recent observations kept per histogram series

# label-cardinality guard: distinct label sets a
# single metric may hold before new ones fold into the overflow series —
# a buggy per-request label (rid=..., trace_id=...) must not grow
# collect()/export cost without bound in a long-lived process
MAX_LABEL_SETS = 128
_OVERFLOW_LABELS = {"label_overflow": "true"}
_OVERFLOW_KEY = (("label_overflow", "true"),)


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Metric:
    """Base: name + help + unit, per-label-set series under the registry
    lock. Subclasses only define the series payload and its mutation."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "", unit: str = "",
                 registry: "MetricsRegistry" = None):
        self.name = name
        self.help = help
        self.unit = unit
        self._series: Dict[Tuple, object] = {}
        self._reg = registry
        self._overflow_warned = False

    def _slot(self, labels: Dict[str, str]) -> Tuple[Tuple, Dict]:
        """(series key, effective labels) under the registry lock.
        Existing series always resolve to themselves; a NEW label set
        past the per-metric cap folds into the ``label_overflow="true"``
        series (warned once per metric) so cardinality stays bounded
        while the mutation is still counted somewhere visible."""
        key = _label_key(labels)
        if key in self._series:
            return key, labels
        cap = self._reg.max_label_sets
        if cap is not None and len(self._series) >= cap \
                and key != _OVERFLOW_KEY:
            if not self._overflow_warned:
                self._overflow_warned = True
                warnings.warn(
                    f"metric {self.name!r}: over {cap} distinct label "
                    f"sets — folding new ones into label_overflow="
                    f"\"true\" (check for an unbounded per-request "
                    f"label)", RuntimeWarning, stacklevel=3)
            return _OVERFLOW_KEY, dict(_OVERFLOW_LABELS)
        return key, labels

    def _sample(self, labels: Dict[str, str], value: float) -> None:
        ring = self._reg._ring
        if ring is not None:
            ring.append((time.time(), self.name, labels, value))

    def labels_seen(self) -> List[Dict[str, str]]:
        with self._reg._lock:
            return [dict(k) for k in self._series]

    def clear(self, **labels) -> None:
        """Drop one series. The percentile-publishing contract: a
        publisher whose source window went empty clears its gauge rather
        than leaving the last value to read as current — an absent series
        is honest, a stale one lies. Disabled plane: no-op like every
        other mutator — disable() disarms but deliberately
        keeps series (reset() is the destructive call)."""
        if not self._reg.enabled:
            return
        with self._reg._lock:
            self._series.pop(_label_key(labels), None)


class Counter(_Metric):
    kind = "counter"

    def inc(self, value: float = 1.0, **labels) -> None:
        reg = self._reg
        if not reg.enabled:
            return
        if value < 0:
            raise ValueError(f"counter {self.name}: negative increment")
        with reg._lock:
            key, labels = self._slot(labels)
            self._series[key] = self._series.get(key, 0.0) + value
            self._sample(labels, self._series[key])

    def value(self, **labels) -> float:
        with self._reg._lock:
            return float(self._series.get(_label_key(labels), 0.0))


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        reg = self._reg
        if not reg.enabled:
            return
        with reg._lock:
            key, labels = self._slot(labels)
            self._series[key] = float(value)
            self._sample(labels, float(value))

    def add(self, value: float, **labels) -> None:
        reg = self._reg
        if not reg.enabled:
            return
        with reg._lock:
            key, labels = self._slot(labels)
            self._series[key] = self._series.get(key, 0.0) + float(value)
            self._sample(labels, self._series[key])

    def value(self, **labels) -> float:
        with self._reg._lock:
            return float(self._series.get(_label_key(labels), 0.0))


class _HistSeries:
    __slots__ = ("counts", "sum", "count", "recent")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)   # +1 = +Inf bucket
        self.sum = 0.0
        self.count = 0
        self.recent = deque(maxlen=_RESERVOIR)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help: str = "", unit: str = "",
                 registry: "MetricsRegistry" = None,
                 buckets: Iterable[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, unit, registry)
        self.buckets = tuple(sorted(float(b) for b in buckets))

    def observe(self, value: float, **labels) -> None:
        reg = self._reg
        if not reg.enabled:
            return
        value = float(value)
        with reg._lock:
            key, labels = self._slot(labels)
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = _HistSeries(len(self.buckets))
            i = 0
            for b in self.buckets:
                if value <= b:
                    break
                i += 1
            s.counts[i] += 1
            s.sum += value
            s.count += 1
            s.recent.append(value)
            self._sample(labels, value)

    def percentile(self, q: float, **labels) -> Optional[float]:
        """Percentile over the bounded reservoir of recent observations
        (summary convenience — the exact data lives in the buckets)."""
        with self._reg._lock:
            s = self._series.get(_label_key(labels))
            if s is None or not s.recent:
                return None
            vals = sorted(s.recent)
        idx = min(len(vals) - 1, max(0, math.ceil(q / 100.0 * len(vals)) - 1))
        return float(vals[idx])


class MetricsRegistry:
    """Named-metric table + the process-wide enable switch.

    ``enabled`` is False until a sample ring attaches (or
    :meth:`enable` is called): every instrument mutation short-circuits on
    that one flag, which is what keeps instrumented code near-zero cost in
    runs that never look at metrics."""

    def __init__(self):
        # reentrant: a signal or exception handler that collects on the
        # main thread may interrupt a frame that already holds this lock
        self._lock = threading.RLock()
        self._metrics: Dict[str, _Metric] = {}
        self.enabled = False
        self._ring: Optional[deque] = None
        # per-metric distinct-label-set cap (None disables the guard)
        self.max_label_sets: Optional[int] = MAX_LABEL_SETS

    # -- construction (get-or-create; idempotent by name) -------------------

    def _get(self, cls, name, help, unit, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, unit,
                                              registry=self, **kw)
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{m.kind}, not {cls.kind}")
            return m

    def counter(self, name: str, help: str = "", unit: str = "") -> Counter:
        return self._get(Counter, name, help, unit)

    def gauge(self, name: str, help: str = "", unit: str = "") -> Gauge:
        return self._get(Gauge, name, help, unit)

    def histogram(self, name: str, help: str = "", unit: str = "",
                  buckets: Iterable[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, unit, buckets=buckets)

    # -- lifecycle -----------------------------------------------------------

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def attach_ring(self, ring: deque) -> None:
        """Route every accepted sample into ``ring``;
        implies enable() — samples must flow to be recorded."""
        self._ring = ring
        self.enabled = True

    def detach_ring(self) -> None:
        self._ring = None

    def reset(self) -> None:
        """Drop every series (tests / bench probes). Metric OBJECTS stay
        registered so cached references in instrumented modules stay
        valid."""
        with self._lock:
            for m in self._metrics.values():
                m._series = {}

    # -- collection -----------------------------------------------------------

    def collect(self) -> List[dict]:
        """Snapshot every series as plain dicts (one entry per label set):

        counters/gauges: ``{"name","type","unit","labels","value"}``
        histograms add ``{"count","sum","buckets":[[le,cumcount],...],
        "p50","p99"}``.
        """
        out: List[dict] = []
        with self._lock:
            items = [(m, dict(m._series)) for m in self._metrics.values()]
        for m, series in items:
            if m.kind == "histogram" and not series:
                # stable series set for scrapers: a
                # registered histogram that has observed nothing still
                # exposes its zeroed _bucket/_sum/_count lines — a series
                # that appears only on first observation looks like a
                # target reset to dashboards and breaks rate() queries
                rows = [[le, 0] for le in list(m.buckets) + ["+Inf"]]
                out.append({"name": m.name, "type": m.kind, "unit": m.unit,
                            "labels": {}, "count": 0, "sum": 0.0,
                            "buckets": rows})
                continue
            for key, payload in series.items():
                entry = {"name": m.name, "type": m.kind, "unit": m.unit,
                         "labels": dict(key)}
                if m.kind == "histogram":
                    cum, rows = 0, []
                    for le, c in zip(list(m.buckets) + ["+Inf"],
                                     payload.counts):
                        cum += c
                        rows.append([le, cum])
                    entry.update(count=payload.count,
                                 sum=round(payload.sum, 9), buckets=rows)
                    for q in (50, 99):
                        p = m.percentile(q, **dict(key))
                        if p is not None:
                            entry[f"p{q}"] = round(p, 9)
                else:
                    entry["value"] = payload
                out.append(entry)
        return out


REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-wide registry (the moral analogue of RecordEvent's
    process-wide collector)."""
    return REGISTRY


def enabled() -> bool:
    return REGISTRY.enabled
