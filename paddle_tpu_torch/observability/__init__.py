"""paddle_tpu_torch.observability — the metrics plane (counterpart of
``paddle_tpu/observability``).

The tracing half (``profiler.RecordEvent``, chrome export, serving spans)
answers *where did this microsecond go*; this package answers *how is the
system doing* — one process-wide registry where the goodput ledger,
serving and fabric latency percentiles and counters land, with exporters
(JSONL time-series, Prometheus text, console), a crash flight recorder
and the SLO sentry consuming it, and the request tracer beside it. The
cost observatory (``observability.costs``: the step census's roofline,
the OpCostDB and the live step-cost gauges) is imported on its own, as
in JAX; the tracer publishes each completed trace's critical path as
``pt_trace_ttft_frac{hop=...}`` (``analysis.critical_path``).

Zero-cost contract (same discipline as RecordEvent): every instrumented
call site guards on one registry flag; until :func:`enable` (or an
explicit exporter/flight attach) flips it, instrumentation is an attribute
load + branch.

Quickstart::

    import paddle_tpu_torch.observability as obs
    obs.enable(jsonl_path="metrics.jsonl", prom_path="metrics.prom",
               flight_dir="./flight")
    fabric.run()                       # engines and router publish
    obs.publish()                      # snapshot -> attached exporters
    print(obs.console())               # human-readable table

Pull model: :func:`collect` refreshes the derived gauges (goodput
buckets) and snapshots every series; exporters render the
snapshot. The serving engine pushes its own gauges/counters at reconcile
boundaries (`ContinuousBatchingEngine.publish_metrics`).
"""

from __future__ import annotations

from typing import List, Optional

from . import exporters as exporters  # noqa: F401 (re-export module)
from . import flight_recorder, goodput
from . import sentry as sentry  # noqa: F401 (re-export module)
from . import tracing as tracing  # noqa: F401 (re-export module)
from .exporters import (ConsoleSummary, JSONLExporter, PrometheusExporter,
                        parse_prometheus, render_prometheus)
from .goodput import GoodputLedger, ledger
from .metrics import (REGISTRY, Counter, Gauge, Histogram, MetricsRegistry,
                      enabled, registry)
from .tracing import TRACER, Span, TraceContext, Tracer, tracer

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "registry",
    "REGISTRY", "enabled", "enable", "disable", "collect", "publish",
    "console", "GoodputLedger", "ledger", "goodput", "flight_recorder",
    "sentry", "exporters", "JSONLExporter", "PrometheusExporter",
    "ConsoleSummary", "render_prometheus", "parse_prometheus",
    "observe_train_metrics",
    "tracing", "TRACER", "Tracer", "Span", "TraceContext", "tracer",
]

_EXPORTERS: List[object] = []


def enable(jsonl_path: Optional[str] = None,
           prom_path: Optional[str] = None,
           prom_http_port: Optional[int] = None,
           console: bool = False,
           flight_dir: Optional[str] = None,
           jsonl_max_bytes: Optional[int] = None,
           jsonl_keep_segments: int = 3) -> MetricsRegistry:
    """Flip the metrics plane on and attach the requested consumers.

    Every argument is optional — ``enable()`` with none just arms the
    registry (tests, ad-hoc inspection). ``prom_http_port=0`` picks an
    ephemeral port (read it back from the exporter's ``.port``).
    ``jsonl_max_bytes`` turns on JSONL segment rotation (keep-last-
    ``jsonl_keep_segments``) so a long-lived job's time-series stays
    bounded on disk.

    Idempotent per exporter kind: re-enabling replaces (closes) a
    previously attached exporter of the same kind instead of stacking a
    duplicate — a re-run setup cell must not double-write the JSONL
    time-series or re-bind the HTTP port.
    """
    def _replace(cls, factory):
        # close the old exporter BEFORE constructing the new one: a fixed
        # prom_http_port must be released before the replacement binds it
        for old in [e for e in _EXPORTERS if isinstance(e, cls)]:
            close = getattr(old, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:
                    pass
            _EXPORTERS.remove(old)
        _EXPORTERS.append(factory())

    if jsonl_path:
        _replace(JSONLExporter, lambda: JSONLExporter(
            jsonl_path, max_bytes=jsonl_max_bytes,
            keep_segments=jsonl_keep_segments))
    if prom_path or prom_http_port is not None:
        _replace(PrometheusExporter,
                 lambda: PrometheusExporter(path=prom_path,
                                            http_port=prom_http_port))
    if console:
        _replace(ConsoleSummary, lambda: ConsoleSummary(echo=True))
    if flight_dir:
        flight_recorder.install(dir=flight_dir)
    REGISTRY.enable()
    return REGISTRY


def disable() -> None:
    """Tear the plane down: close exporters, stop the flight recorder,
    disarm the registry (instrumented sites fall back to the one-branch
    no-op)."""
    for e in _EXPORTERS:
        close = getattr(e, "close", None)
        if close is not None:
            try:
                close()
            except Exception:
                pass
    _EXPORTERS.clear()
    rec = flight_recorder.recorder()
    rec.uninstall()
    rec.stop()
    REGISTRY.disable()


def attached_exporters() -> List[object]:
    return list(_EXPORTERS)


def collect() -> List[dict]:
    """Refresh derived gauges (goodput buckets), then snapshot every
    series. The JAX package also mirrors its compile cache's counters
    here; eager PyTorch has no compile cache."""
    if REGISTRY.enabled:
        ledger().publish()
    return REGISTRY.collect()


def publish() -> List[dict]:
    """collect() + hand the snapshot to every attached exporter. Safe to
    call when disabled (returns the — empty — snapshot)."""
    snap = collect()
    for e in _EXPORTERS:
        try:
            e.export(snap)
        except Exception:
            pass
    return snap


def console() -> str:
    """One-shot human-readable table of the current snapshot."""
    return ConsoleSummary().export(collect())


def observe_train_metrics(m) -> None:
    """Trainer log-boundary hook: mirror one TrainMetrics emission (any
    object with ``loss``, ``tokens_per_sec``, ``mfu``, ``lr`` and
    ``step_time_s``) into the registry. Near-zero when the plane is off
    (single guard)."""
    if not REGISTRY.enabled:
        return
    REGISTRY.counter("pt_train_steps_total", "optimizer steps logged").inc()
    REGISTRY.gauge("pt_train_loss", "loss at the last log boundary").set(
        m.loss)
    REGISTRY.gauge("pt_train_tokens_per_sec", "training throughput",
                   "tokens/s").set(m.tokens_per_sec)
    REGISTRY.gauge("pt_train_mfu", "model FLOPs utilization").set(m.mfu)
    REGISTRY.gauge("pt_train_lr", "learning rate").set(m.lr)
    REGISTRY.histogram("pt_train_step_seconds", "per-step wall time",
                       "s").observe(m.step_time_s)
