"""The port's metrics registry and request tracer (counterpart of
``paddle_tpu/observability``): the serving engine publishes its
``pt_serving_*`` series and replica spans here, the serving fabric its
``pt_fabric_*`` series and router spans. Both are off until enabled
(``REGISTRY.enable()``, ``TRACER.enable()``). Exporters, goodput, the
flight recorder, the SLO sentry and the cost observatory are not ported
(ROADMAP.md, A.6)."""

from .metrics import (REGISTRY, Counter, Gauge, Histogram,  # noqa: F401
                      MetricsRegistry, enabled, registry)
from .tracing import TRACER, Span, TraceContext, Tracer, tracer  # noqa: F401

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "registry",
           "REGISTRY", "enabled", "TRACER", "Tracer", "Span", "TraceContext",
           "tracer"]
