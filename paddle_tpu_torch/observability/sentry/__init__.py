"""paddle_tpu_torch.observability.sentry — declarative SLOs over the
metrics plane with correlated incident capture (counterpart of
``paddle_tpu/observability/sentry``).

Quickstart::

    from paddle_tpu_torch.observability import sentry as sn

    rules = sn.serving_rules() + sn.fabric_rules(replicas=["r0", "r1"])
    sn.install(sn.SloSentry(rules, incident_log="incidents.jsonl",
                            min_interval_s=1.0))
    fabric.run()              # the router and engines tick the sentry
    for inc in sn.active().incidents:
        print(inc.rule, inc.severity, inc.value)

The bench half of the JAX package's sentry (``baselines.py``:
``BenchDiff``, ``RATIO_METRICS``, with ``tools/bench_diff.py``) is not
here: it diffs the checked-in round files of a benchmark, and the port
has no benchmark file of its own yet (ROADMAP.md, A.6.5).
"""

from __future__ import annotations

from .rules import (EwmaSpike, RatioBand, SloRule, Staleness, Threshold,
                    default_rules, elastic_rules, fabric_rules,
                    frontdoor_rules, moe_rules, serving_rules,
                    tracing_rules, trainer_rules)
from .sentry import (Incident, SloSentry, active, install, maybe_tick,
                     uninstall)

__all__ = [
    "SloRule", "Threshold", "EwmaSpike", "RatioBand", "Staleness",
    "trainer_rules", "serving_rules", "fabric_rules", "frontdoor_rules",
    "elastic_rules", "tracing_rules", "moe_rules", "default_rules",
    "Incident", "SloSentry", "install", "uninstall", "active",
    "maybe_tick",
]
