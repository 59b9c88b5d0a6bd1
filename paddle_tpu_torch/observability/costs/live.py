"""Live cost gauges: the runtime half of the cost observatory
(counterpart of ``paddle_tpu/observability/costs/live.py``).

A :class:`CostWatch` pairs the cost report of ONE step (or decode block)
with measured wall times and publishes, through the metrics registry,
the JAX package's gauges with its arithmetic:

* ``pt_step_time_breakdown{component,bucket}`` — the measured per-step
  wall time split into compute / collective / exposed_comm / host /
  stall seconds. The buckets SUM TO the measured step time by
  construction: compute and comm are the analytical predictions, scaled
  down proportionally if they exceed what the wall clock allows, and
  stall is the unattributed residual.
* ``pt_model_flops_utilization{component}`` — attributed flops ÷
  (measured time × device peak).
* ``pt_hbm_bw_utilization{component}`` — attributed bytes ÷ (measured
  time × memory bandwidth).
* ``pt_step_time_predicted_over_measured{component}`` — the cost model
  watching itself (the planner's ``check_drift`` reads it).

What the watch observes: the JAX package analyses a compiled
executable's HLO; the port has none, so it takes a census of the step
itself (``analysis.collectives.StepCensus``: each aten op's flops and
bytes, each kernel's own counts, each collective's payload), priced by
:func:`analyzer.attribute_costs` and :func:`analyzer.price_census`.
There is no overlap analysis without HLO, so the comm share is all
"exposed_comm" and "collective" (comm hidden behind compute) is 0: the
JAX package's conservative default (exposed fraction 1.0, no async
windows), under which it never publishes ``pt_exposed_comm_fraction``.

A census runs once per step shape (``key``), on the step that first
runs with that shape while the registry is enabled, and adds the
dispatch mode's host cost to that one step; without the registry
nothing is recorded. Its wall seconds (the step's own work included)
count into ``pt_cost_census_seconds_total{component}`` and
``CostWatch.census_s``, so a latency seen around it can be told apart;
the publishers leave that step's time out of what they publish.
"""

from __future__ import annotations

import contextlib
import time
from typing import Hashable, Optional

from ..metrics import REGISTRY
from .analyzer import CostReport, attribute_costs, price_census
from .device_db import DeviceSpec, device_spec

__all__ = ["CostWatch"]


class CostWatch:
    """The cost report of one step shape at a time + gauge publisher."""

    def __init__(self, component: str,
                 spec: Optional[DeviceSpec] = None):
        self.component = component
        self.spec = spec or device_spec()
        self.report: Optional[CostReport] = None
        #: wall seconds spent under a census, and the censuses taken
        self.census_s: float = 0.0
        self.censuses: int = 0
        #: cost reports by step shape (bounded)
        self._reports: dict = {}

    # -- attachment ----------------------------------------------------------

    def observe(self, key: Hashable) -> bool:
        """Make ``key``'s report the current one; False when that shape
        has no census yet."""
        rep = self._reports.get(key)
        if rep is not None:
            self.report = rep
        return rep is not None

    @contextlib.contextmanager
    def census(self, key: Hashable, mesh=None):
        """Take the census of the work inside (one step of shape
        ``key``) and attach its report, its collectives classified over
        ``mesh`` (a ``HybridMesh``)."""
        from ...analysis.collectives import StepCensus
        t0 = time.perf_counter()
        with StepCensus() as c:
            yield c
        self.observe_census(c, mesh=mesh, key=key)
        dt = time.perf_counter() - t0
        self.census_s += dt
        self.censuses += 1
        if REGISTRY.enabled:
            REGISTRY.counter(
                "pt_cost_census_seconds_total",
                "wall seconds of the steps or decode blocks run under a "
                "cost census (their own work included)", "s").inc(
                dt, component=self.component)

    def observe_census(self, census, mesh=None,
                       key: Hashable = None) -> bool:
        """Price ``census`` (a ``StepCensus``) and make it the current
        report (kept under ``key``)."""
        from ...analysis.collectives import collective_census
        rep = attribute_costs(census, spec=self.spec)
        priced = price_census(collective_census(census, mesh=mesh),
                              spec=self.spec)
        rep.predicted_comm_s = priced["total_comm_s"]
        rep.predicted_step_s = rep.compute_s + rep.predicted_comm_s
        if len(self._reports) >= 8:
            self._reports.clear()
        self._reports[key] = rep
        self.report = rep
        return True

    @property
    def attached(self) -> bool:
        return self.report is not None

    # -- publication ---------------------------------------------------------

    def publish(self, measured_step_s: float, host_s: float = 0.0,
                steps_per_exec: int = 1) -> Optional[dict]:
        """Publish the gauges for one measured per-step time.

        ``steps_per_exec`` maps the observed work onto step units (a
        superstep's census covers its K steps), so a per-step measured
        time composes with a per-census flop count. Returns the
        published dict (None when unattached or disabled)."""
        r = self.report
        if r is None or not REGISTRY.enabled or measured_step_s <= 0:
            return None
        k = max(1, int(steps_per_exec))
        exec_s = measured_step_s * k
        mfu = r.total_flops / (exec_s * self.spec.peak_flops)
        hbm = r.total_bytes / (exec_s * self.spec.hbm_bw)
        ratio = r.predicted_step_s / exec_s

        # breakdown (per step): analytical compute/comm, scaled to fit
        # inside the measured wall time net of host overhead; residual is
        # the stall bucket. Buckets sum EXACTLY to measured_step_s.
        host = min(max(host_s, 0.0), measured_step_s)
        compute = r.predicted_compute_s / k
        comm = r.predicted_comm_s / k
        avail = measured_step_s - host
        attributed = compute + comm
        scale = min(1.0, avail / attributed) if attributed > 0 else 0.0
        compute *= scale
        comm *= scale
        stall = max(0.0, measured_step_s - host - compute - comm)

        lbl = {"component": self.component}
        g = REGISTRY.gauge(
            "pt_step_time_breakdown",
            "measured per-step wall time split into compute/collective/"
            "exposed_comm/host/stall (buckets sum to the measured step "
            "time; collective = comm hidden behind overlap-window "
            "compute, exposed_comm = the rest)", "s")
        g.set(compute, bucket="compute", **lbl)
        g.set(0.0, bucket="collective", **lbl)
        g.set(comm, bucket="exposed_comm", **lbl)
        g.set(host, bucket="host", **lbl)
        g.set(stall, bucket="stall", **lbl)
        REGISTRY.gauge(
            "pt_model_flops_utilization",
            "attributed flops / (measured time x device peak) — the "
            "census's analytical MFU").set(mfu, **lbl)
        REGISTRY.gauge(
            "pt_hbm_bw_utilization",
            "attributed bytes / (measured time x memory "
            "bandwidth)").set(hbm, **lbl)
        REGISTRY.gauge(
            "pt_step_time_predicted_over_measured",
            "roofline-predicted / measured step time — cost-model drift "
            "as a monitored signal").set(ratio, **lbl)
        return {"mfu": mfu, "hbm_bw_utilization": hbm,
                "predicted_over_measured": ratio,
                "exposed_comm_fraction": 1.0,
                "breakdown": {"compute": compute, "collective": 0.0,
                              "exposed_comm": comm,
                              "host": host, "stall": stall}}
