"""Declarative SLO rule vocabulary evaluated over metrics snapshots
(copy of ``paddle_tpu/observability/sentry/rules.py``).

A rule names ONE series in the ``MetricsRegistry.collect()`` snapshot
(metric name + a label subset + a field — ``value`` for counters/gauges,
``p50``/``p99``/``count``/``sum`` for histograms) and a breach predicate
over its windowed value. The vocabulary is deliberately small — the same
four shapes the reference stack's fleet monitors reduce to:

* :class:`Threshold` — ceiling and/or floor on the value (or, with
  ``delta=True``, on the per-window change — the rate form a monotonic
  counter like ``pt_serving_pool_dry_drains_total`` needs);
* :class:`EwmaSpike` — value exceeds ``spike_ratio`` x its own EWMA
  (after a warmup), the step-time-jumped-3x detector;
* :class:`RatioBand` — value ÷ a pinned baseline falls outside
  ``[low, high]`` — the bench-variance policy's ratio-not-absolute
  discipline as a live rule (and the drift band the sharding planner
  reads to know its cost tables are stale);
* :class:`Staleness` — the series is absent from the snapshot (or, with
  ``require_change=True``, present but frozen) — the watcher's watcher:
  a plane that silently stopped publishing looks healthy to every other
  rule kind.

Rules carry their own *hysteresis* (``breach_for`` consecutive breached
windows before an incident) and *cooldown* (``cooldown_s`` between
incidents while the breach persists) — both enforced by the sentry core,
so every rule kind shares one tested implementation. A rule whose series
is missing is SKIPPED, not breached (except Staleness, whose whole job is
absence): a serving pack applied to a train-only process must stay quiet.

Evaluation is pure bookkeeping over plain floats — no device work, no
threads; per-rule mutable state lives in the dict the sentry owns, so a
rule object itself is immutable and shareable.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

__all__ = ["SloRule", "Threshold", "EwmaSpike", "RatioBand", "Staleness",
           "trainer_rules", "serving_rules", "fabric_rules",
           "frontdoor_rules", "elastic_rules", "tracing_rules",
           "moe_rules", "default_rules"]


class SloRule:
    """Base: identity + series selector + hysteresis/cooldown knobs.

    ``labels`` is a SUBSET match against a series' label set (``{}``
    matches any); when several series match, the exact label set wins,
    else the first in snapshot order. ``field`` picks the snapshot entry
    key to read (histogram entries expose p50/p99/count/sum), plus the
    derived ``window_mean`` — mean of a histogram's new observations
    since the previous tick, the right input for a spike rule (reservoir
    percentiles lag a transient by half the reservoir).
    """

    kind = "rule"

    def __init__(self, name: str, metric: str,
                 labels: Optional[Dict[str, str]] = None,
                 field: str = "value", severity: str = "warning",
                 breach_for: int = 1, cooldown_s: float = 60.0,
                 description: str = ""):
        if breach_for < 1:
            raise ValueError(f"rule {name!r}: breach_for must be >= 1")
        if severity not in ("info", "warning", "critical"):
            raise ValueError(f"rule {name!r}: unknown severity "
                             f"{severity!r}")
        self.name = name
        self.metric = metric
        self.labels = dict(labels or {})
        self.field = field
        self.severity = severity
        self.breach_for = int(breach_for)
        self.cooldown_s = float(cooldown_s)
        self.description = description

    def check(self, value: Optional[float], state: dict,
              now: float) -> Tuple[bool, dict]:
        """One evaluation window: ``value`` is the resolved series value
        (None = series missing). Returns ``(breached, stats)``; ``stats``
        rides into the incident so the post-mortem carries the rule's
        windowed view, not just "it fired"."""
        raise NotImplementedError

    def __repr__(self):
        return (f"{type(self).__name__}({self.name!r}, "
                f"metric={self.metric!r})")


class Threshold(SloRule):
    """Ceiling and/or floor on the value; ``delta=True`` evaluates the
    per-window change instead (first window establishes the anchor and
    never breaches)."""

    kind = "threshold"

    def __init__(self, name: str, metric: str, ceiling: float = None,
                 floor: float = None, delta: bool = False, **kw):
        super().__init__(name, metric, **kw)
        if ceiling is None and floor is None:
            raise ValueError(f"rule {name!r}: need a ceiling or a floor")
        self.ceiling = None if ceiling is None else float(ceiling)
        self.floor = None if floor is None else float(floor)
        self.delta = bool(delta)

    def check(self, value, state, now):
        if value is None:
            return False, {"skipped": "series missing"}
        if self.delta:
            prev = state.get("prev")
            state["prev"] = value
            if prev is None:
                return False, {"skipped": "first window (delta anchor)"}
            value = value - prev
        stats = {"value": value, "ceiling": self.ceiling,
                 "floor": self.floor, "delta": self.delta}
        breached = ((self.ceiling is not None and value > self.ceiling)
                    or (self.floor is not None and value < self.floor))
        return breached, stats


class EwmaSpike(SloRule):
    """Value exceeds ``spike_ratio`` x its own exponentially-weighted
    moving average. The EWMA warms up for ``warmup`` windows before the
    rule can breach. While a breach streak is still short of
    ``breach_for`` the EWMA is FROZEN — each consecutive spiked window
    is judged against the pre-spike average, otherwise the first
    breached sample inflates the baseline and ``breach_for >= 2`` could
    only ever fire on a spike that out-spiked its own absorption
    (~spike_ratio² for the shipped defaults — a dead detector).
    Once the streak reaches ``breach_for`` (the window the sentry
    fires) absorption resumes, so a persistent level shift still
    becomes the new normal and stops re-breaching after one incident —
    the spike-vs-new-normal distinction this kind encodes (a permanent
    shift belongs to Threshold/RatioBand)."""

    kind = "ewma_spike"

    def __init__(self, name: str, metric: str, spike_ratio: float = 2.0,
                 alpha: float = 0.3, warmup: int = 3, **kw):
        super().__init__(name, metric, **kw)
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"rule {name!r}: alpha must be in (0, 1]")
        if spike_ratio <= 1.0:
            raise ValueError(f"rule {name!r}: spike_ratio must be > 1")
        self.spike_ratio = float(spike_ratio)
        self.alpha = float(alpha)
        self.warmup = int(warmup)

    def check(self, value, state, now):
        if value is None:
            return False, {"skipped": "series missing"}
        ewma = state.get("ewma")
        n = state.get("ewma_n", 0)
        breached = False
        stats = {"value": value, "ewma": ewma,
                 "spike_ratio": self.spike_ratio, "windows_seen": n}
        if ewma is not None and n >= self.warmup:
            breached = value > self.spike_ratio * ewma
        # state["streak"] is the sentry's count BEFORE this window
        if not breached or state.get("streak", 0) + 1 >= self.breach_for:
            state["ewma"] = (value if ewma is None
                             else ewma + self.alpha * (value - ewma))
        state["ewma_n"] = n + 1
        return breached, stats


class RatioBand(SloRule):
    """``value ÷ baseline`` outside ``[low, high]`` breaches. The
    baseline is PINNED at rule-construction time (a bench artifact, a
    design constant like 1.0 for a self-ratio such as
    ``pt_step_time_predicted_over_measured``) — the rule never learns,
    so it cannot normalize a slow drift away."""

    kind = "ratio_band"

    def __init__(self, name: str, metric: str, baseline: float,
                 low: float = 0.75, high: float = 1.25, **kw):
        super().__init__(name, metric, **kw)
        if baseline <= 0:
            raise ValueError(f"rule {name!r}: baseline must be positive")
        if not low < high:
            raise ValueError(f"rule {name!r}: need low < high")
        self.baseline = float(baseline)
        self.low = float(low)
        self.high = float(high)

    def check(self, value, state, now):
        if value is None:
            return False, {"skipped": "series missing"}
        ratio = value / self.baseline
        stats = {"value": value, "baseline": self.baseline,
                 "ratio": ratio, "low": self.low, "high": self.high}
        return (ratio < self.low or ratio > self.high), stats


class Staleness(SloRule):
    """Breaches when the series is ABSENT from the snapshot — or, with
    ``require_change=True``, present but bit-identical to the previous
    window (a counter that should be moving, a percentile gauge a dead
    publisher left behind). Combine with ``breach_for`` for the number
    of quiet windows tolerated."""

    kind = "staleness"

    def __init__(self, name: str, metric: str,
                 require_change: bool = False, **kw):
        super().__init__(name, metric, **kw)
        self.require_change = bool(require_change)

    def check(self, value, state, now):
        prev = state.get("prev")
        state["prev"] = value
        if value is None:
            return True, {"value": None, "reason": "series missing"}
        if self.require_change and prev is not None and value == prev:
            return True, {"value": value, "reason": "series frozen"}
        return False, {"value": value}


# ---------------------------------------------------------------------------
# default rule packs
# ---------------------------------------------------------------------------

def trainer_rules(goodput_floor: float = 0.5,
                  drift_band: Tuple[float, float] = (0.33, 3.0),
                  step_spike_ratio: float = 3.0,
                  exposed_comm_ceiling: float = 0.6,
                  breach_for: int = 3,
                  cooldown_s: float = 300.0) -> List[SloRule]:
    """The training-loop pack: watches the goodput ledger and the
    cost-model drift at the log boundaries ``Trainer.fit`` already
    crosses. Defaults are deliberately loose — a pack must be quiet on a
    healthy run and demand ``breach_for`` consecutive bad windows, not
    page on one noisy boundary."""
    return [
        Threshold(
            "goodput_floor", "pt_goodput_fraction", floor=goodput_floor,
            severity="warning", breach_for=breach_for,
            cooldown_s=cooldown_s,
            description="productive wall-time fraction collapsed: the "
                        "run is mostly compiling/checkpointing/replaying"),
        RatioBand(
            "step_time_predicted_drift",
            "pt_step_time_predicted_over_measured",
            labels={"component": "train"}, baseline=1.0,
            low=drift_band[0], high=drift_band[1],
            severity="warning", breach_for=breach_for,
            cooldown_s=cooldown_s,
            description="cost-model drift: the roofline prediction and "
                        "the measured step time disagree past the band "
                        "— recalibrate OpCostDB before trusting a plan"),
        EwmaSpike(
            "step_time_spike", "pt_train_step_seconds",
            field="window_mean",
            spike_ratio=step_spike_ratio, alpha=0.3, warmup=3,
            severity="critical", breach_for=2, cooldown_s=cooldown_s,
            description="per-step wall time spiked vs its own EWMA: "
                        "input stall, thermal/contention event, or a "
                        "recompile storm"),
        RatioBand(
            "exposed_comm", "pt_exposed_comm_fraction",
            labels={"component": "train"}, baseline=1.0,
            low=0.0, high=exposed_comm_ceiling,
            severity="warning", breach_for=breach_for,
            cooldown_s=cooldown_s,
            description="exposed (un-overlapped) comm fraction over the "
                        "band: start->done windows collapsed — a flag "
                        "flip, libtpu downgrade, or a schedule "
                        "regression serialized the collective lane. The "
                        "gauge only exists on executables with async "
                        "windows, so sync-lowered (CPU) runs skip"),
    ]


def serving_rules(itl_p99_ceiling_s: float = 0.25,
                  ttft_p99_ceiling_s: float = 2.0,
                  prefix_hit_floor: float = 0.2,
                  spec_accept_floor: float = 0.2,
                  pool_dry_ceiling_per_window: float = 8.0,
                  breach_for: int = 3,
                  cooldown_s: float = 300.0) -> List[SloRule]:
    """The serving pack over the engine's published gauges. The hit-rate
    and accept-rate floors only engage on engines that publish those
    series (prefix_cache / spec_k enabled) — missing series skip."""
    return [
        Threshold(
            "itl_p99_ceiling", "pt_serving_itl_seconds",
            labels={"q": "p99"}, ceiling=itl_p99_ceiling_s,
            severity="critical", breach_for=breach_for,
            cooldown_s=cooldown_s,
            description="inter-token latency p99 over target: running "
                        "decodes are stalling behind prefills or "
                        "preemptions"),
        Threshold(
            "ttft_p99_ceiling", "pt_serving_ttft_seconds",
            labels={"q": "p99"}, ceiling=ttft_p99_ceiling_s,
            severity="critical", breach_for=breach_for,
            cooldown_s=cooldown_s,
            description="time-to-first-token p99 over target: admission "
                        "queue is backing up"),
        Threshold(
            "prefix_hit_rate_floor", "pt_serving_prefix_hit_rate",
            floor=prefix_hit_floor, severity="warning",
            breach_for=breach_for, cooldown_s=cooldown_s,
            description="radix-cache hit rate collapsed: workload "
                        "stopped sharing prefixes or the tree is being "
                        "evicted under pool pressure"),
        Threshold(
            "spec_accept_rate_floor", "pt_spec_accept_rate",
            floor=spec_accept_floor, severity="warning",
            breach_for=breach_for, cooldown_s=cooldown_s,
            description="speculative accept rate collapsed: the draft "
                        "provider no longer predicts this workload"),
        Threshold(
            "pool_dry_drain_rate", "pt_serving_pool_dry_drains_total",
            ceiling=pool_dry_ceiling_per_window, delta=True,
            severity="warning", breach_for=breach_for,
            cooldown_s=cooldown_s,
            description="KV pool running dry every window: capacity "
                        "pressure — shrink admission or grow num_pages"),
    ]


def fabric_rules(replicas: Optional[List[str]] = None,
                 ttft_p99_ceiling_s: float = 2.0,
                 itl_p99_ceiling_s: float = 0.25,
                 replica_itl_p99_ceiling_s: Optional[float] = None,
                 prefix_hit_floor: float = 0.2,
                 replicas_alive_floor: Optional[float] = None,
                 handoff_failures_per_window: float = 2.0,
                 breach_for: int = 3,
                 cooldown_s: float = 300.0) -> List[SloRule]:
    """The serving-fabric pack: AGGREGATE p99 TTFT/ITL
    ceilings at the router boundary, a replica-death floor on the
    heartbeat gauge, a per-window handoff-failure ceiling, and — when
    ``replicas`` names the pool — a per-replica prefix-hit-rate floor
    and ITL ceiling over the engine series' ``engine=<name>`` label
    sets. Per-replica rules skip while that replica publishes nothing
    (the serving pack's missing-series contract), so one pack serves
    any pool size.

    ``replicas_alive_floor`` defaults to ``len(replicas)`` when the
    pool is named (any death pages after ``breach_for`` windows) and
    stays off otherwise. ``replica_itl_p99_ceiling_s`` defaults to the
    aggregate ceiling."""
    rules: List[SloRule] = [
        Threshold(
            "fabric_ttft_p99_ceiling", "pt_fabric_ttft_seconds",
            labels={"q": "p99"}, ceiling=ttft_p99_ceiling_s,
            severity="critical", breach_for=breach_for,
            cooldown_s=cooldown_s,
            description="fabric-aggregate time-to-first-token p99 over "
                        "target: the global queue is backing up or "
                        "routing is concentrating load"),
        Threshold(
            "fabric_itl_p99_ceiling", "pt_fabric_itl_seconds",
            labels={"q": "p99"}, ceiling=itl_p99_ceiling_s,
            severity="critical", breach_for=breach_for,
            cooldown_s=cooldown_s,
            description="fabric-aggregate inter-token latency p99 over "
                        "target: decode replicas are stalling (cold "
                        "long prefills landing on them? disaggregate)"),
        Threshold(
            "fabric_handoff_failure_rate",
            "pt_fabric_handoff_failures_total",
            ceiling=handoff_failures_per_window, delta=True,
            severity="warning", breach_for=breach_for,
            cooldown_s=cooldown_s,
            description="prefill→decode handoffs failing every window: "
                        "transfers are corrupt, pools too small to "
                        "adopt, or a transport is flapping — requests "
                        "are falling back to cold serving"),
    ]
    if replicas:
        if replicas_alive_floor is None:
            replicas_alive_floor = float(len(replicas))
        per_itl = (replica_itl_p99_ceiling_s
                   if replica_itl_p99_ceiling_s is not None
                   else itl_p99_ceiling_s)
        for r in replicas:
            rules.append(Threshold(
                f"fabric_replica_{r}_prefix_hit_floor",
                "pt_serving_prefix_hit_rate",
                labels={"engine": r}, floor=prefix_hit_floor,
                severity="warning", breach_for=breach_for,
                cooldown_s=cooldown_s,
                description=f"replica {r}: radix hit rate collapsed — "
                            f"affinity routing stopped landing its "
                            f"prefix traffic here, or its tree is "
                            f"being evicted under pool pressure"))
            rules.append(Threshold(
                f"fabric_replica_{r}_itl_p99_ceiling",
                "pt_serving_itl_seconds",
                labels={"engine": r, "q": "p99"}, ceiling=per_itl,
                severity="critical", breach_for=breach_for,
                cooldown_s=cooldown_s,
                description=f"replica {r}: decode ITL p99 over its "
                            f"ceiling — the router's hysteresis should "
                            f"be spilling affinity traffic off it"))
    if replicas_alive_floor is not None:
        rules.append(Threshold(
            "fabric_replicas_alive_floor", "pt_fabric_replicas_alive",
            floor=replicas_alive_floor, severity="critical",
            breach_for=1, cooldown_s=cooldown_s,
            description="router lost contact with at least one "
                        "replica: failover re-admission is running, "
                        "capacity is reduced"))
    return rules


def frontdoor_rules(replicas: Optional[List[str]] = None,
                    ttft_p99_ceiling_s: float = 2.0,
                    shed_level_ceiling: float = 1.5,
                    deadline_misses_per_window: float = 5.0,
                    slow_disconnects_per_window: float = 3.0,
                    retries_per_window: float = 10.0,
                    breaker_trips_per_window: float = 0.0,
                    breach_for: int = 3,
                    cooldown_s: float = 300.0) -> List[SloRule]:
    """The front-door robustness pack, watching the edge the
    typed-refusal contract promises clients:

    * admitted-request p99 TTFT at the router boundary stays under
      ``ttft_p99_ceiling_s`` — the ceiling the load-test smoke leg
      asserts under 2x offered load WITH shedding (if this fires, the
      ladder is admitting more than the pool can serve on time);
    * the shed ladder living at BROWNOUT (level 2) for ``breach_for``
      windows — shedding is the mechanism, sustained brownout is the
      capacity signal;
    * deadline misses / slow-loris evictions / dedupe-resumed retries
      per window — each a typed, bounded event individually, a storm
      collectively (deadlines too tight, a stalled client fleet, or a
      flapping connection path);
    * per-replica breaker trips (when ``replicas`` names the pool):
      ANY trip pages — a replica that hung or died took a failover,
      capacity is reduced until its half-open probe readmits it.

    Missing series skip (same contract as every pack): a fabric without
    deadlines or a breaker stays quiet on those rules."""
    rules: List[SloRule] = [
        Threshold(
            "frontdoor_ttft_p99_ceiling", "pt_fabric_ttft_seconds",
            labels={"q": "p99"}, ceiling=ttft_p99_ceiling_s,
            severity="critical", breach_for=breach_for,
            cooldown_s=cooldown_s,
            description="admitted-request p99 TTFT over the front-door "
                        "ceiling: the shed ladder is admitting more "
                        "than the pool serves on time — raise shed "
                        "thresholds' aggression or grow the pool"),
        Threshold(
            "frontdoor_shed_brownout", "pt_frontdoor_shed_level",
            ceiling=shed_level_ceiling, severity="warning",
            breach_for=breach_for, cooldown_s=cooldown_s,
            description="the load-shedding ladder is living at "
                        "brownout: cold prefills deferred and spec_k "
                        "capped every window — this is a capacity "
                        "signal, not weather; add replicas"),
        Threshold(
            "frontdoor_slow_client_disconnects",
            "pt_frontdoor_disconnects_total",
            labels={"reason": "slow"},
            ceiling=slow_disconnects_per_window, delta=True,
            severity="warning", breach_for=breach_for,
            cooldown_s=cooldown_s,
            description="slow-loris evictions every window: a client "
                        "fleet stopped reading its streams (or the "
                        "outbox bound is too tight for their RTT)"),
        Threshold(
            "frontdoor_retry_rate", "pt_frontdoor_retries_total",
            ceiling=retries_per_window, delta=True,
            severity="warning", breach_for=breach_for,
            cooldown_s=cooldown_s,
            description="dedupe-resumed retries every window: clients "
                        "are reconnecting in bulk — a flapping network "
                        "path or a front door restarting under them"),
    ]
    for kind in ("ttft", "total"):
        rules.append(Threshold(
            f"frontdoor_deadline_miss_rate_{kind}",
            "pt_frontdoor_deadline_miss_total",
            labels={"kind": kind},
            ceiling=deadline_misses_per_window, delta=True,
            severity="warning", breach_for=breach_for,
            cooldown_s=cooldown_s,
            description=f"{kind}-deadline cancellations every window: "
                        f"budgets too tight for current load, or "
                        f"capacity quietly shrank (check the breaker "
                        f"and replicas-alive rules)"))
    for r in (replicas or ()):
        rules.append(Threshold(
            f"frontdoor_breaker_{r}_trips",
            "pt_frontdoor_breaker_open_total",
            labels={"replica": r},
            ceiling=breaker_trips_per_window, delta=True,
            severity="critical", breach_for=1, cooldown_s=cooldown_s,
            description=f"replica {r}: circuit breaker opened (hung or "
                        f"crashed) — failover re-admission ran, "
                        f"capacity reduced until its half-open probe "
                        f"readmits it"))
    return rules


def elastic_rules(membership_changes_per_window: float = 2.0,
                  reshard_failures_per_window: float = 0.0,
                  world_size_floor: Optional[float] = None,
                  breach_for: int = 1,
                  cooldown_s: float = 300.0) -> List[SloRule]:
    """Alert pack for the elastic scale-in/out flow.

    A single membership change is the normal weather of preemptible
    pods — the flow exists to absorb it. What pages is the PATTERN:
    membership flapping faster than re-planning can converge (the run
    spends its life resharding, not training), or any resharded restore
    FAILING (the one mechanism that turns a lost host into a resumed
    run is broken — the next preemption is unrecoverable)."""
    rules: List[SloRule] = [
        Threshold(
            "elastic_membership_change_rate",
            "pt_elastic_membership_changes_total",
            ceiling=membership_changes_per_window, delta=True,
            severity="warning", breach_for=breach_for,
            cooldown_s=cooldown_s,
            description="world size flapping every window: the pod is "
                        "churning hosts faster than replan+reshard can "
                        "converge — training throughput is going to "
                        "replay and recompilation, not steps"),
        Threshold(
            "elastic_reshard_failures",
            "pt_elastic_reshard_failures_total",
            ceiling=reshard_failures_per_window, delta=True,
            severity="critical", breach_for=1,
            cooldown_s=cooldown_s,
            description="a resharded restore failed this window: the "
                        "checkpoint cannot be loaded on the surviving "
                        "mesh (infeasible axis or corrupt shard) — the "
                        "run is one preemption away from dead; pick a "
                        "feasible config or fall back to a committed "
                        "step that reshapes cleanly"),
    ]
    if world_size_floor is not None:
        rules.append(Threshold(
            "elastic_world_size_floor", "pt_elastic_world_size",
            floor=float(world_size_floor), severity="critical",
            breach_for=1, cooldown_s=cooldown_s,
            description="surviving world size fell below the minimum "
                        "the job can make progress on — scale the pod "
                        "back up or lower the floor deliberately"))
    return rules


def tracing_rules(queue_frac_ceiling: float = 0.5,
                  untracked_frac_ceiling: float = 0.1,
                  breach_for: int = 3,
                  cooldown_s: float = 300.0) -> List[SloRule]:
    """The distributed-tracing pack, breaching on
    ATTRIBUTION SHIFTS rather than totals: the tracer publishes
    ``pt_trace_ttft_frac{hop=...}`` gauges per completed trace, and a
    TTFT whose queue share climbs past the ceiling names the culprit
    (admission backlog) before the aggregate p99 ceiling even moves.
    The untracked ceiling is the instrumentation's own watchdog — a
    residual past it means a hop lost its spans (the ≥95% attribution
    contract the acceptance bound pins). Both series only exist while
    tracing is enabled, so the pack is silent otherwise (the
    missing-series skip contract)."""
    return [
        Threshold(
            "trace_ttft_frac_queue", "pt_trace_ttft_frac",
            labels={"hop": "queue"}, ceiling=queue_frac_ceiling,
            severity="warning", breach_for=breach_for,
            cooldown_s=cooldown_s,
            description="router-queue share of TTFT over the ceiling: "
                        "requests spend their first-token budget "
                        "waiting for dispatch — fair-admission backlog "
                        "or no replica capacity; the attached traces "
                        "name the hop"),
        Threshold(
            "trace_ttft_frac_untracked", "pt_trace_ttft_frac",
            labels={"hop": "untracked"},
            ceiling=untracked_frac_ceiling,
            severity="warning", breach_for=breach_for,
            cooldown_s=cooldown_s,
            description="untracked TTFT residual over the ceiling: a "
                        "latency-owning hop is missing its spans "
                        "(instrumentation regression) or a new hop "
                        "appeared between instrumented ones"),
    ]


def moe_rules(imbalance_ceiling: float = 2.0,
              aux_loss_floor: float = 0.5,
              router_z_spike_ratio: float = 3.0,
              exposed_comm_ceiling: float = 0.6,
              breach_for: int = 3,
              cooldown_s: float = 300.0) -> List[SloRule]:
    """The expert-parallel MoE pack, watching the routing
    health series ``publish_moe_metrics`` exports and the overlap gauge
    the a2a lane shares with every other collective:

    * ``pt_moe_load_imbalance`` is ``e × max expert share`` — exactly
      the bottleneck statistic the planner's entropy-priced a2a divides
      ep bandwidth by. Sustained past the ceiling means a hot expert is
      serializing dispatch AND the plan was priced for a balance the
      run no longer has — re-plan with the live histogram;
    * the aux-loss floor is the estimator's own watchdog: the GShard
      aux sits near 1.0 when balanced and RISES under skew, so a value
      collapsing toward 0 means the me/ce inputs got misaligned
      (a routing-pipeline regression), not a healthy router;
    * a router-z spike vs its own EWMA — router logits blowing up
      precedes routing collapse by many steps;
    * exposed-comm over the band while the MoE series are live: the
      dispatch/combine all-to-all stopped overlapping (a schedule or
      flag regression on the ep lane).

    Every series skips when missing (dense models, eval-only runs), so
    the pack composes with ``trainer_rules`` without double-paging."""
    return [
        Threshold(
            "moe_load_imbalance_ceiling", "pt_moe_load_imbalance",
            ceiling=imbalance_ceiling, severity="warning",
            breach_for=breach_for, cooldown_s=cooldown_s,
            description="e x max expert share over the ceiling: a hot "
                        "expert is the a2a bottleneck — the entropy "
                        "pricing divisor the plan assumed no longer "
                        "holds; re-plan with the live histogram or "
                        "raise the aux-loss weight"),
        Threshold(
            "moe_aux_loss_floor", "pt_moe_aux_loss",
            floor=aux_loss_floor, severity="warning",
            breach_for=breach_for, cooldown_s=cooldown_s,
            description="GShard aux loss collapsed toward 0: the "
                        "estimator's me/ce inputs are misaligned "
                        "(routing-pipeline regression) — balanced "
                        "routing reads ~1.0, never ~0"),
        EwmaSpike(
            "moe_router_z_spike", "pt_moe_router_z",
            spike_ratio=router_z_spike_ratio, alpha=0.3, warmup=3,
            severity="warning", breach_for=2, cooldown_s=cooldown_s,
            description="router z-loss spiked vs its own EWMA: gate "
                        "logits are blowing up — routing collapse "
                        "follows; check lr/init on the gate"),
        RatioBand(
            "moe_exposed_a2a", "pt_exposed_comm_fraction",
            labels={"component": "train"}, baseline=1.0,
            low=0.0, high=exposed_comm_ceiling,
            severity="warning", breach_for=breach_for,
            cooldown_s=cooldown_s,
            description="exposed comm over the band on an MoE run: the "
                        "dispatch/combine all-to-all stopped "
                        "overlapping with expert compute (flag flip or "
                        "schedule regression on the ep lane)"),
    ]


def default_rules() -> List[SloRule]:
    """trainer + serving packs at their defaults. Takes NO kwargs on
    purpose: callers wanting tuned thresholds compose
    ``trainer_rules(...) + serving_rules(...)`` directly — silently
    ignoring a misplaced threshold kwarg would watch the wrong SLO."""
    return trainer_rules() + serving_rules()
