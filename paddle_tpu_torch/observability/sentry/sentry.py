"""SloSentry — pull-based rule evaluation + correlated incident capture
(copy of ``paddle_tpu/observability/sentry/sentry.py``).

The closing third of the observability loop: the metrics plane records,
the cost observatory attributes, the sentry *watches*.
``tick()`` is called from the boundaries the runtimes already cross
(``Trainer.fit`` log boundaries, ``ContinuousBatchingEngine`` drain
boundaries) — no threads, no timers, and ONE attr-load + branch when the
metrics plane is disabled (the registry's contract).

A tick snapshots the registry, resolves each rule's series, applies the
rule's predicate, and runs hysteresis/cooldown: a rule must breach
``breach_for`` consecutive windows to fire, and while the breach persists
it re-fires at most every ``cooldown_s`` — no incident storms. Firing
emits an :class:`Incident` that carries the *correlated* context a
post-mortem starts from: the rule's windowed stats, the
``pt_step_time_breakdown`` buckets and the goodput ledger totals at
breach time. Incidents are appended to a crash-safe JSONL (same
single-write + flush discipline as the metric exporter — at worst one
torn final line, which the tolerant loader skips), mirrored into
``pt_slo_incidents_total{rule=...}``, and can trigger a flight-recorder
dump through the existing ``profiler.set_flight_sink`` ring path.

Module-level ``install()`` makes one sentry the process sentry;
``maybe_tick()`` is the near-zero hook the trainer and serving engine
call (no sentry installed → a global load + branch).
"""

from __future__ import annotations

import json
import os
import threading
import time
import warnings
from collections import deque
from typing import Dict, List, Optional

from ..metrics import REGISTRY

__all__ = ["Incident", "SloSentry", "install", "uninstall", "active",
           "maybe_tick"]

_INCIDENT_RING = 256          # recent incidents kept on the sentry


class Incident:
    """One fired rule: what breached, by how much, and what the system
    looked like at that instant."""

    def __init__(self, rule, value, stats: dict, breach_windows: int,
                 context: dict, ts: float):
        self.ts = ts
        self.rule = rule.name
        self.kind = rule.kind
        self.metric = rule.metric
        self.labels = dict(rule.labels)
        self.severity = rule.severity
        self.description = rule.description
        self.value = value
        self.stats = stats
        self.breach_windows = breach_windows
        self.context = context

    def to_dict(self) -> dict:
        return {"ts": self.ts, "rule": self.rule, "kind": self.kind,
                "metric": self.metric, "labels": self.labels,
                "severity": self.severity,
                "description": self.description, "value": self.value,
                "stats": self.stats,
                "breach_windows": self.breach_windows,
                "context": self.context}

    def __repr__(self):
        return (f"Incident({self.rule!r}, severity={self.severity!r}, "
                f"value={self.value!r}, windows={self.breach_windows})")


# incident payloads must stay strict JSON — the flight recorder owns
# that contract, reuse its sanitizer (ONE definition)
from ..flight_recorder import _strict_json as _finite


class SloSentry:
    """Evaluate ``rules`` against registry snapshots on each tick.

    ``incident_log`` — JSONL path incidents append to (None = in-memory
    only). ``flight_dump`` — also trigger a flight-recorder dump per
    incident (a no-op unless the recorder is active). ``min_interval_s``
    — rate-limit full snapshot evaluation from hot tick sites (a serving
    engine ticking every scheduler pass must not pay a collect() each
    time); 0 evaluates every tick, which is what unit tests want.
    """

    def __init__(self, rules, incident_log: Optional[str] = None,
                 flight_dump: bool = False, min_interval_s: float = 0.0,
                 refresh_derived: bool = True):
        rules = list(rules)     # a generator must survive the name scan
        names = [r.name for r in rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate rule names: {sorted(names)}")
        self.rules = rules
        self.incident_log = incident_log
        self.flight_dump = bool(flight_dump)
        self.min_interval_s = float(min_interval_s)
        self.refresh_derived = bool(refresh_derived)
        self.incidents = deque(maxlen=_INCIDENT_RING)
        self.ticks = 0
        self._state: Dict[str, dict] = {r.name: {"streak": 0,
                                                 "last_fire": None}
                                        for r in self.rules}
        self._last_eval: Optional[float] = None
        self._lock = threading.Lock()

    # -- series resolution ---------------------------------------------------

    @staticmethod
    def _resolve(rule, by_name: Dict[str, List[dict]],
                 state: dict) -> Optional[float]:
        """Value of the rule's series in this snapshot, or None. Label
        subset match; exact label set preferred; non-numeric fields
        (histogram percentile absent on an empty series) read as
        missing — a rule never sees a stale zero.

        ``field="window_mean"`` derives the mean of a histogram's NEW
        observations since the previous tick (delta sum ÷ delta count,
        anchored in ``state``): the per-window statistic a spike rule
        needs — reservoir percentiles move only after a majority of a
        long horizon has already spiked."""
        entries = by_name.get(rule.metric)
        if not entries:
            return None
        want = rule.labels
        best = None
        for e in entries:
            lbs = e.get("labels", {})
            if all(lbs.get(k) == str(v) for k, v in want.items()):
                if {k: v for k, v in lbs.items()} == \
                        {str(k): str(v) for k, v in want.items()}:
                    best = e
                    break
                if best is None:
                    best = e
        if best is None:
            return None
        if rule.field == "window_mean":
            tot, cnt = best.get("sum"), best.get("count")
            if not isinstance(tot, (int, float)) \
                    or not isinstance(cnt, (int, float)):
                return None
            prev = state.get("_wm_prev")
            state["_wm_prev"] = (tot, cnt)
            if prev is None or cnt <= prev[1] or tot < prev[0]:
                # first sighting anchors; a count that went backwards is
                # a registry reset — re-anchor rather than divide noise
                return None
            return (tot - prev[0]) / (cnt - prev[1])
        v = best.get(rule.field)
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            return None
        return float(v)

    @staticmethod
    def _context(by_name: Dict[str, List[dict]]) -> dict:
        """The correlated capture every incident carries: breakdown
        buckets and the goodput ledger at breach time."""
        breakdown: Dict[str, dict] = {}
        for e in by_name.get("pt_step_time_breakdown", ()):
            lbs = e.get("labels", {})
            comp = lbs.get("component", "")
            breakdown.setdefault(comp, {})[lbs.get("bucket", "?")] = \
                e.get("value")
        try:
            from ..goodput import ledger
            goodput = ledger().totals()
        except Exception:
            goodput = {}
        drift = {e.get("labels", {}).get("component", "?"): e.get("value")
                 for e in by_name.get(
                     "pt_step_time_predicted_over_measured", ())}
        return {"step_time_breakdown": breakdown, "goodput": goodput,
                "predicted_over_measured": drift}

    # -- the tick ------------------------------------------------------------

    def tick(self, now: Optional[float] = None) -> List[Incident]:
        """Evaluate every rule once; returns the incidents fired by THIS
        tick. First line is the disabled-plane guard — parity with every
        other instrumented hot path."""
        if not REGISTRY.enabled:
            return []
        now = time.monotonic() if now is None else now
        with self._lock:
            if (self.min_interval_s > 0.0 and self._last_eval is not None
                    and now - self._last_eval < self.min_interval_s):
                return []
            self._last_eval = now
            self.ticks += 1
            if self.refresh_derived:
                # goodput gauges only land in the registry on publish();
                # refresh them so a floor rule sees the live fraction
                try:
                    from ..goodput import ledger
                    ledger().publish()
                except Exception:
                    pass
            by_name: Dict[str, List[dict]] = {}
            for e in REGISTRY.collect():
                by_name.setdefault(e["name"], []).append(e)
            fired: List[Incident] = []
            context = None
            for rule in self.rules:
                st = self._state[rule.name]
                try:
                    value = self._resolve(rule, by_name, st)
                    breached, stats = rule.check(value, st, now)
                except Exception as e:
                    # one faulty rule must not disable the sentry: skip
                    # it (warned once), keep evaluating the rest — the
                    # watcher can't be allowed to die silently
                    if not st.get("eval_warned"):
                        st["eval_warned"] = True
                        warnings.warn(
                            f"SloSentry: rule {rule.name!r} evaluation "
                            f"failed ({e!r}); rule skipped",
                            RuntimeWarning)
                    continue
                if not breached:
                    # a SKIPPED window (series missing / first delta
                    # anchor) is not a recovery: freezing the streak
                    # matters because this plane legitimately drops
                    # series (serving clears percentile gauges when the
                    # latency window empties) — bursty breaches must
                    # still accumulate to breach_for
                    if "skipped" not in stats:
                        st["streak"] = 0
                    continue
                st["streak"] += 1
                if st["streak"] < rule.breach_for:
                    continue
                last = st["last_fire"]
                if last is not None and now - last < rule.cooldown_s:
                    continue
                st["last_fire"] = now
                if context is None:        # one capture per tick
                    context = self._context(by_name)
                inc = Incident(rule, value, stats, st["streak"],
                               context, ts=time.time())
                self._attach_traces(inc)
                fired.append(inc)
            for inc in fired:
                self._record(inc)
        return fired

    # -- incident sinks ------------------------------------------------------

    @staticmethod
    def _attach_traces(inc: Incident) -> None:
        """Latency incidents carry their evidence: a TTFT or
        ITL breach attaches the K worst complete request traces so the
        post-mortem starts from the offending span trees, not just
        percentiles. The shared per-tick context capture is copied
        before mutation — other incidents this tick must not inherit
        the traces."""
        m = f"{inc.metric or ''} {inc.rule}"
        if "ttft" not in m and "itl" not in m:
            return
        try:
            from ..tracing import TRACER
            if not TRACER.enabled:
                return
            worst = TRACER.worst_traces(3)
        except Exception:
            return
        if worst:
            inc.context = dict(inc.context or {})
            inc.context["attached_traces"] = worst

    def _record(self, inc: Incident) -> None:
        self.incidents.append(inc)
        try:
            REGISTRY.counter(
                "pt_slo_incidents_total",
                "SLO incidents fired by the sentry").inc(rule=inc.rule)
        except Exception:
            pass
        if self.incident_log:
            try:
                d = os.path.dirname(os.path.abspath(self.incident_log))
                os.makedirs(d, exist_ok=True)
                line = json.dumps(_finite(inc.to_dict()), sort_keys=True,
                                  allow_nan=False)
                # one write + flush: at worst a torn final line, which
                # load_jsonl tolerates (the exporter's crash contract)
                with open(self.incident_log, "a", encoding="utf-8") as f:
                    f.write(line + "\n")
                    f.flush()
            except Exception as e:
                # a bad path must not lose incidents INVISIBLY — the
                # in-memory ring and counter still have them, but the
                # operator reading the (absent) file must be told once
                if not getattr(self, "_log_warned", False):
                    self._log_warned = True
                    warnings.warn(
                        f"SloSentry: cannot append incidents to "
                        f"{self.incident_log!r} ({e}); incidents stay "
                        f"in memory only", RuntimeWarning)
        if self.flight_dump:
            try:
                from ..flight_recorder import maybe_dump
                maybe_dump(f"slo_incident:{inc.rule}",
                           extra=_finite(inc.to_dict()))
            except Exception:
                pass

    # -- reporting -----------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {"ticks": self.ticks,
                    "incidents": len(self.incidents),
                    "rules": {r.name: {"streak":
                                       self._state[r.name]["streak"]}
                              for r in self.rules}}

    @staticmethod
    def load_incidents(path: str) -> List[dict]:
        """Tolerant incident-JSONL loader (delegates to the exporter's
        torn-tail-tolerant parser — ONE definition of that contract)."""
        from ..exporters import JSONLExporter
        return JSONLExporter.load_jsonl(path)


# ---------------------------------------------------------------------------
# process-wide hook
# ---------------------------------------------------------------------------

_ACTIVE: Optional[SloSentry] = None


def install(sentry: SloSentry) -> SloSentry:
    """Make ``sentry`` the process sentry ticked by the trainer / serving
    engine hooks. Replaces any previous one (a re-run setup cell must not
    stack duplicate watchers)."""
    global _ACTIVE
    _ACTIVE = sentry
    return sentry


def uninstall() -> None:
    global _ACTIVE
    _ACTIVE = None


def active() -> Optional[SloSentry]:
    return _ACTIVE


def maybe_tick() -> List[Incident]:
    """The hook instrumented boundaries call unconditionally: no sentry
    installed (the default) or plane disabled → a load + branch, nothing
    else. Evaluation failures never break the loop that hosts the tick."""
    s = _ACTIVE
    if s is None or not REGISTRY.enabled:
        return []
    try:
        return s.tick()
    except Exception as e:
        # last-resort catch so a systemic failure (collect() itself
        # raising) can't break the train/serve loop hosting the tick —
        # but the watcher must not die SILENTLY: warn once per sentry
        if not getattr(s, "_tick_warned", False):
            s._tick_warned = True
            warnings.warn(f"SloSentry: tick() failed ({e!r}); sentry "
                          f"evaluation is broken until fixed",
                          RuntimeWarning)
        return []
