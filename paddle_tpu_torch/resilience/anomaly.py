"""AnomalyGuard — NaN/Inf and loss-spike detection with bounded recovery
(copy of ``paddle_tpu/resilience/anomaly.py``).

A multi-day pretraining run hits two loss pathologies: *poison batches*
(one bad document → NaN loss → NaN grads → every parameter NaN within one
step) and *divergence* (loss blows up over tens of steps). The guard
watches the per-step loss against an EWMA band and maps each anomaly to a
policy:

* ``"skip"``     — undo this step's update and move past the batch
                   (transient poison batch);
* ``"rollback"`` — restore the last good checkpoint and replay
                   (state already corrupted, or skip unavailable);
* ``"abort"``    — raise :class:`DivergenceError` immediately.

Both recovery policies carry a **bounded budget** (``max_skips`` /
``max_rollbacks``): a persistent divergence exhausts it and the run fails
loudly instead of silently replaying the same collapse forever.

Detection is host-side and adds no device computation. How often it forces
a device→host sync of the loss is policy-dependent:

* ``policy="skip"`` fences EVERY step — undoing a poisoned update needs the
  pre-step references held from before the NEXT step runs, so the verdict
  must land before the next dispatch. That per-step fence is the price of
  checkpoint-free recovery, and the Trainer keeps it regardless of
  ``check_every``.
* ``policy="rollback"``/``"abort"`` can consume a batched **loss window**:
  set ``check_every=W`` and the Trainer stacks W device losses and performs
  ONE sync per window (and per superstep drain), keeping async dispatch
  overlap. Detection latency grows to ≤W steps, which rollback absorbs by
  construction — it restores the last good checkpoint either way.

Spike test: after ``warmup_steps`` accepted losses,
``loss > ewma + spike_factor * ewma_dev`` (EWMA of absolute deviation — a
cheap robust scale estimate) flags an anomaly; NaN/Inf flags
unconditionally, warmup included.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Optional

from ..observability import flight_recorder as _flight
from ..observability.metrics import REGISTRY as _REG

__all__ = ["AnomalyGuard", "DivergenceError",
           "OK", "SKIP", "ROLLBACK", "ABORT"]

OK = "ok"
SKIP = "skip"
ROLLBACK = "rollback"
ABORT = "abort"

_POLICIES = (SKIP, ROLLBACK, ABORT)


class DivergenceError(RuntimeError):
    """Loss anomaly with no recovery budget left (or policy='abort')."""


class AnomalyGuard:
    def __init__(self, policy: str = ROLLBACK, *, spike_factor: float = 6.0,
                 ewma_alpha: float = 0.05, warmup_steps: int = 20,
                 max_skips: int = 10, max_rollbacks: int = 3,
                 min_rel_dev: float = 1e-3, check_every: int = 1):
        if policy not in _POLICIES:
            raise ValueError(f"policy must be one of {_POLICIES}")
        self.policy = policy
        # loss-window size for batched verdicts (ignored — per-step — when
        # policy="skip"; see module docstring)
        self.check_every = max(1, int(check_every))
        self.min_rel_dev = float(min_rel_dev)
        self.spike_factor = float(spike_factor)
        self.ewma_alpha = float(ewma_alpha)
        self.warmup_steps = int(warmup_steps)
        self.max_skips = int(max_skips)
        self.max_rollbacks = int(max_rollbacks)
        self.skips = 0
        self.rollbacks = 0
        self.anomalies = 0
        self.last_reason: Optional[str] = None
        self._ewma: Optional[float] = None
        self._dev = 0.0
        self._seen = 0
        # the final loss window a flight-recorder dump ships for the
        # post-mortem: every CHECKED loss, anomalous or not, in order
        self.recent_losses = deque(maxlen=64)
        # counter handle resolved once (check() can run per STEP; the
        # registry name-lookup must not ride the training loop)
        self._verdict_counter = _REG.counter(
            "pt_anomaly_verdicts_total", "AnomalyGuard verdicts by outcome")

    # -- detection ----------------------------------------------------------

    def is_anomalous(self, loss: float) -> Optional[str]:
        """Reason string when ``loss`` is anomalous, else None (no state
        change)."""
        if not math.isfinite(loss):
            return "non-finite loss"
        if self._ewma is not None and self._seen >= self.warmup_steps:
            # relative floor on the deviation: after a long flat plateau
            # _dev decays toward 0 and an ABSOLUTE floor would flag benign
            # fp jitter as a spike, draining the recovery budget
            floor = max(self.min_rel_dev * abs(self._ewma), 1e-12)
            band = self.spike_factor * max(self._dev, floor)
            if loss > self._ewma + band:
                return (f"loss spike {loss:.4g} > ewma {self._ewma:.4g} "
                        f"+ {self.spike_factor}*dev {self._dev:.4g}")
        return None

    def record(self, loss: float) -> None:
        """Fold an ACCEPTED loss into the EWMA band."""
        a = self.ewma_alpha
        if self._ewma is None:
            self._ewma = float(loss)
        else:
            self._dev = (1 - a) * self._dev + a * abs(loss - self._ewma)
            self._ewma = (1 - a) * self._ewma + a * float(loss)
        self._seen += 1

    # -- decision -----------------------------------------------------------

    def check(self, loss: float) -> str:
        """One per-step verdict: OK (loss recorded), or SKIP / ROLLBACK /
        ABORT per policy and remaining budget."""
        self.recent_losses.append(float(loss))
        reason = self.is_anomalous(float(loss))
        if reason is None:
            self.record(float(loss))
            self.last_reason = None
            return self._verdict(OK)
        self.anomalies += 1
        self.last_reason = reason
        if self.policy == ABORT:
            return self._verdict(ABORT)
        if self.policy == SKIP:
            self.skips += 1
            return self._verdict(
                SKIP if self.skips <= self.max_skips else ABORT)
        self.rollbacks += 1
        return self._verdict(
            ROLLBACK if self.rollbacks <= self.max_rollbacks else ABORT)

    def _verdict(self, verdict: str) -> str:
        if _REG.enabled:
            self._verdict_counter.inc(verdict=verdict)
        return verdict

    def raise_divergence(self, step: int, loss: float) -> None:
        # ship the post-mortem before dying: the flight dump carries the
        # final loss window + the last trainer/serving spans (no-op when
        # the recorder is not active)
        _flight.maybe_dump("anomaly_abort", extra={
            "step": int(step), "loss": float(loss),
            "reason": self.last_reason,
            "loss_window": list(self.recent_losses),
            "skips": self.skips, "rollbacks": self.rollbacks,
        })
        raise DivergenceError(
            f"loss anomaly at step {step} ({self.last_reason or loss}) with "
            f"recovery budget exhausted (skips={self.skips}/{self.max_skips},"
            f" rollbacks={self.rollbacks}/{self.max_rollbacks})")

    @property
    def ewma(self) -> Optional[float]:
        return self._ewma
