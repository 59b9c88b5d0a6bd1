"""Admission that can say no (copy of
``paddle_tpu/serving_fabric/robust.py``): typed rejections, jittered
backoff and the load-shedding ladder.

* **Typed rejections** — :class:`FabricRejected` subclasses carrying
  ``kind`` + ``retry_after_ms``. They subclass RuntimeError, so a caller
  that treats "every replica is down" as fatal keeps working, while a
  caller that branches on the type learns whether and when to retry:
  ``Overloaded``/``AllReplicasDown`` are retryable with a server-suggested
  delay, ``DeadlineExceeded`` is not.
* **Backoff** — full-jitter exponential delay:
  ``uniform(0, min(cap, base * 2^attempt))``, floored by any server
  ``retry_after`` hint.
* **LoadShedder** — the ladder the router consults at submit and each
  scheduling pass, on the global queue depth and the router-boundary
  TTFT/ITL p99: level 1 SHEDS the lowest-weight tenants (weights from
  :class:`~.fair.TenantFairPolicy`), level 2 BROWNS OUT (additionally
  defers cold prefills and caps replica ``spec_k``). Escalation needs
  ``breach_ticks`` consecutive bad passes and recovery ``recover_ticks``
  good ones — no flapping at the threshold.
"""

from __future__ import annotations

import random
from typing import Dict, Optional

from ..observability.metrics import REGISTRY as _REG

__all__ = ["FabricRejected", "Overloaded", "AllReplicasDown",
           "DeadlineExceeded", "Backoff", "LoadShedder"]


class FabricRejected(RuntimeError):
    """Base of every typed front-door refusal. ``retry_after_ms`` is
    the server's recovery estimate (None = caller's own policy)."""

    kind = "rejected"

    def __init__(self, msg: str, retry_after_ms: Optional[float] = None):
        super().__init__(msg)
        self.retry_after_ms = (None if retry_after_ms is None
                               else float(retry_after_ms))

    def to_wire(self) -> dict:
        out = {"kind": self.kind, "error": str(self)}
        if self.retry_after_ms is not None:
            out["retry_after_ms"] = self.retry_after_ms
        return out


class Overloaded(FabricRejected):
    """Admission said no: the shed ladder is active for this tenant (or
    the global queue hit its hard cap). Retry after the hint."""
    kind = "overloaded"


class AllReplicasDown(FabricRejected):
    """Every replica is dead. Retryable when the transport is probing
    (``retry_after_ms`` = the soonest half-open window); fatal-for-now
    otherwise."""
    kind = "all_down"


class DeadlineExceeded(FabricRejected):
    """The request's TTFT or total deadline passed; the fabric cancelled
    it and freed its slot/pages. Not retryable — the budget is spent."""
    kind = "deadline"


class Backoff:
    """Full-jitter exponential backoff: attempt ``n`` sleeps
    ``uniform(0, min(cap, base * 2^n))`` seconds, floored by any server
    retry_after hint. Deterministic under a seeded rng (tests)."""

    def __init__(self, base_s: float = 0.05, cap_s: float = 2.0,
                 rng: Optional[random.Random] = None):
        if base_s <= 0 or cap_s < base_s:
            raise ValueError(f"need 0 < base_s <= cap_s, got "
                             f"({base_s}, {cap_s})")
        self.base_s = float(base_s)
        self.cap_s = float(cap_s)
        self._rng = rng or random.Random()

    def delay_s(self, attempt: int,
                retry_after_ms: Optional[float] = None) -> float:
        hi = min(self.cap_s, self.base_s * (2.0 ** max(0, attempt)))
        d = self._rng.uniform(0.0, hi)
        if retry_after_ms is not None:
            d = max(d, retry_after_ms / 1000.0)
        return d


class LoadShedder:
    """See module doc. The router owns one and calls:

    * ``observe(queue_depth, lat)`` once per scheduling pass (``lat``
      is the router's ``latency_stats()`` dict, may be empty);
    * ``admit(tenant, weight, queue_depth)`` at submit — raises
      :class:`Overloaded` when the ladder sheds this tenant or the
      queue hit ``queue_cap``;
    * ``defer_cold(uncached_tokens)`` at dispatch — True while the
      brownout level defers this cold prefill.

    ``level`` is 0 (normal), 1 (shed), 2 (brownout). Tenants at the
    MAXIMUM weight seen are never shed by level 1; level 2 sheds every
    tenant below the max and defers cold prefills at or above
    ``cold_defer_tokens``. ``spec_k_cap`` is the brownout draft budget
    the router pushes to replicas via ``transport.configure``."""

    def __init__(self, queue_depth_hi: int = 32, queue_depth_lo: int = 8,
                 queue_cap: Optional[int] = 256,
                 ttft_p99_ceiling_s: Optional[float] = None,
                 itl_p99_ceiling_s: Optional[float] = None,
                 breach_ticks: int = 2, recover_ticks: int = 8,
                 cold_defer_tokens: int = 256, spec_k_cap: int = 1,
                 retry_after_ms: float = 250.0):
        if queue_depth_lo > queue_depth_hi:
            raise ValueError("need queue_depth_lo <= queue_depth_hi")
        self.queue_depth_hi = int(queue_depth_hi)
        self.queue_depth_lo = int(queue_depth_lo)
        self.queue_cap = None if queue_cap is None else int(queue_cap)
        self.ttft_p99_ceiling_s = ttft_p99_ceiling_s
        self.itl_p99_ceiling_s = itl_p99_ceiling_s
        self.breach_ticks = int(breach_ticks)
        self.recover_ticks = int(recover_ticks)
        self.cold_defer_tokens = int(cold_defer_tokens)
        self.spec_k_cap = int(spec_k_cap)
        self.retry_after_ms = float(retry_after_ms)
        self.level = 0
        self._bad = 0
        self._good = 0
        self._max_weight = 1.0
        self.shed: Dict[str, int] = {}      # tenant -> rejections
        self.transitions = 0

    # -- signals -------------------------------------------------------------

    def _breached(self, queue_depth: int, lat: dict) -> bool:
        if queue_depth >= self.queue_depth_hi:
            return True
        if self.ttft_p99_ceiling_s is not None:
            v = lat.get("ttft_p99_s")
            if v is not None and v > self.ttft_p99_ceiling_s:
                return True
        if self.itl_p99_ceiling_s is not None:
            v = lat.get("itl_p99_s")
            if v is not None and v > self.itl_p99_ceiling_s:
                return True
        return False

    def observe(self, queue_depth: int, lat: Optional[dict] = None
                ) -> int:
        """One scheduling pass: update the ladder, return the level."""
        if self._breached(queue_depth, lat or {}):
            self._bad += 1
            self._good = 0
            if self._bad >= self.breach_ticks and self.level < 2:
                self.level += 1
                self._bad = 0
                self.transitions += 1
        else:
            self._bad = 0
            if self.level and queue_depth <= self.queue_depth_lo:
                self._good += 1
                if self._good >= self.recover_ticks:
                    self.level -= 1
                    self._good = 0
                    self.transitions += 1
            else:
                self._good = 0
        if _REG.enabled:
            _REG.gauge("pt_frontdoor_shed_level",
                       "load-shedding ladder level (0=normal, 1=shed, "
                       "2=brownout)").set(self.level)
        return self.level

    # -- decisions -----------------------------------------------------------

    def admit(self, tenant: str, weight: float,
              queue_depth: int) -> None:
        """Raise :class:`Overloaded` when this submission must be shed;
        return silently otherwise."""
        self._max_weight = max(self._max_weight, float(weight))
        why = None
        if self.queue_cap is not None and queue_depth >= self.queue_cap:
            why = (f"global queue at hard cap ({self.queue_cap}); "
                   f"shedding all tenants")
        elif self.level >= 1 and float(weight) < self._max_weight:
            why = (f"shed level {self.level}: tenant {tenant!r} "
                   f"(weight {weight}) below the protected tier "
                   f"({self._max_weight})")
        if why is None:
            return
        self.shed[tenant] = self.shed.get(tenant, 0) + 1
        if _REG.enabled:
            _REG.counter("pt_frontdoor_shed_total",
                         "submissions rejected by the shed ladder").inc(
                tenant=tenant)
        raise Overloaded(why, retry_after_ms=self.retry_after_ms)

    def defer_cold(self, uncached_tokens: int) -> bool:
        """Brownout: True while a cold prefill this expensive should
        keep waiting in the global queue (running decodes keep their
        ITL; the queue's fairness machinery still orders the wait)."""
        return (self.level >= 2
                and uncached_tokens >= self.cold_defer_tokens)

    def stats(self) -> Dict[str, object]:
        return {"level": self.level, "transitions": self.transitions,
                "shed": dict(self.shed)}
