"""Per-tenant weighted fair admission at the router (copy of
``paddle_tpu/serving_fabric/fair.py``).

The router-level generalization of ``inference.admission`` (whose
``SLOAdmissionPolicy`` stays the per-replica LEAF of the policy tree:
this module decides WHICH tenant's request leaves the global queue,
each replica's policy still decides when its engine takes it). Three
mechanisms, all priced in admitted UNCACHED-SUFFIX tokens, i.e. prefill
work the fabric will actually buy:

* **Weighted fairness** (start-time fair queuing): each tenant carries
  a virtual finish time advanced by ``admitted_cost / weight`` on every
  admission; the eligible request of the LOWEST-vtime tenant goes
  first, so long-run token share converges to the weight ratio without
  any windowed accounting. A new/idle tenant's vtime is clamped up to
  the current minimum so it can't bank idle credit into a burst.
* **Token-bucket quotas**: a tenant's bucket refills ``rate_per_tick``
  each router tick up to ``burst``; a request is eligible only while
  the bucket covers its priced cost (one admission may overdraw to a
  negative balance so a single over-burst request larger than the
  bucket can still eventually run — it then pays the debt in refill
  ticks). ``rate_per_tick=None`` = unmetered.
* **Starvation bound**: any request passed over ``starvation_ticks``
  times is forced through next, quota or not — same contract as the
  per-replica policy's bound, one level up.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence

__all__ = ["TenantSpec", "TenantFairPolicy"]


@dataclass
class TenantSpec:
    """One tenant's share contract."""
    weight: float = 1.0
    rate_per_tick: Optional[float] = None   # uncached tokens/tick; None = ∞
    burst: Optional[float] = None           # bucket cap; default 8× rate

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"tenant weight must be > 0, got "
                             f"{self.weight}")
        if self.rate_per_tick is not None and self.burst is None:
            self.burst = 8.0 * float(self.rate_per_tick)


class TenantFairPolicy:
    """select()/note_admitted() over the ROUTER's queue of
    FabricRequests (anything with ``.tenant``); see module doc.
    Unknown tenants get ``default`` (weight 1, unmetered)."""

    def __init__(self, tenants: Optional[Dict[str, TenantSpec]] = None,
                 default: Optional[TenantSpec] = None,
                 starvation_ticks: int = 256):
        self.tenants = dict(tenants or {})
        self.default = default or TenantSpec()
        self.starvation_ticks = int(starvation_ticks)
        self._vtime: Dict[str, float] = {}
        self._bucket: Dict[str, float] = {}
        self._skips: Dict[object, int] = {}   # _key(req) -> passes skipped
        self.admitted: Dict[str, int] = {}    # per-tenant requests
        self.admitted_tokens: Dict[str, float] = {}
        self.deferred: Dict[str, int] = {}    # select() passes deferred

    def spec(self, tenant: str) -> TenantSpec:
        return self.tenants.get(tenant, self.default)

    @staticmethod
    def _key(req) -> object:
        """Stable identity for the skip map: the router's fid when the
        request has one — id() reuse after a released request could
        otherwise hand a NEW request an inherited near-starvation count
        and let it bypass its tenant's quota."""
        fid = getattr(req, "fid", None)
        return id(req) if fid is None else ("fid", fid)

    # -- clock ---------------------------------------------------------------

    def tick(self) -> None:
        """One router scheduling pass: refill every metered bucket —
        including buckets of UNKNOWN tenants running on a metered
        ``default`` spec (they only exist in ``_bucket``; refilling
        just the configured tenants would drain them once and block
        them forever)."""
        for t in set(self.tenants) | set(self._bucket):
            spec = self.spec(t)
            if spec.rate_per_tick is None:
                continue
            cur = self._bucket.get(t, float(spec.burst))
            self._bucket[t] = min(float(spec.burst),
                                  cur + float(spec.rate_per_tick))

    def _bucket_covers(self, tenant: str, cost: float) -> bool:
        spec = self.spec(tenant)
        if spec.rate_per_tick is None:
            return True
        if float(spec.burst) <= 0.0:
            return False          # zero quota: only starvation admits
        return self._bucket.get(tenant, float(spec.burst)) >= min(
            cost, float(spec.burst))
        # (a request pricier than the whole burst is admittable at a
        # FULL bucket — it overdraws and repays; otherwise it could
        # never run at all)

    # -- selection -----------------------------------------------------------

    def select(self, queue: Sequence, price: Callable[[object], float]
               ) -> Optional[int]:
        """Index of the request to release next, or None to defer all
        this pass. ``price(req)`` → predicted uncached-suffix tokens."""
        if not queue:
            return None
        # NO pruning against ``queue`` here: the router passes a
        # filtered VIEW (capacity-blocked requests excluded), and
        # dropping an absent request's counter would reset the
        # starvation clock of exactly the requests waiting hardest.
        # Stale ids of long-gone requests are swept only when the map
        # outgrows any plausible live queue.
        if len(self._skips) > 4 * len(queue) + 4096:
            live = {self._key(r) for r in queue}
            self._skips = {k: v for k, v in self._skips.items()
                           if k in live}
        for i, req in enumerate(queue):
            if self._skips.get(self._key(req), 0) >= self.starvation_ticks:
                return i
        # eligible = bucket-covered; among those, lowest tenant vtime,
        # FIFO within a tenant (first queue hit for that tenant)
        best_i, best_key = None, None
        seen_tenants: set = set()
        for i, req in enumerate(queue):
            t = req.tenant
            if t in seen_tenants:
                continue              # FIFO within tenant
            seen_tenants.add(t)
            if not self._bucket_covers(t, max(1.0, float(price(req)))):
                continue
            key = (self._vtime.get(t, 0.0), i)
            if best_key is None or key < best_key:
                best_i, best_key = i, key
        if best_i is None:
            for req in queue:
                k = self._key(req)
                self._skips[k] = self._skips.get(k, 0) + 1
                self.deferred[req.tenant] = \
                    self.deferred.get(req.tenant, 0) + 1
        return best_i

    def note_admitted(self, queue: Sequence, chosen: int,
                      cost: float) -> None:
        """The router really dispatched ``queue[chosen]`` at ``cost``
        uncached tokens: advance the tenant's vtime, drain its bucket,
        charge a skip to everyone passed over."""
        req = queue[chosen]
        t = req.tenant
        spec = self.spec(t)
        cost = max(1.0, float(cost))
        floor = min((self._vtime.get(r.tenant, 0.0) for r in queue),
                    default=0.0)
        # idle-credit clamp: a tenant can't return from idle with an
        # ancient vtime and lock everyone else out while it catches up
        vt = max(self._vtime.get(t, 0.0), floor)
        self._vtime[t] = vt + cost / float(spec.weight)
        if spec.rate_per_tick is not None:
            self._bucket[t] = self._bucket.get(
                t, float(spec.burst)) - cost
        self.admitted[t] = self.admitted.get(t, 0) + 1
        self.admitted_tokens[t] = self.admitted_tokens.get(t, 0.0) + cost
        self._skips.pop(self._key(req), None)
        for i, r in enumerate(queue):
            if i != chosen:
                k = self._key(r)
                self._skips[k] = self._skips.get(k, 0) + 1
