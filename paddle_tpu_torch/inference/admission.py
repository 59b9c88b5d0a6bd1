"""SLO-aware admission and eviction policy for the serving engine (copy
of ``paddle_tpu/inference/admission.py``).

The engine's default scheduling is FIFO admission and newest-first
recompute preemption. This pluggable policy lets the prefix cache and
the latency percentiles drive scheduling instead:

* **Prefix-cache-aware ordering**: among queued requests, admit the one
  with the SHORTEST uncached suffix first (its prefill is cheapest and it
  reuses the hottest tree path before eviction claims it). FIFO order
  breaks ties, and a starvation bound forces the oldest request through
  after ``starvation_ticks`` skips.
* **SLO-priced admission**: a request's admission cost is its predicted
  prefill work, the uncached suffix length. While the engine's ITL p99 is
  over target, a long cold prefill would stretch every running request's
  ITL further, so it is DEFERRED; cheap admits still flow. A TTFT-target
  breach suspends deferral (the queue is the bigger fire).
* **Victim choice** for recompute preemption: prefer slots that cost the
  least to replay (fewest generated tokens) and free the most memory
  (many private pages, few shared tree pages).

The policy is host-pure: ``select`` and ``choose_victim`` take plain
snapshots, so tests drive them with synthetic gauges and the engine
calls them with live ones. In the serving fabric it is the per-replica
leaf under ``serving_fabric.TenantFairPolicy``, which prices in the same
uncached-suffix unit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

__all__ = ["AdmissionPolicy", "SLOAdmissionPolicy", "VictimInfo"]


@dataclass
class VictimInfo:
    """One preemptible slot as the victim chooser sees it."""
    slot: int
    rid: int
    progress: int          # generated tokens that replay would recompute
    private_pages: int     # pages eviction returns to the pool
    shared_pages: int      # tree-owned pages (eviction frees none)


class AdmissionPolicy:
    """Base contract. The default instance reproduces the engine's
    built-in behavior (FIFO admission, newest-rid victim) so subclasses
    can override one decision without re-specifying the other."""

    def select(self, queue: Sequence, uncached_of: Callable[[object], int],
               lat: Dict[str, float]) -> Optional[int]:
        """Index into ``queue`` of the request to admit next, or None
        to defer every queued request this tick. ``uncached_of(req)``
        prices a request's prefill (uncached suffix tokens); ``lat`` is
        the engine's ``latency_stats()`` snapshot."""
        return 0 if len(queue) else None

    def note_admitted(self, queue: Sequence, chosen: int) -> None:
        """Feedback hook: the engine admitted ``queue[chosen]`` (pages
        really claimed). Default: stateless, nothing to record."""

    def choose_victim(self, candidates: List[VictimInfo]) -> int:
        """Slot to recompute-preempt when the pool is dry; must pick
        from ``candidates`` (non-empty)."""
        return max(candidates, key=lambda v: v.rid).slot


class SLOAdmissionPolicy(AdmissionPolicy):
    """Admission priced by predicted prefill cost against the live
    TTFT/ITL percentile gauges; see module docstring.

    ``itl_p99_target_s`` — defer admits costlier than
    ``defer_uncached_tokens`` while ``lat["itl_p99_s"]`` exceeds this
    (None disables deferral).
    ``ttft_p99_target_s`` — when ``lat["ttft_p99_s"]`` ALSO breaches
    this, queued requests are the emergency: deferral is suspended.
    ``defer_uncached_tokens`` — admits at or below this predicted
    prefill cost are never deferred (they barely dent ITL).
    ``starvation_ticks`` — a request skipped this many select() calls
    (by ordering or deferral) is forced through FIFO-style regardless.
    """

    def __init__(self, itl_p99_target_s: Optional[float] = None,
                 ttft_p99_target_s: Optional[float] = None,
                 defer_uncached_tokens: int = 256,
                 starvation_ticks: int = 64):
        self.itl_p99_target_s = itl_p99_target_s
        self.ttft_p99_target_s = ttft_p99_target_s
        self.defer_uncached_tokens = int(defer_uncached_tokens)
        self.starvation_ticks = int(starvation_ticks)
        self.deferrals = 0                     # lifetime defer decisions
        self._skips: Dict[int, int] = {}       # id(req) -> skipped selects

    # -- admission -----------------------------------------------------------

    def _itl_breached(self, lat: Dict[str, float]) -> bool:
        if self.itl_p99_target_s is None:
            return False
        itl = lat.get("itl_p99_s")
        if itl is None or itl <= self.itl_p99_target_s:
            return False
        if self.ttft_p99_target_s is not None and \
                lat.get("ttft_p99_s", 0.0) > self.ttft_p99_target_s:
            return False                       # queue is the bigger fire
        return True

    def select(self, queue, uncached_of, lat):
        if not queue:
            return None
        live = {id(r) for r in queue}
        self._skips = {k: v for k, v in self._skips.items() if k in live}
        # starvation override: the oldest over-skipped request wins
        for i, req in enumerate(queue):
            if self._skips.get(id(req), 0) >= self.starvation_ticks:
                return i
        costs = [int(uncached_of(r)) for r in queue]
        order = sorted(range(len(queue)), key=lambda i: (costs[i], i))
        breached = self._itl_breached(lat)
        for i in order:
            if breached and costs[i] > self.defer_uncached_tokens:
                continue                       # too expensive right now
            return i
        # every queued request is an expensive cold prefill during an
        # ITL breach: defer them all, let running decodes catch up —
        # a genuine policy decision, so it counts toward starvation
        self.deferrals += 1
        for req in queue:
            self._skips[id(req)] = self._skips.get(id(req), 0) + 1
        return None

    def note_admitted(self, queue, chosen: int) -> None:
        """Charge a skip to every request a SUCCESSFUL admit passed
        over. The engine calls this only once pages were actually
        claimed — a tick where the pool blocked the chosen admit
        charged nobody (no real admission opportunity was lost), and a
        request repeatedly chosen but unadmittable keeps accruing
        others' skips toward its own starvation protection."""
        for i, req in enumerate(queue):
            if i != chosen:
                self._skips[id(req)] = self._skips.get(id(req), 0) + 1
        self._skips.pop(id(queue[chosen]), None)

    # -- preemption victim ---------------------------------------------------

    def choose_victim(self, candidates: List[VictimInfo]) -> int:
        """Cheapest replay first: least progress burned, then most
        private pages actually returned to the pool, then fewest shared
        refs (leave high-sharing slots resident), newest rid last — the
        default rule's tiebreak, so the policy degrades to it when all
        else is equal."""
        best = min(candidates,
                   key=lambda v: (v.progress, -v.private_pages,
                                  v.shared_pages, -v.rid))
        return best.slot
