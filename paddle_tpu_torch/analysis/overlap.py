"""Overlap analyzer: how much of each collective's latency is hidden
(counterpart of ``paddle_tpu/analysis/overlap.py``).

The JAX analyzer pairs each async ``-start`` with its ``-done`` in the
scheduled HLO. In the eager port a collective is async where a port site
issues it without waiting (``distributed/overlap.py``'s dx all-reduce
beside dW, ``parallel/api.py``'s gradient sums from the backward's
hooks); the site reports its wait to the census
(``analysis.collectives.async_issued`` / ``async_waited``), and a
functional collective's ``wait_tensor`` is seen directly. So:

* the **overlap distance** of an async collective is the number of
  priced (nonzero flop or byte) ops the census recorded between its
  issue and its wait: work dispatched while the transfer ran;
* the window's **compute seconds** price those ops at the roofline,
  ``max(flops / peak, bytes / memory bandwidth)`` each (the cost
  analyzer's formula);
* a collective's **exposed** seconds are its priced comm time minus the
  window compute covering it (floored at zero); a collective no site
  reported async (FSDP2's, a synchronous call) has a zero-width window
  and is fully exposed.

``min_overlap_distance`` (floor) and ``exposed_comm_fraction``
(ceiling) are budget kinds. An async collective whose wait never came
raises :class:`UnmatchedCollectiveError` naming it, rather than being
reported as hidden or dropped without notice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from .collectives import collective_census

__all__ = ["OverlapWindow", "UnmatchedCollectiveError", "overlap_report"]


class UnmatchedCollectiveError(ValueError):
    """An async collective has no reported wait."""


@dataclass
class OverlapWindow:
    """One collective and the compute dispatched inside its window."""
    opcode: str
    axis: str
    op_name: str
    is_async: bool
    index: int                   # ops recorded before the issue
    done_index: Optional[int]    # ops recorded before the wait
    distance: int                # priced ops inside the window
    window_compute_s: float      # roofline seconds of those ops
    comm_s: float                # priced transfer seconds
    hidden_s: float              # min(comm_s, window_compute_s)
    exposed_s: float             # comm_s - hidden_s

    def describe(self) -> str:
        kind = "async" if self.is_async else "sync"
        return (f"{self.opcode}[{self.axis}] {self.op_name} at op "
                f"{self.index} ({kind}) distance={self.distance} "
                f"window={self.window_compute_s:.3e}s "
                f"comm={self.comm_s:.3e}s exposed={self.exposed_s:.3e}s")


def overlap_report(census, coll: Optional[Dict] = None, mesh=None,
                   spec=None,
                   bandwidths: Optional[Dict[str, float]] = None) -> Dict:
    """Pair every collective with its window and price the overlap.
    ``coll`` (a :func:`collective_census` result) is shared with the
    caller that took it. Returns the windows and the two budgetable
    aggregates: ``min_overlap_distance`` (the least distance over async
    collectives; 0 when there is none) and ``exposed_comm_fraction``
    (exposed ÷ total priced comm seconds; 0.0 without comm)."""
    from ..observability.costs.device_db import device_spec
    if coll is None:
        coll = collective_census(census, mesh=mesh)
    spec = spec or device_spec()
    bandwidths = bandwidths or {}
    ops = census.ops
    windows: List[OverlapWindow] = []
    for c in coll.get("table", []):
        if c.index < 0:
            raise ValueError("census collective lacks its op-stream "
                             "index (a hand-built table?)")
        if c.is_async and c.done_index is None:
            raise UnmatchedCollectiveError(
                f"async collective {c.opcode}[{c.axis}] {c.op_name} "
                f"issued after op {c.index} has no reported wait; "
                f"refusing to report the transfer as hidden")
        comm_s = c.bytes / float(bandwidths.get(c.axis, spec.link_bw))
        distance, window_s = 0, 0.0
        if c.is_async:
            for o in ops[c.index:c.done_index]:
                if o.flops == 0.0 and o.bytes == 0.0:
                    continue
                distance += 1
                window_s += max(o.flops / spec.peak_flops,
                                o.bytes / spec.hbm_bw)
        hidden = min(comm_s, window_s)
        windows.append(OverlapWindow(
            opcode=c.opcode, axis=c.axis, op_name=c.op_name,
            is_async=c.is_async, index=c.index, done_index=c.done_index,
            distance=distance, window_compute_s=window_s, comm_s=comm_s,
            hidden_s=hidden, exposed_s=comm_s - hidden))

    total = sum(w.comm_s for w in windows)
    exposed = sum(w.exposed_s for w in windows)
    async_ws = [w for w in windows if w.is_async]
    worst = max(windows, key=lambda w: w.exposed_s, default=None)
    tightest = min(async_ws, key=lambda w: w.distance, default=None)
    return {
        "windows": windows,
        "async_collectives": len(async_ws),
        "sync_collectives": len(windows) - len(async_ws),
        "min_overlap_distance": int(min((w.distance for w in async_ws),
                                        default=0)),
        "min_distance_collective": tightest.describe() if tightest else "",
        "total_comm_s": total,
        "hidden_comm_s": total - exposed,
        "exposed_comm_s": exposed,
        "exposed_comm_fraction": (round(exposed / total, 6) if total > 0.0
                                  else 0.0),
        "most_exposed_collective": worst.describe() if worst else "",
    }
