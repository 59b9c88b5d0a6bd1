"""Roofline attribution and collective pricing over a step census
(counterpart of ``paddle_tpu/observability/costs/analyzer.py``, which
walks HLO; here the input is ``analysis.collectives.StepCensus``, or
anything with its ``ops`` and, optionally, ``collectives`` and
``dots``).

The one flop count: each aten op's ``torch.utils.flop_counter`` formula
and each hand-written kernel's own count (``analysis.collectives``).
Each op is priced at max(flops ÷ peak, bytes ÷ memory bandwidth), each
collective at its payload ÷ the link bandwidth; their sum is the
predicted step, a serialized upper bound, which is why the drift between
predicted and measured is itself a monitored ratio
(``live.CostWatch``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .device_db import DeviceSpec, device_spec

__all__ = ["CostReport", "attribute_costs", "price_census",
           "dominant_dots"]


@dataclass
class CostReport:
    """The census's ops with their roofline seconds, and the JAX
    report's totals and predictions."""
    ops: List = field(default_factory=list)
    total_flops: float = 0.0
    total_bytes: float = 0.0
    #: Σ over ops of max(flops ÷ peak, bytes ÷ memory bandwidth)
    compute_s: float = 0.0
    spec: Optional[DeviceSpec] = None
    total_comm_bytes: float = 0.0
    predicted_compute_s: float = 0.0       # total flops ÷ peak
    predicted_hbm_s: float = 0.0           # total bytes ÷ memory bandwidth
    predicted_comm_s: float = 0.0          # collective bytes ÷ link bw
    predicted_step_s: float = 0.0          # compute_s + predicted_comm_s
    dots: List[Tuple[int, int, int, str, int]] = field(
        default_factory=list)              # (m, k, n, dtype, count)
    notes: List[str] = field(default_factory=list)

    def summary(self) -> Dict[str, float]:
        return {
            "total_flops": self.total_flops,
            "total_bytes": self.total_bytes,
            "total_comm_bytes": self.total_comm_bytes,
            "predicted_step_s": self.predicted_step_s,
            "predicted_compute_s": self.predicted_compute_s,
            "predicted_hbm_s": self.predicted_hbm_s,
            "predicted_comm_s": self.predicted_comm_s,
        }


def attribute_costs(census, spec: Optional[DeviceSpec] = None) -> CostReport:
    """Each op of ``census`` at max(flops ÷ peak, bytes ÷ memory
    bandwidth), summed (a serialized upper bound), plus its collectives'
    payload over the link; its matmul shapes by total flops."""
    spec = spec or device_spec()
    rep = CostReport(ops=list(census.ops), spec=spec)
    for o in rep.ops:
        rep.total_flops += o.flops
        rep.total_bytes += o.bytes
        rep.compute_s += max(o.flops / spec.peak_flops,
                             o.bytes / spec.hbm_bw)
    rep.total_comm_bytes = float(sum(
        c.bytes for c in getattr(census, "collectives", ())))
    rep.predicted_compute_s = rep.total_flops / spec.peak_flops
    rep.predicted_hbm_s = rep.total_bytes / spec.hbm_bw
    rep.predicted_comm_s = rep.total_comm_bytes / spec.link_bw
    rep.predicted_step_s = rep.compute_s + rep.predicted_comm_s
    rep.dots = sorted(((m, k, n, dt, cnt) for (m, k, n, dt), cnt in
                       dict(getattr(census, "dots", {}) or {}).items()),
                      key=lambda t: -(2 * t[0] * t[1] * t[2] * t[4]))
    return rep


def price_census(census: Dict, bandwidths: Optional[Dict[str, float]] = None,
                 spec: Optional[DeviceSpec] = None) -> Dict:
    """Price a collective census: bytes over a mesh axis ÷ that axis's
    link bandwidth = predicted comm seconds. ``bandwidths`` maps axis
    name -> bytes/s; axes it doesn't name (including the unclassified
    "?") fall back to ``spec.link_bw``. Pure arithmetic, so a synthetic
    bandwidth table yields exact ratios."""
    spec = spec or device_spec()
    bandwidths = bandwidths or {}
    per_axis: Dict[str, Dict[str, float]] = {}
    per_op: List[Dict] = []
    total_s = 0.0
    for c in census.get("table", []):
        bw = float(bandwidths.get(c.axis, spec.link_bw))
        sec = c.bytes / bw
        total_s += sec
        ax = per_axis.setdefault(c.axis, {"bytes": 0.0, "seconds": 0.0,
                                          "bandwidth": bw})
        ax["bytes"] += c.bytes
        ax["seconds"] += sec
        per_op.append({"opcode": c.opcode, "axis": c.axis,
                       "bytes": c.bytes, "seconds": sec,
                       "op_name": c.op_name})
    return {"per_axis": per_axis, "per_op": per_op,
            "total_comm_bytes": float(census.get("total_collective_bytes",
                                                 0)),
            "total_comm_s": total_s}


def dominant_dots(report: CostReport, top: int = 3) -> List[Dict]:
    """The ``top`` matmul shapes by total flops — the shapes
    ``tools/op_cost_probe.py`` microbenches into the OpCostDB."""
    out = []
    for m, k, n, dtype, count in report.dots[:top]:
        out.append({"m": m, "k": k, "n": n, "dtype": dtype,
                    "count": count, "flops": 2.0 * m * k * n * count})
    return out
