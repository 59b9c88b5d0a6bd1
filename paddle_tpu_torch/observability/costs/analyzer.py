"""Roofline attribution and collective pricing over a step census
(counterpart of ``paddle_tpu/observability/costs/analyzer.py``, which
walks HLO; here the input is ``analysis.collectives.StepCensus``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .device_db import DeviceSpec, device_spec

__all__ = ["CostReport", "attribute_costs", "price_census"]


@dataclass
class CostReport:
    """The census's ops with their roofline seconds."""
    ops: List = field(default_factory=list)
    total_flops: float = 0.0
    total_bytes: float = 0.0
    compute_s: float = 0.0


def attribute_costs(census, spec: Optional[DeviceSpec] = None) -> CostReport:
    """Each op of ``census`` at max(flops ÷ peak, bytes ÷ memory
    bandwidth), summed (a serialized upper bound)."""
    spec = spec or device_spec()
    rep = CostReport(ops=list(census.ops))
    for o in rep.ops:
        rep.total_flops += o.flops
        rep.total_bytes += o.bytes
        rep.compute_s += max(o.flops / spec.peak_flops,
                             o.bytes / spec.hbm_bw)
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
