"""Declarative graph contracts + JSON budget snapshots (counterpart of
``paddle_tpu/analysis/contracts.py``).

A ``GraphContract`` states the INVARIANTS one call must hold — the
properties a review can't see and a numerics test can't catch:

* ``ban_rules``       — buffers that must not exist (the [N, V] logits);
* ``require_aliased`` — label prefixes of named inputs that MUST be
  updated in place (params / opt_state in the train step, pools / hist
  in serving);
* ``max_host_transfers`` — host-sync ceiling (0 for every hot call);
* ``expect_collectives`` — exact per-axis collective counts where the
  comm pattern is part of the design (the TP fused-CE trio), ``None``
  where the budget snapshot pins it instead.

The checked-in budget file (``paddle_tpu_torch/tools/graph_budgets.json``)
pins the MEASURED side with JAX's semantics key for key
(:data:`SEMANTICS`): largest buffer bytes, host syncs, collective bytes
and exposed comm fraction are ceilings; donated bytes, aliased inputs,
analytical flops and the overlap distance floors; collective counts
exact; undonated candidates a closed set whose members each need a fix
or a waiver with a rationale. A failing check prints a diff — budget vs
actual, with the producing op — and says how to accept an intentional
change (``graph_lint --update-budgets``, which keeps the waivers).

The input is a census (``analysis.collectives.StepCensus`` or a record
loaded by ``collectives.from_json``), not HLO. The overlap and its
fraction are priced at the H100's table (:data:`REFERENCE_KIND`) on
every device, so one budget file holds on the CPU and on the card.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .collectives import collective_census
from .donation import donation_report
from .materialization import BanRule, materialization_report
from .overlap import overlap_report
from .transfers import host_transfer_report

__all__ = [
    "GraphContract", "GraphReport", "Violation", "analyze",
    "snapshot_report", "check_contract", "check_budget",
    "render_violations", "load_budgets", "save_budgets", "BanRule",
    "SEMANTICS", "REFERENCE_KIND",
]

#: the card whose roofline and link prices the overlap of every budget
REFERENCE_KIND = "NVIDIA H100 80GB HBM3"

#: what each budget key means (JAX's ``_meta.semantics``, key for key)
SEMANTICS = {
    "largest_intermediate_bytes": "ceiling",
    "host_transfer_count": "ceiling",
    "collective_bytes": "ceiling",
    "donated_bytes": "floor",
    "aliased_param_count": "floor",
    "collective_counts": "exact",
    "analytical_flops": "floor",
    "min_overlap_distance": "floor",
    "exposed_comm_fraction": "ceiling",
    "undonated_candidates":
        "closed set; new entries need a fix or a waiver",
}


@dataclass
class GraphContract:
    name: str
    ban_rules: Tuple[BanRule, ...] = ()
    require_aliased: Tuple[str, ...] = ()     # input-label prefixes
    max_host_transfers: int = 0
    expect_collectives: Optional[Dict[str, int]] = None
    min_overlap_distance: Optional[int] = None
    max_exposed_comm_fraction: Optional[float] = None
    notes: str = ""


@dataclass
class GraphReport:
    name: str
    census: object
    materialization: Dict
    donation: Dict
    transfers: Dict
    collectives: Dict
    overlap: Dict = field(default_factory=dict)


@dataclass
class Violation:
    graph: str
    rule: str
    message: str
    lines: List[str] = field(default_factory=list)

    def render(self) -> str:
        out = [f"FAIL {self.graph} :: {self.rule}", f"  {self.message}"]
        out += [f"    {l}" for l in self.lines]
        return "\n".join(out)


def analyze(census, name: str = "graph",
            contract: Optional[GraphContract] = None,
            mesh=None) -> GraphReport:
    """Run every analyzer over one call's census."""
    from ..observability.costs.device_db import device_spec
    rules = contract.ban_rules if contract is not None else ()
    coll = collective_census(census, mesh=mesh)
    return GraphReport(
        name=name, census=census,
        materialization=materialization_report(census, rules),
        donation=donation_report(census),
        transfers=host_transfer_report(census),
        collectives=coll,
        overlap=overlap_report(census, coll=coll,
                               spec=device_spec(REFERENCE_KIND)))


# -- contract invariants -----------------------------------------------------

def check_contract(contract: GraphContract,
                   report: GraphReport) -> List[Violation]:
    v: List[Violation] = []
    banned = report.materialization["banned"]
    if banned:
        v.append(Violation(
            report.name, "materialization.ban",
            f"{len(banned)} banned buffer(s) materialized "
            f"(rule: {', '.join(r.label for r in contract.ban_rules)})",
            [h.describe() for h in banned[:8]]))

    if contract.require_aliased:
        inputs = report.census.inputs
        aliased = {a["label"] for a in report.donation["aliased"]}
        for prefix in contract.require_aliased:
            matching = [l for l in inputs if l.startswith(prefix)]
            if not matching:
                v.append(Violation(
                    report.name, f"donation.require_aliased[{prefix}]",
                    f"no named input labeled '{prefix}*' exists — the "
                    f"contract references a renamed/removed input"))
                continue
            missing = [l for l in matching if l not in aliased]
            if missing:
                v.append(Violation(
                    report.name, f"donation.require_aliased[{prefix}]",
                    f"{len(missing)}/{len(matching)} '{prefix}*' "
                    f"input(s) are NOT updated in place (replaced, or "
                    f"copied before the write); update them in place or "
                    f"waive with a rationale",
                    [f"{l} ({inputs[l].leaf})" for l in missing[:8]]))

    ht = report.transfers["host_transfer_count"]
    if ht > contract.max_host_transfers:
        v.append(Violation(
            report.name, "transfers.max_host_transfers",
            f"{ht} host sync(s) in a hot call (budget "
            f"{contract.max_host_transfers}) — a per-step host read "
            f"re-entered the path", report.transfers["host_syncs"][:8]))

    if contract.expect_collectives is not None:
        actual = report.collectives["counts"]
        if actual != contract.expect_collectives:
            v.append(Violation(
                report.name, "collectives.expect",
                "collective census diverged from the contract",
                _dict_diff(contract.expect_collectives, actual)))

    ov = report.overlap or {}
    if contract.min_overlap_distance is not None:
        actual_d = ov.get("min_overlap_distance", 0)
        if actual_d < contract.min_overlap_distance:
            v.append(Violation(
                report.name, "overlap.min_overlap_distance",
                f"a collective's issue->wait window collapsed: contract "
                f"floor {contract.min_overlap_distance} -> actual "
                f"{actual_d} op(s) in the window",
                [l for l in [ov.get("min_distance_collective", "")] if l]))
    if contract.max_exposed_comm_fraction is not None:
        actual_f = ov.get("exposed_comm_fraction", 0.0)
        if actual_f > contract.max_exposed_comm_fraction:
            v.append(Violation(
                report.name, "overlap.max_exposed_comm_fraction",
                f"exposed (un-overlapped) comm fraction "
                f"{actual_f:.4f} exceeds the contract ceiling "
                f"{contract.max_exposed_comm_fraction:.4f}",
                [l for l in [ov.get("most_exposed_collective", "")] if l]))
    return v


# -- budget snapshots --------------------------------------------------------

def snapshot_report(report: GraphReport) -> Dict:
    """The JSON-able measured quantities a budget pins."""
    from ..observability.costs import attribute_costs
    flops = int(attribute_costs(report.census).total_flops)
    ov = report.overlap
    return {
        "largest_intermediate_bytes":
            report.materialization["largest_intermediate_bytes"],
        "donated_bytes": report.donation["donated_bytes"],
        "aliased_param_count": report.donation["aliased_param_count"],
        "undonated_candidates": sorted(
            c.label for c in report.donation["undonated_candidates"]),
        "host_transfer_count": report.transfers["host_transfer_count"],
        "collective_counts": report.collectives["counts"],
        "collective_bytes": report.collectives["total_collective_bytes"],
        # floor: an op falling out of the path (a layer dropped, the
        # loss head reverting) shows as a flop drop
        "analytical_flops": flops,
        "min_overlap_distance": ov["min_overlap_distance"],
        "exposed_comm_fraction": ov["exposed_comm_fraction"],
    }


def _dict_diff(budget: Dict, actual: Dict) -> List[str]:
    lines = []
    for k in sorted(set(budget) | set(actual)):
        b, a = budget.get(k, 0), actual.get(k, 0)
        if b != a:
            lines.append(f"{k}: budget {b} -> actual {a}")
    return lines


def check_budget(report: GraphReport, entry: Dict) -> List[Violation]:
    """Compare a report against one budget-file entry
    (``{"budget": {...}, "waivers": {label: rationale}}``)."""
    budget = entry.get("budget", {})
    waivers = entry.get("waivers", {})
    snap = snapshot_report(report)
    v: List[Violation] = []

    def ceiling(key, why, details=()):
        if key in budget and snap[key] > budget[key]:
            extra = (report.materialization["largest_buffers"][:4]
                     if key == "largest_intermediate_bytes"
                     else list(details))
            v.append(Violation(
                report.name, f"budget.{key}",
                f"{why}: budget {budget[key]:,} -> actual {snap[key]:,} "
                f"(+{snap[key] - budget[key]:,}); intentional? re-pin with "
                f"--update-budgets", extra))

    def floor(key, why, details=()):
        if key in budget and snap[key] < budget[key]:
            v.append(Violation(
                report.name, f"budget.{key}",
                f"{why}: budget {budget[key]:,} -> actual {snap[key]:,} "
                f"({snap[key] - budget[key]:,})", list(details)))

    aliased = {a["label"] for a in report.donation["aliased"]}
    lost = [f"{l} (not in place)" for l in sorted(report.census.inputs)
            if l not in aliased][:8]
    ceiling("largest_intermediate_bytes",
            "largest live buffer grew past its budget")
    ceiling("host_transfer_count", "host syncs appeared in a hot call",
            report.transfers["host_syncs"][:8])
    ceiling("collective_bytes", "collective payload bytes grew")
    floor("donated_bytes",
          "donated bytes dropped — an in-place update was lost", lost)
    floor("aliased_param_count",
          "fewer inputs are updated in place than the budget pins", lost)
    floor("analytical_flops",
          "analytical flop count dropped — an op fell out of the path "
          "(intentional? re-pin with --update-budgets)")

    ov = report.overlap or {}
    floor("min_overlap_distance",
          "a collective's issue->wait window collapsed — no work is "
          "dispatched while the transfer runs",
          [l for l in [ov.get("min_distance_collective", "")] if l])
    ceiling("exposed_comm_fraction",
            "exposed (un-overlapped) comm fraction grew",
            [l for l in [ov.get("most_exposed_collective", "")] if l])

    if "collective_counts" in budget:
        if snap["collective_counts"] != budget["collective_counts"]:
            v.append(Violation(
                report.name, "budget.collective_counts",
                "collective census changed (an extra gather or sum, or an "
                "intentional change — re-pin with --update-budgets)",
                _dict_diff(budget["collective_counts"],
                           snap["collective_counts"])))

    if "undonated_candidates" in budget:
        known = set(budget["undonated_candidates"]) | set(waivers)
        new = [c for c in report.donation["undonated_candidates"]
               if c.label not in known]
        if new:
            v.append(Violation(
                report.name, "budget.undonated_candidates",
                f"{len(new)} NEW input(s) replaced or copied instead of "
                f"updated in place: update them in place or add a waiver "
                f"with a rationale", [c.describe() for c in new[:8]]))
    return v


# -- budget file I/O ---------------------------------------------------------

def load_budgets(path: str) -> Dict:
    if not os.path.exists(path):
        return {"_meta": {}, "graphs": {}}
    with open(path) as f:
        return json.load(f)


def save_budgets(path: str, budgets: Dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(budgets, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


def render_violations(violations: Sequence[Violation]) -> str:
    if not violations:
        return "OK: all graph contracts hold"
    return "\n".join(x.render() for x in violations)
