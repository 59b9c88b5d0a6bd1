"""Graph contracts of the port: static analysis over the census of one
eager call (counterpart of ``paddle_tpu/analysis``).

The port's perf properties are graph-SHAPE properties — no materialized
logits, no per-step host sync, state updated in place, a designed
collective pattern (the TP fused CE) — and graph shape is invisible to
numerics tests. Where the JAX package reads XLA's optimized HLO, the
port reads the op stream of one call, recorded once by
:class:`~paddle_tpu_torch.analysis.collectives.StepCensus` (the one
record every analyzer consumes, as JAX's consume ``parse_hlo``):

* :mod:`collectives`     — the census itself (ops, their buffers and
                           in-place writes, collectives with their
                           issue and wait, host syncs, named inputs) and
                           the per-mesh-axis collective census;
* :mod:`materialization` — buffer bans + largest-buffer budgets;
* :mod:`donation`        — in-place updates of the named inputs
                           (donated bytes, replaced or copied inputs);
* :mod:`transfers`       — host syncs inside hot calls;
* :mod:`overlap`         — async-collective windows: distance, priced
                           in-window compute, exposed comm fraction;
* :mod:`contracts`       — declarative ``GraphContract`` + JSON budget
                           snapshots with diff-style failures;
* :mod:`graphs`          — the canonical calls (train step K=1 / K=4,
                           serving ticks, prefix admit, fused CE, the
                           sharded steps) the budgets pin;
* :mod:`trace_lint`      — AST linter for host-sync / capture hazards in
                           the hot Python paths (waivable inline);
* :mod:`critical_path`   — exclusive self-time per serving hop over the
                           request traces: TTFT / ITL attribution,
                           per-hop tables, Perfetto export.

CLI: ``python -m paddle_tpu_torch.tools.graph_lint`` (the card unless
``--device cpu``); ``--update-budgets`` re-pins
``paddle_tpu_torch/tools/graph_budgets.json`` keeping the waivers.

The names load on first use, so the tracer's gauge hook imports
:mod:`critical_path` (stdlib only) without the rest.
"""

from __future__ import annotations

import importlib

# public name -> submodule that defines it
_WHERE = {
    "collective_census": "collectives", "mesh_axis_groups": "collectives",
    "StepCensus": "collectives",
    "BanRule": "contracts", "GraphContract": "contracts",
    "GraphReport": "contracts", "Violation": "contracts",
    "analyze": "contracts", "check_budget": "contracts",
    "check_contract": "contracts", "load_budgets": "contracts",
    "render_violations": "contracts", "save_budgets": "contracts",
    "snapshot_report": "contracts",
    "donation_report": "donation",
    "REGISTRY": "graphs", "BuiltGraph": "graphs",
    "GraphSkipped": "graphs", "build_graph": "graphs",
    "graph_names": "graphs",
    "banned_buffers": "materialization",
    "materialization_report": "materialization",
    "OverlapWindow": "overlap", "UnmatchedCollectiveError": "overlap",
    "overlap_report": "overlap",
    "host_transfer_report": "transfers",
}
_MODULES = ("collectives", "contracts", "critical_path", "donation",
            "graphs", "materialization", "overlap", "trace_lint",
            "transfers")

__all__ = [
    "analyze", "StepCensus",
    "BanRule", "GraphContract", "GraphReport", "Violation",
    "check_budget", "check_contract", "snapshot_report",
    "load_budgets", "save_budgets", "render_violations",
    "materialization_report", "banned_buffers", "donation_report",
    "host_transfer_report", "collective_census", "mesh_axis_groups",
    "OverlapWindow", "UnmatchedCollectiveError", "overlap_report",
    "REGISTRY", "BuiltGraph", "GraphSkipped", "build_graph", "graph_names",
    "critical_path",
]


def __getattr__(name):
    if name in _MODULES:
        return importlib.import_module(f"{__name__}.{name}")
    if name in _WHERE:
        mod = importlib.import_module(f"{__name__}.{_WHERE[name]}")
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
