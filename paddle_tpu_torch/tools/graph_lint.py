"""Graph-contract lint gate (counterpart of the JAX package's
``tools/graph_lint.py``).

Builds every canonical call of ``analysis.graphs`` (train step K=1 /
K=4, the serving ticks with speculation off and on and quantized, the
prefix-hit admit, the fused CE head; and in a world of 4 ranks the
vocab-parallel CE head and the steps emitted through the planner's
dp2 x tp2, fsdp2 x tp2 and dp4 x ep2 plans), takes each one's census,
runs the analyzers (materialization, donation, host syncs, collective
census, overlap) and checks:

1. the declarative ``GraphContract`` invariants (no banned buffer, the
   in-place updates the design requires, zero host syncs, the designed
   collective pattern);
2. the checked-in budgets (``graph_budgets.json`` beside this file): byte
   ceilings, donation floors, exact collective counts and the waived set
   of replaced or copied inputs, with JAX's semantics key for key.

Failures print a diff — budget vs actual, with the producing op or the
line that synced — so the message names WHO materialized the logits or
WHICH in-place update was lost. Intentional changes are accepted with
``--update-budgets`` (waivers and their rationales are kept). The
budgets are device-independent: the same file holds on the CPU and on
the card, where the kernels run (their wrappers report what they write).

Also lints the hot-path packages (``trainer/``, ``inference/``,
``ops/``, ``analysis/``) with ``analysis.trace_lint``: unwaived hazards
fail the gate.

Usage::

    python -m paddle_tpu_torch.tools.graph_lint --device cpu   # CPU
    python -m paddle_tpu_torch.tools.graph_lint                # the card
    python -m paddle_tpu_torch.tools.graph_lint --device cpu --update-budgets
    python -m paddle_tpu_torch.distributed.launch --nproc_per_node 4 \\
        paddle_tpu_torch/tools/graph_lint.py --device cpu  # sharded, gloo

In one process the four sharded graphs are reported as needing 4 ranks;
under the launcher (4 ranks) only they are built. ``main()`` is
importable and returns the result dict.
"""

import argparse
import json
import os
import sys

if __package__ in (None, ""):
    # run as a script (the launcher's form): the repository is the root
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO = os.path.dirname(_PKG)
DEFAULT_BUDGETS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "graph_budgets.json")
LINT_PATHS = ("trainer", "inference", "ops", "analysis")


def _world(device):
    """The world size, bringing the process group up under the launcher
    (NCCL on the card, gloo with ``--device cpu``)."""
    import torch.distributed as dist
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 \
            and not dist.is_initialized():
        from paddle_tpu_torch.parallel.mesh import init_parallel_env
        cpu = device == "cpu"
        init_parallel_env(dp=int(os.environ["WORLD_SIZE"]),
                          backend="gloo" if cpu else "nccl",
                          device="cpu" if cpu else "cuda")
    return dist.get_world_size() if dist.is_initialized() else 1


def check(names, device=None, budgets=None, update=False, log=print):
    """Build, analyze and check ``names``; returns ``(violations,
    snapshots, skipped, reports)``. ``budgets`` (the loaded file) is
    checked, or with ``update`` re-pinned in place."""
    import paddle_tpu_torch.analysis as A
    budgets = budgets if budgets is not None else {"graphs": {}}
    entries = budgets.setdefault("graphs", {})
    violations, snapshots, skipped, reports = [], {}, [], {}
    for name in names:
        log(f"graph_lint: building {name} ...")
        try:
            g = A.build_graph(name, device)
        except A.GraphSkipped as e:
            skipped.append(name)
            if name in entries and not update:
                violations.append(A.Violation(
                    name, "build.skipped",
                    f"budgeted graph could not be built here: {e}"))
            continue
        rep = A.analyze(g.census, g.name, g.contract, mesh=g.mesh)
        reports[name] = (g, rep)
        snapshots[name] = A.snapshot_report(rep)
        violations.extend(A.check_contract(g.contract, rep))
        if update:
            entry = entries.setdefault(name, {})
            entry["budget"] = snapshots[name]
            entry.setdefault("waivers", {})
            entry["notes"] = g.contract.notes
        elif name in entries:
            violations.extend(A.check_budget(rep, entries[name]))
        else:
            violations.append(A.Violation(
                name, "budget.missing",
                f"no checked-in budget for '{name}' — run graph_lint "
                f"--update-budgets and commit the budget file"))
    return violations, snapshots, skipped, reports


def main(budgets_path: str = DEFAULT_BUDGETS, update: bool = False,
         graphs=None, verbose: bool = True, device=None):
    """Returns ``{"ok", "violations", "snapshots", "skipped",
    "trace_lint", "device"}``; importable in-process (the contract test
    drives it this way)."""
    import torch

    import paddle_tpu_torch.analysis as A
    from paddle_tpu_torch.analysis import trace_lint
    from paddle_tpu_torch.analysis.graphs import SHARDED

    def log(msg):
        if verbose:
            print(msg, flush=True)

    world = _world(device)
    rank = torch.distributed.get_rank() if world > 1 else 0
    budgets = A.load_budgets(budgets_path)
    if graphs:
        names = [g.strip() for g in graphs if g.strip()]
    else:
        names = [n for n in A.graph_names()
                 if (n in SHARDED) == (world == 4)]
    unknown = [n for n in names if n not in A.REGISTRY]
    if unknown:
        raise SystemExit(f"graph_lint: unknown graph(s) "
                         f"{', '.join(unknown)}; known: "
                         f"{', '.join(A.graph_names())}")
    violations, snapshots, skipped, _ = check(names, device, budgets,
                                              update, log)
    lint_violations = []
    if rank == 0:
        log("graph_lint: trace_lint over " + ", ".join(LINT_PATHS))
        lint_violations = trace_lint.lint_paths(
            [os.path.join(_PKG, p) for p in LINT_PATHS])
    hard_lint = [v for v in lint_violations if not v.waived]
    for v in hard_lint:
        violations.append(A.Violation(
            os.path.relpath(v.path, _REPO), f"trace_lint.{v.rule}",
            f"line {v.line}: {v.message} (waive inline with "
            f"`# trace-lint: waive({v.rule}) <reason>`)"))

    if update and rank == 0:
        budgets["_meta"] = {
            "generated_by": "python -m paddle_tpu_torch.tools.graph_lint "
                            "--update-budgets",
            "torch_version": torch.__version__.split("+")[0],
            "devices": "the same budgets hold on the CPU and on the card",
            "overlap_priced_at": A.contracts.REFERENCE_KIND,
            "semantics": dict(A.contracts.SEMANTICS),
        }
        A.save_budgets(budgets_path, budgets)
        log(f"graph_lint: budgets written to {budgets_path}")

    ok = not violations
    log("")
    log(A.render_violations(violations))
    rest = [n for n in A.graph_names() if n not in names]
    log(f"graph_lint: {len(names) - len(skipped)} graph(s) checked"
        + (f", {len(skipped)} skipped ({', '.join(skipped)})"
           if skipped else "")
        + (f"; not built in a world of {world}: {', '.join(rest)}"
           if rest else "")
        + f", {sum(v.waived for v in lint_violations)} trace-lint "
          f"waiver(s) honored")
    return {
        "ok": ok,
        "violations": [v.render() for v in violations],
        "snapshots": snapshots,
        "skipped": skipped,
        "world": world,
        "device": str(device or "cuda"),
        "trace_lint": {
            "violations": len(hard_lint),
            "waived": sum(v.waived for v in lint_violations),
            "waivers": trace_lint.waivers(lint_violations),
        },
    }


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--update-budgets", action="store_true",
                    help="re-pin graph_budgets.json (keeps the waivers) "
                         "instead of checking")
    ap.add_argument("--budgets", default=DEFAULT_BUDGETS)
    ap.add_argument("--graphs", default=None,
                    help="comma-separated subset of canonical graphs")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="the card unless cpu")
    ap.add_argument("--json", action="store_true",
                    help="print the result dict as JSON")
    args = ap.parse_args()
    res = main(budgets_path=args.budgets, update=args.update_budgets,
               graphs=args.graphs.split(",") if args.graphs else None,
               verbose=not args.json, device=args.device)
    if args.json:
        print(json.dumps(res, indent=1, sort_keys=True))
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    sys.exit(0 if res["ok"] else 1)
