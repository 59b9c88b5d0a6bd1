"""Checkpoint reshard CLI: re-lay a committed checkpoint for a different
mesh, offline (counterpart of the JAX package's ``tools/reshard.py``; the
same flags and exit codes).

Reads the source step's recorded ``_PLAN.json`` (so the source layout is
never guessed), derives the target plan from the same spec table with
the new axis sizes, validates feasibility against the checkpoint's index
(every sharded dim must divide by the product of its mesh axes, every
fused part's heads split over or replicate across tp — no payload read),
and either reports (``--dry-run``) or writes under ``--out`` a
fully-committed checkpoint laid out as the target mesh's ranks hold it
(``checkpoint.write_layout``; manifest + ``_COMMITTED`` + the new
``_PLAN.json``).

Usage::

    python -m paddle_tpu_torch.tools.reshard --from ckpts/ --mesh 2x2 \\
        --out ckpts_2x2/
    python -m paddle_tpu_torch.tools.reshard --from ckpts/step_400 \\
        --config dp2_tp2 --dry-run

Exit codes: 0 ok, 1 usage/source errors, 2 infeasible target (an axis
that does not divide a parameter dim, more devices than ``--available``,
or a source with no recorded plan to derive the spec table from).
``main(argv)`` is importable and returns the exit code.
"""

import argparse
import json
import os
import re
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

_STEP_RE = re.compile(r"^step_(\d+)$")


def _parse_target(mesh: str, config: str):
    """--mesh AxB (dp×tp) or --config dp2_tp2[_pp1_sep1] → (config, mesh
    axis sizes)."""
    from paddle_tpu_torch.distributed.auto_parallel import ParallelConfig
    from paddle_tpu_torch.distributed.auto_parallel.emit import mesh_axes
    if config:
        cfg = ParallelConfig.parse(config)
    elif mesh:
        dims = [int(t) for t in mesh.lower().replace("*", "x").split("x")]
        if not dims or any(d < 1 for d in dims) or len(dims) > 2:
            raise SystemExit(f"reshard: bad --mesh {mesh!r} (want e.g. 2x2 "
                             f"= dp x tp)")
        cfg = ParallelConfig(dp=dims[0], tp=dims[1] if len(dims) > 1 else 1)
    else:
        raise SystemExit("reshard: need --mesh or --config")
    return cfg, mesh_axes(cfg)


def _resolve_step_dir(src: str, step):
    """--from accepts a checkpoint root or a step dir directly."""
    src = os.path.abspath(os.path.expanduser(src))
    m = _STEP_RE.match(os.path.basename(src))
    if m and os.path.isdir(src):
        return src, int(m.group(1))
    from paddle_tpu_torch.checkpoint import latest_step
    s = int(step) if step is not None else latest_step(src)
    if s is None:
        return None, None
    return os.path.join(src, f"step_{s}"), s


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="reshard", description=__doc__.split("\n")[0])
    ap.add_argument("--from", dest="src", required=True,
                    help="checkpoint root (newest committed step) or a "
                         "step_N dir")
    ap.add_argument("--step", type=int, default=None,
                    help="pick a specific step under the root")
    ap.add_argument("--mesh", default=None,
                    help="target grid dp x tp, e.g. 2x2")
    ap.add_argument("--config", default=None,
                    help="target config, e.g. dp2_tp2 (full form)")
    ap.add_argument("--out", default=None,
                    help="root to write the resharded checkpoint under "
                         "(required unless --dry-run)")
    ap.add_argument("--dry-run", action="store_true",
                    help="validate + report only; reads the index, not "
                         "payload bytes")
    ap.add_argument("--available", "--virtual-devices", type=int,
                    default=None,
                    help="devices that exist (default: the cards, else "
                         "the CPU cores)")
    args = ap.parse_args(argv)
    if not args.dry_run and not args.out:
        print("reshard: --out is required without --dry-run",
              file=sys.stderr)
        return 1

    from paddle_tpu_torch import checkpoint as ckpt
    from paddle_tpu_torch.distributed.auto_parallel import ShardingPlan
    from paddle_tpu_torch.resilience import reshard as rs
    from paddle_tpu_torch.tools.plan import available_devices
    sdir, step = _resolve_step_dir(args.src, args.step)
    if sdir is None or not os.path.isdir(sdir):
        print(f"reshard: no committed checkpoint under {args.src!r}",
              file=sys.stderr)
        return 1
    saved = rs.read_plan(sdir)
    if saved is None:
        print(f"reshard: {sdir} has no recorded ShardingPlan "
              f"(_PLAN.json missing or single-device) — there is no "
              f"spec table to derive a target layout from; re-save "
              f"under a plan (Trainer.apply_plan + CheckpointManager) "
              f"or re-plan from the model", file=sys.stderr)
        return 2
    cfg, axes = _parse_target(args.mesh, args.config)
    target = ShardingPlan(
        config_str=str(cfg), axes=axes, batch_spec=saved.batch_spec,
        param_specs=saved.param_specs,
        sequence_parallel=saved.sequence_parallel,
        notes=f"resharded offline from {saved.config_str} step_{step}")
    need = target.size
    have = args.available or available_devices()
    if need > have:
        print(f"reshard: target {cfg} needs {need} devices, only {have} "
              f"exist", file=sys.stderr)
        return 2
    index = ckpt.read_index(sdir)
    like = {k: e for k, e in index.items()}
    try:
        rs.check_feasible(ckpt.unflatten({k: _Shape(e["shape"])
                                          for k, e in like.items()}),
                          target,
                          blocks={k: e.get("blocks")
                                  for k, e in like.items()})
    except rs.ReshardError as e:
        print(f"reshard: infeasible: {e}", file=sys.stderr)
        return 2
    sharded = sum(1 for _k, _n, spec, _s in rs._iter_spec_leaves(
        ckpt.unflatten({k: _Shape(e["shape"]) for k, e in like.items()}),
        target.param_specs) if any(e is not None for e in tuple(spec)))
    print(f"reshard: {sdir} [{saved.config_str}] -> {cfg} "
          f"({need} devices, {sharded} sharded leaves): feasible")
    if args.dry_run:
        return 0
    from paddle_tpu_torch.checkpoint import mesh_coords
    from paddle_tpu_torch.resilience import CheckpointManager
    mgr = CheckpointManager(args.out, plan=target)
    out = mgr.step_dir(step)
    with open(mgr._pending_path(step), "w") as f:
        f.write(json.dumps({"step": step, "ts": time.time()}))
    ckpt.write_layout(sdir, out, axes, dict(target.param_specs),
                      [mesh_coords(axes, r) for r in range(need)])
    mgr._commit(step)
    print(f"reshard: committed {out}")
    return 0


class _Shape:
    """A leaf standing for its global shape (feasibility reads shapes)."""

    def __init__(self, shape):
        self.shape = tuple(shape)


if __name__ == "__main__":
    sys.exit(main())
