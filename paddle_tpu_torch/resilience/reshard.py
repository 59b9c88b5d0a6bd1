"""Checkpoint resharding: load under a DIFFERENT ShardingPlan
(counterpart of ``paddle_tpu/resilience/reshard.py``).

* **provenance** — the ``ShardingPlan`` active at save time rides inside
  the committed step dir as ``_PLAN.json`` (hashed into the manifest like
  every other file; byte-for-byte the JAX package's sidecar for the same
  plan), so a loader on a different mesh never guesses the source
  layout;
* **feasibility + placement** — before touching bytes, every parameter's
  sharded dims (and its fused runs over tp) are checked against the
  TARGET plan's axis sizes (:func:`check_feasible`: a tp shrink that
  leaves uneven attention-head remainders is rejected with an error
  naming the axis), then each rank reads only the pieces of the sharded
  checkpoint that intersect its target slice
  (``checkpoint.load_state_dict(mesh=..., spec_tree=..., coords=...)``),
  placed with the maps ``parallel.api.shard_layer`` uses — peak host
  memory one leaf.

The elastic resume (``distributed/elastic.py``) calls this through
``CheckpointManager.restore`` whenever the saved plan's axes differ from
the live one; ``tools/reshard.py`` exposes the same machinery offline.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

from ..observability.metrics import REGISTRY as _REG

__all__ = ["PLAN_NAME", "ReshardError", "write_plan", "read_plan",
           "effective_axes", "plans_equivalent", "check_feasible",
           "load_resharded", "place_tree"]

PLAN_NAME = "_PLAN.json"
_PLAN_SCHEMA = "pt-ckpt-plan-v1"


class ReshardError(RuntimeError):
    """The target plan cannot legally host this checkpoint (permanent:
    retrying or falling back to an older step cannot fix an indivisible
    axis — the caller must pick a different mesh)."""


# -- plan sidecar -------------------------------------------------------------

def write_plan(step_dir: str, plan, step: int) -> str:
    """Record the active plan (or the implicit single-device plan, as
    ``null``) inside the step dir. Called by CheckpointManager before the
    manifest is built, so the file is hashed like every other payload."""
    payload = {
        "schema": _PLAN_SCHEMA,
        "step": int(step),
        "implicit_single_device": plan is None,
        "plan": plan.as_dict() if plan is not None else None,
    }
    path = os.path.join(step_dir, PLAN_NAME)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(json.dumps(payload, sort_keys=True).encode())
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def read_plan(step_dir: str):
    """The ShardingPlan recorded at save time, or None (implicit
    single-device plan, a pre-plan checkpoint, or no sidecar at all)."""
    path = os.path.join(step_dir, PLAN_NAME)
    if not os.path.isfile(path):
        return None
    with open(path, "rb") as f:
        payload = json.loads(f.read())
    raw = payload.get("plan")
    if raw is None:
        return None
    from ..distributed.auto_parallel.emit import ShardingPlan
    return ShardingPlan.from_dict(raw)


def effective_axes(plan) -> Dict[str, int]:
    """Mesh axes that actually partition anything (size > 1). Two plans
    with the same effective axes hold identical shard layouts even if one
    carries extra size-1 axes. ``plan`` may be a ShardingPlan or its
    ``as_dict()`` form."""
    if plan is None:
        return {}
    axes = plan.get("axes", {}) if isinstance(plan, dict) else plan.axes
    return {k: int(v) for k, v in axes.items() if int(v) > 1}


def plans_equivalent(a, b) -> bool:
    """True when a checkpoint written under ``a`` loads under ``b`` without
    resharding (same effective axis sizes)."""
    return effective_axes(a) == effective_axes(b)


# -- feasibility --------------------------------------------------------------

def _iter_spec_leaves(tree: Dict[str, Any], param_specs: Dict[str, Any],
                      shapes: Optional[Dict[str, Any]] = None
                      ) -> Iterator[Tuple[str, str, Any, Tuple[int, ...]]]:
    """Yield (key, matched name, spec, shape) for every leaf the plan's
    spec table covers — matching full "/"-path, final key, then any path
    component (innermost wins), the same resolution order the restore
    target uses, so feasibility is checked for exactly the leaves that
    will be resharded (params AND their optimizer slots). ``shapes``
    (key -> global shape, e.g. a checkpoint's index) overrides the
    leaves' own shapes (a rank's tree holds local shards)."""
    import numpy as np
    from ..checkpoint import _flatten, _resolve
    for key, x in _flatten(tree):
        name = _resolve(key.split("/"), param_specs)
        if name is None:
            continue
        if shapes is not None and key in shapes:
            shape = tuple(shapes[key])
        else:
            shape = tuple(x.shape) if hasattr(x, "shape") else tuple(
                np.shape(x))
        yield key, name, param_specs[name], shape


def _axis_factor(entry, axes: Dict[str, int]) -> Tuple[int, List[str]]:
    names = list(entry) if isinstance(entry, (tuple, list)) else [entry]
    factor, used = 1, []
    for a in names:
        if a is None:
            continue
        factor *= int(axes.get(a, 1))
        used.append(str(a))
    return factor, used


def check_feasible(like_tree: Dict[str, Any], plan,
                   shapes: Optional[Dict[str, Any]] = None,
                   blocks: Optional[Dict[str, Any]] = None) -> None:
    """Raise ReshardError if any parameter dim the target plan shards is
    not divisible by the product of the mesh axes on that dim, or (with
    ``blocks``, key -> a leaf's fused runs) if a fused part's heads do
    not split over (or replicate evenly across) tp. ``shapes`` gives the
    global shapes when ``like_tree`` holds local shards."""
    if plan is None:
        return
    axes = {k: int(v) for k, v in plan.axes.items()}
    for key, name, spec, shape in _iter_spec_leaves(
            like_tree, plan.param_specs, shapes):
        entries = tuple(spec)
        if len(entries) > len(shape):
            continue                      # restore replicates these anyway
        for d, entry in enumerate(entries):
            if entry is None:
                continue
            factor, used = _axis_factor(entry, axes)
            if factor > 1 and shape[d] % factor != 0:
                ax = "+".join(used)
                raise ReshardError(
                    f"target plan {plan.config_str!r} cannot shard "
                    f"'{name}': dim {d} of shape {tuple(shape)} has size "
                    f"{shape[d]}, not divisible by axis {ax}={factor} "
                    f"(remainder {shape[d] % factor}) — e.g. a tp shrink "
                    f"that does not divide the attention heads leaves "
                    f"uneven head remainders; pick an axis size that "
                    f"divides {shape[d]}")
            tp = axes.get("tp", 1)
            runs = (blocks or {}).get(key)
            if "tp" in used and tp > 1 and runs:
                for units, width in runs:
                    rem = units % tp if units >= tp else tp % units
                    if rem:
                        raise ReshardError(
                            f"target plan {plan.config_str!r} cannot shard "
                            f"'{name}': a fused part of {units} heads of "
                            f"width {width} neither splits over nor "
                            f"replicates evenly across axis tp={tp} "
                            f"(remainder {rem}); pick a tp that divides "
                            f"the heads")


# -- load ---------------------------------------------------------------------

def _target_of(plan, mesh):
    """The ``checkpoint.load_state_dict`` target of a plan: a MeshPlan
    (or sharded model) as given, else the plan's mesh sizes."""
    if mesh is not None and (hasattr(mesh, "shards")
                             or hasattr(mesh, "named_parameters")):
        return mesh, None
    return dict(plan.axes), dict(plan.param_specs)


def place_tree(tree: Dict[str, Any], plan, mesh=None,
               coords: Optional[Dict[str, int]] = None,
               blocks: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Host-side assembly path: cut an already-loaded WHOLE tree into the
    slice of the rank at ``coords`` (default: the live rank) per the
    plan's spec table, with ``shard_layer``'s maps; ``blocks`` (key ->
    fused runs, e.g. a model's ``_sharding_annotations``) are needed for
    fused projections. Unmatched leaves come back whole."""
    import torch
    from ..checkpoint import _flatten, _resolve, _unflatten_like, mesh_coords
    from ..parallel.api import shard_layout
    axes = dict(plan.axes) if plan is not None else {}
    if coords is None:
        if mesh is not None and hasattr(mesh, "_coord"):
            coords = dict(mesh._coord)
        else:
            import torch.distributed as dist
            coords = mesh_coords(axes, dist.get_rank()
                                 if dist.is_initialized() else 0)
    specs = plan.param_specs if plan is not None else {}
    level = "fsdp2" if axes.get("fsdp", 1) > 1 else "none"
    out = {}
    for key, x in _flatten(tree):
        name = _resolve(key.split("/"), specs)
        if name is None or not isinstance(x, torch.Tensor) or len(
                tuple(specs[name])) > x.dim():
            out[key] = x
            continue
        lay = shard_layout(tuple(x.shape), specs[name],
                           (blocks or {}).get(name), axes, coords, level)
        t = x
        for d, runs in enumerate(lay["runs"]):
            t = torch.cat([t.narrow(d, s, n) for s, n in runs], dim=d) \
                if runs else t.narrow(d, 0, 0)
        out[key] = t.contiguous()
    return _unflatten_like(tree, out)


def load_resharded(step_dir: str, like_tree: Dict[str, Any], target_plan,
                   *, mesh=None, devices=None, source_plan=None,
                   coords: Optional[Dict[str, int]] = None
                   ) -> Dict[str, Any]:
    """Load the checkpoint at ``step_dir`` (written under ``source_plan``,
    read from its ``_PLAN.json`` when not given) as the slice
    ``target_plan`` gives the rank at ``coords`` (mesh coordinates;
    default the live rank's), or, when ``mesh`` is the target model's
    ``MeshPlan`` (or the sharded model), exactly as that plan cuts each
    parameter, master and slot. Feasibility is validated up front
    against the checkpoint's global shapes and fused runs. Each leaf is
    read from only the pieces that intersect the slice and lands on the
    device of its ``like_tree`` leaf. ``devices`` is accepted for the
    JAX signature."""
    from .. import checkpoint as _ckpt
    t0 = time.perf_counter()
    if source_plan is None:
        source_plan = read_plan(step_dir)
    try:
        index = _ckpt.read_index(step_dir)
        check_feasible(like_tree, target_plan,
                       shapes={k: e["shape"] for k, e in index.items()},
                       blocks={k: e.get("blocks") for k, e in index.items()})
        target, spec_tree = _target_of(target_plan, mesh)
        tree = _ckpt.load_state_dict(step_dir, like_tree, mesh=target,
                                     spec_tree=spec_tree, coords=coords)
    except Exception as e:
        if _REG.enabled:
            _REG.counter("pt_elastic_reshard_failures_total",
                         "resharded restores that failed").inc(
                error=type(e).__name__)
        raise
    if _REG.enabled:
        src = source_plan.config_str if source_plan is not None else "none"
        _REG.counter("pt_elastic_reshards_total",
                     "cross-plan checkpoint restores").inc(
            source=src, target=target_plan.config_str)
        _REG.histogram("pt_elastic_reshard_seconds",
                       "resharded restore duration", "s").observe(
            time.perf_counter() - t0)
    return tree
