"""The plan sidecar of a checkpoint (the part of
``paddle_tpu/resilience/reshard.py`` the port needs before resharding).

Every committed step dir holds ``_PLAN.json``, hashed into the manifest
like every other file: the ``ShardingPlan`` active at save time, or the
implicit single-device plan as ``null``. The port trains on one card and
has no mesh, so it writes the implicit plan, and a saved plan whose axes
partition anything (size > 1) is refused on read: loading it means a
reshard, which comes with the elastic and resharding slice (ROADMAP.md,
A.5), with ``load_resharded``, ``check_feasible``, ``place_tree``,
``plans_equivalent`` and ``ReshardError``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

__all__ = ["PLAN_NAME", "write_plan", "read_plan", "effective_axes"]

PLAN_NAME = "_PLAN.json"
_PLAN_SCHEMA = "pt-ckpt-plan-v1"


def _a5(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: sharding plans and resharding come with the elastic and "
        f"resharding slice (ROADMAP.md, A.5)")


def write_plan(step_dir: str, plan, step: int) -> str:
    """Record the implicit single-device plan (``plan`` None) inside the
    step dir, as the JAX package does for a planless save. Called by
    CheckpointManager before the manifest is built, so the file is hashed
    like every other payload. A real plan is refused (A.5)."""
    if plan is not None:
        raise _a5("saving under a ShardingPlan")
    payload = {"schema": _PLAN_SCHEMA, "step": int(step),
               "implicit_single_device": True, "plan": None}
    path = os.path.join(step_dir, PLAN_NAME)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(json.dumps(payload, sort_keys=True).encode())
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def effective_axes(plan: Optional[Dict[str, Any]]) -> Dict[str, int]:
    """Mesh axes of a saved plan (its ``as_dict()`` form) that actually
    partition anything (size > 1)."""
    if plan is None:
        return {}
    return {k: int(v) for k, v in plan.get("axes", {}).items()
            if int(v) > 1}


def read_plan(step_dir: str) -> None:
    """The plan recorded at save time: None for the implicit single-device
    plan, a pre-plan checkpoint, no sidecar, or a plan whose axes are all
    of size 1. A plan with real axes raises NotImplementedError (A.5)."""
    path = os.path.join(step_dir, PLAN_NAME)
    if not os.path.isfile(path):
        return None
    with open(path, "rb") as f:
        payload = json.loads(f.read())
    axes = effective_axes(payload.get("plan"))
    if axes:
        raise _a5(f"{step_dir} was saved under a plan with axes {axes}")
    return None
