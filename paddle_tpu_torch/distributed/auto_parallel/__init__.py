"""paddle_tpu_torch.distributed.auto_parallel — the semi-auto and search
layer (counterpart of ``paddle_tpu/distributed/auto_parallel``).

* the **semi-auto API** (``shard_tensor``, ``reshard``, ``shard_layer``,
  placements): ``parallel.api``, re-exported here so auto-parallel
  recipes import from the reference path;
* the **search half**: :mod:`planner` — enumerate legal 5D
  ``(dp, fsdp, tp, pp, sep[, ep])`` configs over a declared device
  count, prune with the per-card memory model (:mod:`memory_model`),
  price survivors from the census of one real training step each (a
  fake world on the meta device), and emit the winner as a
  :class:`ShardingPlan` (:mod:`emit`) that ``Trainer.apply_plan``
  consumes. ``tools/plan.py`` is the CLI face.
"""

from ...parallel.mesh import HybridMesh, current_mesh
from ...parallel.api import (shard_tensor, reshard, shard_layer,
                             shard_optimizer_state, param_spec_tree,
                             Shard, Replicate, Partial)

from .planner import (ParallelConfig, PricedConfig, PlanReport,
                      StaleCostModelError, InfeasibleMeshError,
                      enumerate_configs, ep_imbalance, price_compiled,
                      price_config, plan, rank_agreement, check_drift,
                      validate_rank_order)
from .memory_model import MemoryEstimate, estimate_hbm, hbm_capacity
from .emit import ShardingPlan, emit_plan, plan_for_config


def dtensor_from_fn(fn, mesh=None, placements=(), *args, **kwargs):
    """Build a sharded tensor from a creation fn (reference: api.py:248
    dtensor_from_fn) — create then place."""
    return shard_tensor(fn(*args, **kwargs), mesh=mesh,
                        placements=placements)


from ..compat import ProcessMesh  # noqa: E402
from ..strategy import DistributedStrategy as Strategy  # noqa: E402

__all__ = ["ProcessMesh", "shard_tensor", "reshard", "shard_layer",
           "shard_optimizer_state", "dtensor_from_fn", "Shard",
           "Replicate", "Partial", "Strategy", "HybridMesh",
           "current_mesh", "param_spec_tree",
           # planner API
           "ParallelConfig", "PricedConfig", "PlanReport",
           "StaleCostModelError", "InfeasibleMeshError",
           "enumerate_configs", "ep_imbalance", "price_compiled",
           "price_config", "plan", "rank_agreement", "check_drift",
           "validate_rank_order", "MemoryEstimate", "estimate_hbm",
           "hbm_capacity", "ShardingPlan", "emit_plan", "plan_for_config"]
