"""The cost observatory of the port (counterpart of
``paddle_tpu/observability/costs``):

1. **Analytical attribution** (:mod:`analyzer`): a step census's ops at
   the roofline of the :mod:`device_db` tables, and
   :func:`price_census` pricing its collectives per mesh axis.
2. **Measured timings**: ``python -m paddle_tpu_torch.tools.op_cost_probe
   --calibrate`` times the eager training step and its dominant matmuls
   and persists an :class:`OpCostDB` next to the kernel ``TuneDB``
   (``ops/kernels/autotune.py``), which the sharding planner reads.
3. **Live breakdown** (:mod:`live`): the trainer and the serving engine
   publish ``pt_step_time_breakdown`` / ``pt_model_flops_utilization`` /
   ``pt_hbm_bw_utilization`` / ``pt_step_time_predicted_over_measured``
   through the metrics registry.

The graph contracts of ``analysis/`` (``contracts``, ``graphs``) price
their budgets' ``analytical_flops`` with :func:`attribute_costs`, and the
probe times the registry's graphs (``analysis.graphs``).
"""

from ...analysis.collectives import OpCost
from ...ops.kernels.autotune import OpCostDB, get_op_cost_db
from .analyzer import CostReport, attribute_costs, dominant_dots, price_census
from .device_db import DeviceSpec, current_device_kind, device_spec
from .live import CostWatch

__all__ = [
    "CostReport", "OpCost", "attribute_costs", "dominant_dots",
    "price_census", "DeviceSpec", "device_spec", "current_device_kind",
    "CostWatch", "OpCostDB", "get_op_cost_db",
]
