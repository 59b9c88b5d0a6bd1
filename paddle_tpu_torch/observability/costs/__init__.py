"""Cost tables and pricing of the port (the part of
``paddle_tpu/observability/costs`` the sharding planner needs): the
device table (:mod:`device_db`) and the roofline and collective pricing
over a step census (:mod:`analyzer`). CostWatch, the TuneDB and the
step-cost gauges stay with ROADMAP.md A.6.
"""

from .analyzer import CostReport, attribute_costs, price_census
from .device_db import DeviceSpec, current_device_kind, device_spec

__all__ = ["CostReport", "attribute_costs", "price_census", "DeviceSpec",
           "current_device_kind", "device_spec"]
