"""fleet.recompute path (counterpart of
``paddle_tpu/distributed/fleet/recompute``): the port's
``distributed.recompute``."""
from ...recompute import recompute, recompute_hybrid, recompute_sequential

__all__ = ["recompute", "recompute_sequential", "recompute_hybrid"]
