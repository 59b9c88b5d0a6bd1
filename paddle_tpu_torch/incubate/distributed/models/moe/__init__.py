"""``incubate.distributed.models.moe`` path (counterpart of
``paddle_tpu/incubate/distributed/models/moe``): the same objects as
``distributed.models.moe``, from ``parallel.moe``."""

from .....parallel.moe import (MoELayer, MoEMLP, top_k_gating,
                               top_k_routing)

__all__ = ["MoELayer", "MoEMLP", "top_k_gating", "top_k_routing"]
