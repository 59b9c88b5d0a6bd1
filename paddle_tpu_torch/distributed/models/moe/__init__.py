"""``distributed.models.moe`` path (counterpart of
``paddle_tpu/distributed/models/moe``): the port's MoE layer and routing
functions, which live in ``parallel.moe``."""

from ....parallel.moe import (MoELayer, MoEMLP, top_k_gating,
                              top_k_routing)

__all__ = ["MoELayer", "MoEMLP", "top_k_gating", "top_k_routing"]
