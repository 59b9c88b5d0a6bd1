"""fleet.meta_optimizers path (counterpart of
``paddle_tpu/distributed/fleet/meta_optimizers``): the dygraph optimizer
wrappers recipes import."""
from .dygraph_optimizer import (DygraphShardingOptimizer,
                                HybridParallelOptimizer)

__all__ = ["HybridParallelOptimizer", "DygraphShardingOptimizer"]
