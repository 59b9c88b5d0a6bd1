"""``paddle.distributed.collective`` module path (counterpart of
``paddle_tpu/distributed/collective.py``): group creation and the
collectives, implemented in ``communication.py``."""

from .communication import (Group, ReduceOp, all_gather, all_reduce,
                            alltoall, barrier, broadcast, gather, get_rank,
                            get_world_size, new_group, reduce,
                            reduce_scatter, scatter)

_get_global_group = new_group

__all__ = ["Group", "ReduceOp", "new_group", "get_rank", "get_world_size",
           "barrier", "all_reduce", "all_gather", "reduce_scatter",
           "alltoall", "broadcast", "reduce", "scatter", "gather"]
