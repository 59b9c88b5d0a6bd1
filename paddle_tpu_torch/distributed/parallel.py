"""``paddle.distributed.parallel`` module path (counterpart of
``paddle_tpu/distributed/parallel.py``): the process-group bootstrap and
the rank queries."""

from ..parallel.mesh import init_parallel_env
from .communication import get_rank, get_world_size

__all__ = ["init_parallel_env", "get_rank", "get_world_size"]
