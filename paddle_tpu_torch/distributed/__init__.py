"""Distributed training machinery of the port (counterpart of
``paddle_tpu/distributed``): the ``paddle.distributed``-shaped surface
over ``torch.distributed`` — the process-group bootstrap and the device
mesh, the per-rank collectives, the semi-auto API (``shard_tensor``,
``shard_layer``), the hybrid topology, ``DistributedStrategy``,
``fleet``, ``group_sharded_parallel`` — and activation recompute.

The collectives and recompute load with the package; the rest on first
use, so that the modules they build on (``parallel.api`` among them) may
import ``distributed.communication`` without a cycle.
"""

import importlib

from .communication import (Group, P2POp, ReduceOp, all_gather, all_reduce,
                            alltoall, barrier, batch_isend_irecv, broadcast,
                            gather, get_rank, get_world_size, irecv, isend,
                            new_group, ppermute, reduce, reduce_scatter,
                            scatter, send_recv, send_to, stream)
from .recompute import (recompute, recompute_hybrid,  # noqa: F401
                        recompute_sequential, recompute_wrapper,
                        resolve_policy)

_LAZY = {
    "HybridMesh": "..parallel.mesh", "current_mesh": "..parallel.mesh",
    "init_parallel_env": "..parallel.mesh",
    "shard_tensor": "..parallel.api", "reshard": "..parallel.api",
    "shard_layer": "..parallel.api",
    "shard_optimizer_state": "..parallel.api",
    "param_spec_tree": "..parallel.api", "full_state_dict": "..parallel.api",
    "Shard": "..parallel.api", "Replicate": "..parallel.api",
    "Partial": "..parallel.api", "Placement": "..parallel.api",
    "CommunicateTopology": ".topology",
    "HybridCommunicateGroup": ".topology",
    "DistributedStrategy": ".strategy",
    "group_sharded_parallel": ".sharding",
    "save_group_sharded_model": ".sharding",
}
_SUBMODULES = ("fleet", "sharding", "strategy", "topology", "collective",
               "parallel", "communication", "recompute", "watchdog")


# the JAX package's modules that wait for ROADMAP.md A.4c (the
# launcher, the overlap and compat layers, rpc, the auto-tuner, the
# distributed io and utils): reaching one raises naming it
LATER = ("launch", "overlap", "compat", "rpc", "auto_tuner", "io", "utils")


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name], __name__), name)
    if name in _SUBMODULES:
        return importlib.import_module("." + name, __name__)
    if name in LATER:
        raise NotImplementedError(
            f"paddle_tpu_torch.distributed.{name} is not ported yet: it "
            f"comes with ROADMAP.md A.4c")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["Group", "P2POp", "ReduceOp", "all_gather", "all_reduce",
           "alltoall", "barrier", "batch_isend_irecv", "broadcast", "gather",
           "get_rank", "get_world_size", "irecv", "isend", "new_group",
           "ppermute", "reduce", "reduce_scatter", "scatter", "send_recv",
           "send_to", "stream", "recompute", "recompute_wrapper",
           "recompute_sequential", "recompute_hybrid", *_LAZY]
