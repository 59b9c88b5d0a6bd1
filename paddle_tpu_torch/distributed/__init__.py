"""Distributed training machinery of the port (counterpart of
``paddle_tpu/distributed``): the ``paddle.distributed``-shaped surface
over ``torch.distributed`` — the process-group bootstrap and the device
mesh, the per-rank collectives, the semi-auto API (``shard_tensor``,
``shard_layer``), the hybrid topology, ``DistributedStrategy``,
``fleet``, ``group_sharded_parallel``, activation recompute, the
launcher (``launch``), ``rpc``, the comm/compute ``overlap``, the
``compat`` surface (ProcessMesh, DistModel, object collectives,
``spawn``, ...), the ``auto_tuner``, the distributed ``io`` and
``utils``, the sharding planner (``auto_parallel``) and the elastic
manager (``elastic``).

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
    "save_state_dict": "..checkpoint", "load_state_dict": "..checkpoint",
}
# the compat surface (JAX's distributed/__init__ imports it by name)
_COMPAT = ("ProcessMesh", "DistAttr", "ReduceType", "dtensor_from_fn",
           "unshard_dtensor", "shard_optimizer", "Strategy", "DistModel",
           "to_static", "ParallelEnv", "ParallelMode", "is_available",
           "is_initialized", "destroy_process_group", "get_backend",
           "get_group", "wait", "send", "recv", "alltoall_single",
           "all_gather_object", "broadcast_object_list",
           "scatter_object_list", "gloo_init_parallel_env", "gloo_barrier",
           "gloo_release", "spawn", "split", "InMemoryDataset",
           "QueueDataset", "CountFilterEntry", "ProbabilityEntry",
           "ShowClickEntry")
_LAZY.update({n: ".compat" for n in _COMPAT})
_SUBMODULES = ("fleet", "sharding", "strategy", "topology", "collective",
               "parallel", "communication", "recompute", "watchdog",
               "launch", "overlap", "compat", "rpc", "auto_tuner", "io",
               "utils", "auto_parallel", "elastic")


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name], __name__), name)
    if name in _SUBMODULES:
        return importlib.import_module("." + name, __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["Group", "P2POp", "ReduceOp", "all_gather", "all_reduce",
           "alltoall", "barrier", "batch_isend_irecv", "broadcast", "gather",
           "get_rank", "get_world_size", "irecv", "isend", "new_group",
           "ppermute", "reduce", "reduce_scatter", "scatter", "send_recv",
           "send_to", "stream", "recompute", "recompute_wrapper",
           "recompute_sequential", "recompute_hybrid", *_LAZY]
