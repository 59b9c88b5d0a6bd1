"""fleet: the high-level distributed facade (counterpart of
``paddle_tpu/distributed/fleet/__init__.py``).

``fleet.init`` builds the :class:`~paddle_tpu_torch.parallel.mesh.
HybridMesh` of ``strategy.hybrid_configs`` over the process group
(brought up from the environment when it is not yet, NCCL on the card)
and enters it. ``distributed_model`` shards the model over it
(``shard_layer``; sequence parallelism when ``sep`` > 1, with
``strategy.extras["sp_mode"]``; the ``fsdp`` axis at the ZeRO stage of
``strategy.sharding``, stage 3 (FSDP2) by default, as the JAX package
shards parameters over fsdp). ``distributed_optimizer`` binds the
optimizer to the sharded parameters: its ``step()`` then sums each
gradient over the ranks replicating it and clips by the global norm.
``pp_degree`` > 1 builds a mesh with a ``pp`` axis (a pipeline model,
``LlamaForCausalLMPipe``, keeps its stage on each rank; train it
through ``Trainer`` or ``meta_parallel.PipelineParallel``);
``ep_degree`` > 1 carves an expert axis out of the data ranks (the MoE
LM's experts split over it). The strategy's overlap knobs
(``mp_async_allreduce``, ``sharding.comm_overlap``) select nothing: every
mesh step overlaps its collectives (``distributed.overlap``).
"""

from __future__ import annotations

from typing import Optional

import torch.distributed as dist

from ...parallel.api import mesh_plan_of, shard_layer
from ...parallel.mesh import HybridMesh, current_mesh, init_parallel_env
from ..strategy import DistributedStrategy
from ..topology import HybridCommunicateGroup

_strategy: Optional[DistributedStrategy] = None
_hcg: Optional[HybridCommunicateGroup] = None
_mesh: Optional[HybridMesh] = None
_model = None

_STAGES = {1: "os", 2: "os_g", 3: "p_g_os"}


def init(is_collective: bool = True,
         strategy: Optional[DistributedStrategy] = None, role_maker=None,
         devices=None) -> None:
    """Build and enter the hybrid mesh. ``devices`` is the mesh's device
    type (default: the process group's, "cuda" under NCCL);
    ``role_maker`` is accepted and not read (every process is a
    worker)."""
    global _strategy, _hcg, _mesh
    if not is_collective:
        raise NotImplementedError(
            "parameter-server mode is not ported; use collective")
    strategy = strategy or DistributedStrategy()
    hc = strategy.hybrid_configs
    degrees = dict(dp=hc.dp_degree, fsdp=hc.sharding_degree,
                   tp=hc.mp_degree, pp=hc.pp_degree, sep=hc.sep_degree,
                   ep=hc.ep_degree)
    if dist.is_initialized():
        hm = HybridMesh.build(devices=devices, **degrees)
    else:
        hm = init_parallel_env(**degrees)
    stop()
    hm.__enter__()
    _mesh, _strategy, _hcg = hm, strategy, HybridCommunicateGroup(hm)


def stop() -> None:
    """Leave the mesh entered by :func:`init`."""
    global _mesh
    if _mesh is not None:
        _mesh.__exit__(None, None, None)
        _mesh = None


def get_hybrid_communicate_group() -> HybridCommunicateGroup:
    if _hcg is None:
        raise RuntimeError("fleet.init() has not been called")
    return _hcg


def distributed_model(model):
    """Shard ``model`` over the fleet mesh (module docstring); returns
    it."""
    global _model
    from ..sharding import shard_model
    hm = current_mesh()
    if hm is None:
        raise RuntimeError("fleet.init() has not been called")
    strategy = _strategy or DistributedStrategy()
    cfg = getattr(model, "cfg", None)
    if strategy.recompute.enable and hasattr(cfg, "recompute"):
        cfg.recompute = "full"
    if hm.axis_size("sep") > 1 and hasattr(cfg, "sequence_parallel"):
        cfg.sequence_parallel = True
        mode = (strategy.extras or {}).get("sp_mode")
        if mode:
            if mode not in ("ring", "ulysses"):
                raise ValueError(f"strategy sp_mode must be 'ring'|'ulysses',"
                                 f" got {mode!r}")
            cfg.sp_mode = mode
    if mesh_plan_of(model) is None:
        shard_layer(model, hm)
    if hm.axis_size("fsdp") > 1 or strategy.sharding.enable:
        stage = strategy.sharding.stage if strategy.sharding.enable else 3
        shard_model(model, _STAGES[stage], hm)
    _model = model
    return model


def distributed_optimizer(optimizer,
                          strategy: Optional[DistributedStrategy] = None):
    """Bind ``optimizer`` to the model :func:`distributed_model` sharded
    last (its parameters and mesh plan); ``sharding.offload`` keeps the
    state in pinned host memory."""
    from ..sharding import bind_optimizer
    if _model is None:
        raise RuntimeError("fleet.distributed_model(model) first")
    bind_optimizer(optimizer, _model)
    st = strategy or _strategy
    if st is not None and st.sharding.enable and st.sharding.offload:
        optimizer._offload_opt_state = True
    return optimizer


def worker_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def worker_num() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_first_worker() -> bool:
    return worker_index() == 0


from . import base          # noqa: E402
from . import meta_parallel  # noqa: E402
from . import recompute     # noqa: E402
from . import utils         # noqa: E402

__all__ = ["init", "stop", "get_hybrid_communicate_group",
           "distributed_model", "distributed_optimizer", "worker_index",
           "worker_num", "is_first_worker", "DistributedStrategy"]
