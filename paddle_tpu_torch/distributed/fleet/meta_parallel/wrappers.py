"""Meta-parallel model wrappers (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/wrappers.py``).

``TensorParallel`` and ``ShardingParallel`` shard the wrapped model over
the current mesh (``parallel.api.shard_layer``, when it is not sharded
yet), run its forward and hand any other attribute to it, so recipes
keep touching the inner model. ``PipelineParallel`` waits for the
pipeline schedules (ROADMAP.md A.4b).
"""

from __future__ import annotations

from torch import nn

from ....parallel.api import mesh_plan_of, shard_layer
from ....parallel.mesh import current_mesh


class MetaParallelBase(nn.Module):
    def __init__(self, layers: nn.Module, hcg=None, strategy=None):
        super().__init__()
        self._layers = layers
        self._hcg = hcg
        self._strategy = strategy
        if current_mesh() is not None and mesh_plan_of(layers) is None:
            shard_layer(layers)

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            return getattr(self._modules["_layers"], name)


class TensorParallel(MetaParallelBase):
    """Tensor parallelism over the mesh's ``tp`` axis."""


class ShardingParallel(MetaParallelBase):
    """The wrapped model sharded over the mesh (``fsdp`` through
    ``group_sharded_parallel`` / ``fleet.distributed_model``)."""


class PipelineParallel(MetaParallelBase):
    def __init__(self, layers, hcg=None, strategy=None):
        raise NotImplementedError(
            "PipelineParallel: pipeline schedules come with ROADMAP.md A.4b")


__all__ = ["MetaParallelBase", "TensorParallel", "ShardingParallel",
           "PipelineParallel"]
