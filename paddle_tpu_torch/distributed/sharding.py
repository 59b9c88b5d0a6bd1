"""``group_sharded_parallel``: the ZeRO levels over the ``fsdp`` axis
(counterpart of ``paddle_tpu/distributed/sharding.py``).

* ``"os"`` (stage 1): each fsdp rank keeps the optimizer state of one
  flat chunk of every parameter and updates that chunk; the gradients
  are all-reduced whole and the updated chunks all-gathered.
* ``"os_g"`` (stage 2): as ``"os"``, the gradients reduce-scattered into
  the chunks.
* ``"p_g_os"`` (stage 3): FSDP2 (``torch.distributed.fsdp.fully_shard``)
  over the fsdp axis of the mesh: one unit per decoder layer and the
  root, parameters, gradients and optimizer state sharded, the layer's
  parameters gathered just in time. FSDP2 reduce-scatters the gradients
  as SUMS (``set_gradient_divide_factor(1.0)``, all sum reductions): the
  loss is already the global token mean, and an average would divide
  twice. FSDP2 reduces one dtype per unit, so a bf16 model's fp32
  RMSNorm weights are units of their own.

The model must be ``shard_layer``-ed (it is, here, when it is not yet);
the optimizer is re-bound to the parameters FSDP2 puts in place. Build
the ``Trainer`` after this call.
"""

from __future__ import annotations

from torch import nn

from ..parallel.api import mesh_plan_of, shard_layer
from ..parallel.mesh import current_mesh

_LEVELS = ("os", "os_g", "p_g_os")


def _fully_shard(module: nn.Module, mesh) -> None:
    from torch.distributed.fsdp import fully_shard
    fully_shard(module, mesh=mesh)
    module.set_gradient_divide_factor(1.0)
    if hasattr(module, "set_force_sum_reduction_for_comms"):
        module.set_force_sum_reduction_for_comms(True)


def _apply_fsdp2(model: nn.Module, mesh) -> None:
    """One FSDP2 unit per decoder layer and one at the root; a module
    holding parameters of another dtype than its layer's (the fp32
    norms of a bf16 model) becomes a unit of its own first."""
    def odd_units(unit: nn.Module, skip=()) -> None:
        dtypes = [p.dtype for p in unit.parameters()]
        main = max(set(dtypes), key=dtypes.count)
        for m in unit.modules():
            own = list(m.parameters(recurse=False))
            if m is not unit and m not in skip and own and all(
                    p.dtype != main for p in own):
                _fully_shard(m, mesh)
    layers = [m for m in model.modules()
              if type(m).__name__.endswith("DecoderLayer")]
    inner = {m for layer in layers for m in layer.modules()}
    for layer in layers:
        odd_units(layer)
        _fully_shard(layer, mesh)
    odd_units(model, skip=inner)
    _fully_shard(model, mesh)


def group_sharded_parallel(model, optimizer, level: str = "p_g_os",
                           scaler=None, group=None, offload: bool = False,
                           sync_buffers: bool = True, buffer_max_size=None,
                           segment_size=None, sync_comm: bool = False):
    """Shard the model and the optimizer over the current mesh's
    ``fsdp`` axis at ZeRO ``level``; returns (model, optimizer, scaler).
    ``offload`` keeps the optimizer state in pinned host memory (the
    Trainer streams it). FSDP2 runs at every fsdp size, 1 included."""
    if level not in _LEVELS:
        raise ValueError(f"level must be one of {_LEVELS}, got {level!r}")
    hm = current_mesh()
    if hm is None:
        raise RuntimeError("no active mesh: call fleet.init or enter a "
                           "HybridMesh first")
    if offload:
        optimizer._offload_opt_state = True
    shard_model(model, level, hm)
    bind_optimizer(optimizer, model)
    return model, optimizer, scaler


def shard_model(model: nn.Module, level: str, hm) -> None:
    """The model's half of :func:`group_sharded_parallel`:
    ``shard_layer`` when the model is not sharded yet, then FSDP2
    ("p_g_os") or the chunked optimizer levels recorded on its plan."""
    plan = mesh_plan_of(model)
    if plan is None:
        shard_layer(model, hm)
        plan = mesh_plan_of(model)
    if plan.level != "none":
        raise RuntimeError(f"the model is already sharded at level "
                           f"{plan.level!r}")
    if level == "p_g_os":
        _apply_fsdp2(model, hm.device_mesh["fsdp"])
        plan.level = "fsdp2"
    else:
        plan.level = level
    plan.params = dict(model.named_parameters())


def bind_optimizer(optimizer, model: nn.Module) -> None:
    """Bind ``optimizer`` to the model's current parameters (FSDP2
    replaces them) and its mesh plan; a state made before is dropped."""
    plan = mesh_plan_of(model)
    optimizer._bound_params = {n: p for n, p in plan.params.items()
                               if p.requires_grad}
    optimizer._state = None
    optimizer._mesh_plan = plan


def save_group_sharded_model(model, output, optimizer=None) -> None:
    """A sharded state needs the plan-aware save (ROADMAP.md A.5)."""
    raise NotImplementedError(
        "saving a sharded model waits for the plan-aware save (ROADMAP.md "
        "A.5); gather it with parallel.api.full_state_dict first")


__all__ = ["group_sharded_parallel", "save_group_sharded_model"]
