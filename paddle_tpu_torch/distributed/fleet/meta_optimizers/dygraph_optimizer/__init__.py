"""The dygraph hybrid and sharding optimizer wrappers (counterpart of
``paddle_tpu/distributed/fleet/meta_optimizers/dygraph_optimizer``).

Both delegate the optimizer's whole surface to the wrapped optimizer
(``step``, ``minimize``, ``get_lr``, ``state_dict``, ...); ``step`` also
takes an explicit ``{name: gradient}`` dict, as the JAX wrappers do.

- :class:`HybridParallelOptimizer`: on a mesh the port's optimizer
  already sums each gradient over the ranks that replicate it and clips
  by the global norm (``parallel.api.MeshPlan``), so the wrapper checks
  that the clip is callable and otherwise stays out of the way.
- :class:`DygraphShardingOptimizer`: ZeRO-1 over the ``fsdp`` axis. A
  model sharded over a mesh whose fsdp axis holds the state whole is
  put on the "os" level of ``distributed.sharding`` (each fsdp rank
  keeps the optimizer state of one flat chunk of every parameter,
  updates that chunk from the all-reduced gradient and all-gathers the
  parameter, which stays replicated); a state made before is cut into
  the chunks by ``parallel.api.shard_optimizer_state``. The optimizer
  is bound to the model's plan before it is wrapped
  (``fleet.distributed_optimizer`` or ``distributed.sharding.
  bind_optimizer``). ``reduce_gradients`` is a no-op: the step's
  gradient sum does it.
"""

from __future__ import annotations

from typing import Dict, Optional


class _DelegatingOptimizer:
    def __init__(self, optimizer, hcg=None, strategy=None):
        self._inner_opt = optimizer
        self._hcg = hcg
        self._strategy = strategy

    @property
    def inner_opt(self):
        return self._inner_opt

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "_inner_opt"), name)

    def state_dict(self):
        return self._inner_opt.state_dict()

    def set_state_dict(self, sd):
        return self._inner_opt.set_state_dict(sd)

    def minimize(self, loss=None, startup_program=None, parameters=None,
                 no_grad_set=None, grads=None):
        """``loss.backward()`` then :meth:`step`, or :meth:`step` on
        explicit ``grads``."""
        if grads is None and loss is None:
            raise ValueError("minimize needs a loss to differentiate or "
                             "explicit grads: wrapper.minimize(loss) or "
                             "wrapper.minimize(grads=...)")
        if grads is None:
            loss.backward()
        self.step(grads)
        return None, None

    def step(self, grads: Optional[Dict] = None):
        """One update from the bound parameters' ``.grad``, or from
        ``grads`` (name → gradient, set as those ``.grad`` first)."""
        if grads is not None:
            bound = self._inner_opt._bound_params
            for name, g in grads.items():
                if name not in bound:
                    raise KeyError(f"gradient for {name!r}, which the "
                                   f"optimizer does not update")
                bound[name].grad = g.detach()
        return self._inner_opt.step()


class HybridParallelOptimizer(_DelegatingOptimizer):
    """Counterpart of the JAX wrapper: ``step`` / ``minimize`` delegate;
    the clip must be callable."""

    def __init__(self, optimizer, hcg=None, strategy=None):
        super().__init__(optimizer, hcg, strategy)
        clip = getattr(optimizer, "grad_clip", None)
        if clip is not None and not callable(clip):
            raise TypeError(
                f"optimizer.grad_clip must be callable, got {type(clip)}")


class DygraphShardingOptimizer(_DelegatingOptimizer):
    """ZeRO-1 (module docstring): the optimizer state sharded over
    ``fsdp``, the parameters replicated after every step."""

    def __init__(self, optimizer, hcg=None, strategy=None):
        super().__init__(optimizer, hcg, strategy)
        self._shard_state()

    def step(self, grads: Optional[Dict] = None):
        self._shard_state()
        return super().step(grads)

    def _shard_state(self) -> None:
        """Put the optimizer's bound plan on the "os" level when its mesh
        has an fsdp axis over 1 that holds the state whole, cutting a
        state made before into this rank's chunks."""
        from .....parallel.api import shard_optimizer_state
        from .....parallel.mesh import current_mesh
        opt = self._inner_opt
        plan = opt._mesh_plan
        if plan is None:
            hm = current_mesh()
            if hm is not None and hm.axis_size("fsdp") > 1:
                raise RuntimeError(
                    "DygraphShardingOptimizer: bind the optimizer to the "
                    "sharded model first (fleet.distributed_model and "
                    "fleet.distributed_optimizer, or shard_layer and "
                    "distributed.sharding.bind_optimizer)")
            return
        if plan.level == "none" and plan.mesh.axis_size("fsdp") > 1:
            plan.level = "os"
            if opt._state is not None:
                opt._state = shard_optimizer_state(opt._state, plan)

    def reduce_gradients(self, parameter_list=None, hcg=None):
        """No-op: the step sums the gradients over the mesh."""
        return None


__all__ = ["HybridParallelOptimizer", "DygraphShardingOptimizer"]
