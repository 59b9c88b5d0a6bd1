"""Meta-parallel model wrappers (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/wrappers.py``).

``TensorParallel`` and ``ShardingParallel`` shard the wrapped model over
the current mesh (``parallel.api.shard_layer``, when it is not sharded
yet), run its forward and hand any other attribute to it, so recipes
keep touching the inner model. ``PipelineParallel`` drives a pipeline
model a batch at a time (``train_batch``, ``eval_batch``).
"""

from __future__ import annotations

import torch
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
    """Recipe-facing pipeline runner (reference pipeline_parallel.py:150).

    ``train_batch([inputs, labels], optimizer)`` runs one forward and
    backward, then the optimizer's ``step()``: the model's fused step
    (``loss_and_grads``: 1F1B or FThenB over the pipeline, every stage's
    rank on a pp mesh) when it has one, else the forward's loss (through
    its ``loss_fn`` when it has one) and autograd. On a mesh the batch
    is global (each rank takes its slice) and the optimizer is bound to
    the model's shards first."""

    def __init__(self, layers, hcg=None, strategy=None):
        from ....parallel.pipeline import PipelineLayer
        if not (isinstance(layers, PipelineLayer)
                or hasattr(layers, "loss_and_grads")):
            raise TypeError(
                "PipelineParallel expects a PipelineLayer-derived model "
                "(or one providing loss_and_grads), got "
                f"{type(layers).__name__}")
        super().__init__(layers, hcg, strategy)

    def _local(self, inputs, labels=None):
        plan = mesh_plan_of(self._layers)
        if plan is None:
            return inputs, labels
        b = plan.local_batch({"i": inputs} if labels is None
                             else {"i": inputs, "l": labels})
        return b["i"], b.get("l")

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        """One forward + backward + optimizer step on ``data`` =
        (inputs, labels); returns the loss (detached). ``scaler`` is
        accepted for recipe parity: bf16 training needs no loss
        scaling."""
        from ...sharding import bind_optimizer
        model = self._layers
        inputs, labels = self._local(*data)
        plan = mesh_plan_of(model)
        if plan is not None and optimizer._mesh_plan is not plan:
            bind_optimizer(optimizer, model)
        for p in model.parameters():
            p.grad = None
        if hasattr(model, "loss_and_grads"):
            loss, _ = model.loss_and_grads(inputs, labels)
        else:
            out = model(inputs)
            loss_fn = getattr(model, "loss_fn", None)
            loss = (loss_fn(out, labels) if loss_fn is not None
                    else out if out.dim() == 0 else out.mean())
            loss.backward()
            loss = loss.detach()
        optimizer.step()
        if lr_scheduler is not None and hasattr(lr_scheduler, "step"):
            lr_scheduler.step()
        return loss

    @torch.no_grad()
    def eval_batch(self, data, compute_loss: bool = False):
        """The model's output (logits) on ``data``'s inputs, or with
        ``compute_loss`` and labels its loss; no gradient."""
        pair = isinstance(data, (tuple, list))
        inputs, labels = self._local(data[0] if pair else data,
                                     data[1] if pair and len(data) > 1
                                     else None)
        was_training = self._layers.training
        self._layers.eval()
        try:
            if compute_loss and labels is not None:
                out = self._layers(inputs, labels)
                return out[0] if isinstance(out, tuple) else out
            return self._layers(inputs)
        finally:
            if was_training:
                self._layers.train()


__all__ = ["MetaParallelBase", "TensorParallel", "ShardingParallel",
           "PipelineParallel"]
