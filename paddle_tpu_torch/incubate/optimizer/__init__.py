"""``incubate.optimizer`` (counterpart of
``paddle_tpu/incubate/optimizer``): LookAhead, ModelAverage, LBFGS and
the whole-vector minimizers of ``functional``. The GPU-era wrappers the
JAX package replaced by other designs raise naming the replacement."""

from ...optimizer.lbfgs import LBFGS  # noqa: F401
from ..extras import LookAhead, ModelAverage  # noqa: F401
from . import functional  # noqa: F401

_REPLACED = {
    "PipelineOptimizer": "parallel.pipeline and parallel.schedules (GPipe, "
                         "1F1B, interleaved) under Trainer or "
                         "fleet.meta_parallel.PipelineParallel",
    "GradientMergeOptimizer": "Trainer(accumulate_steps=N)",
    "RecomputeOptimizer": "paddle_tpu_torch.distributed.recompute policies",
    "DistributedFusedLamb": "optimizer.Lamb",
    "LarsMomentumOptimizer": "optimizer.Momentum with lars_coeff knobs",
}


def __getattr__(name):
    if name in _REPLACED:
        raise AttributeError(f"{name} is replaced by {_REPLACED[name]}")
    raise AttributeError(name)


__all__ = ["LookAhead", "ModelAverage", "LBFGS", "functional"]
