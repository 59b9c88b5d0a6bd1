"""Incubating APIs (counterpart of ``paddle_tpu/incubate``): so far the
optimizer wrappers ``LookAhead`` and ``ModelAverage`` and
``incubate.optimizer`` (with ``functional.minimize_bfgs`` /
``minimize_lbfgs``), and ``incubate.distributed.models.moe`` (the MoE
layer's recipe path). The fused-op surface and the rest come with A.7."""

from . import distributed  # noqa: F401
from . import optimizer  # noqa: F401
from .extras import LookAhead, ModelAverage  # noqa: F401

__all__ = ["distributed", "optimizer", "LookAhead", "ModelAverage"]
