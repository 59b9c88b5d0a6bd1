"""Incubating APIs (counterpart of ``paddle_tpu/incubate``): so far the
optimizer wrappers ``LookAhead`` and ``ModelAverage`` and
``incubate.optimizer`` (with ``functional.minimize_bfgs`` /
``minimize_lbfgs``). The fused-op surface and the rest come with A.7."""

from . import optimizer  # noqa: F401
from .extras import LookAhead, ModelAverage  # noqa: F401

__all__ = ["optimizer", "LookAhead", "ModelAverage"]
