"""Distributed training machinery of the port (counterpart of
``paddle_tpu/distributed``): activation recompute so far."""

from .recompute import recompute, recompute_wrapper, resolve_policy  # noqa: F401
