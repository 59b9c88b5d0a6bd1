"""Serving of the port (counterpart of ``paddle_tpu/inference``)."""

from .generation import GenerationConfig  # noqa: F401
from .serving import ContinuousBatchingEngine  # noqa: F401
