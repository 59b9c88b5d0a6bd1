"""The ``nn`` subset the Llama serving and training paths use
(counterpart of ``paddle_tpu/nn``). SiLU is
``torch.nn.functional.silu``."""

from . import functional, initializer  # noqa: F401
from .common import RMSNorm  # noqa: F401
