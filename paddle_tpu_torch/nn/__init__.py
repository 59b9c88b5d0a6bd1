"""The ``nn`` subset the Llama serving path uses (counterpart of
``paddle_tpu/nn``). SiLU is ``torch.nn.functional.silu``."""

from . import initializer  # noqa: F401
from .common import RMSNorm  # noqa: F401
