"""Models of the port (counterpart of ``paddle_tpu/models``)."""

from .llama import (LlamaConfig, LlamaForCausalLM,  # noqa: F401
                    LlamaForCausalLMPipe, LlamaModel)
from .moe_lm import (MoEConfig, MoEDecoderLayer,  # noqa: F401
                     MoEForCausalLM, SharedExpertMLP)
