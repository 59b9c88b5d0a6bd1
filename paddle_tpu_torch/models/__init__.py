"""Models of the port (counterpart of ``paddle_tpu/models``)."""

from .llama import (LlamaConfig, LlamaForCausalLM,  # noqa: F401
                    LlamaModel)
