"""Ops of the port: plain PyTorch versions and the CUDA kernels behind
them (counterpart of ``paddle_tpu/ops``)."""

from .attention import (flash_attention,  # noqa: F401
                        paged_decode_attention, sdpa_plain)
from .norm import rms_norm  # noqa: F401
from .rope import apply_rotary_pos_emb, rope_freqs  # noqa: F401
from .quant import quantized_matmul  # noqa: F401
