"""Ops of the port: plain PyTorch versions and the CUDA kernels behind
them (counterpart of ``paddle_tpu/ops``)."""

from .attention import paged_decode_attention, sdpa_plain  # noqa: F401
from .norm import rms_norm  # noqa: F401
from .rope import apply_rotary_pos_emb, rope_freqs  # noqa: F401
