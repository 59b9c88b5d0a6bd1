"""Mixed precision (counterpart of ``paddle_tpu/amp``): ``auto_cast``
regions, dynamic loss scaling (``GradScaler``) and the numerics
debugging helpers. On the card bf16 needs no loss scaling; the scaler's
fp16 algorithm is kept whole for the API."""

from __future__ import annotations

import torch

from . import debugging  # noqa: F401
from .auto_cast import (amp_guard, amp_state, auto_cast,  # noqa: F401
                        black_list, decorate, white_list)
from .grad_scaler import AmpScaler, GradScaler  # noqa: F401


def _device(device) -> torch.device:
    return torch.device("cuda" if device is None else device)


def is_bfloat16_supported(device=None) -> bool:
    """Whether ``device`` (default the card) computes in bf16: the CPU
    does; a CUDA device from compute capability 8.0 (Ampere) on."""
    dev = _device(device)
    if dev.type == "cpu":
        return True
    if dev.type != "cuda" or not torch.cuda.is_available():
        return False
    return torch.cuda.get_device_capability(dev) >= (8, 0)


def is_float16_supported(device=None) -> bool:
    """Whether ``device`` (default the card) computes in fp16: the CPU
    does; a CUDA device from compute capability 5.3 on."""
    dev = _device(device)
    if dev.type == "cpu":
        return True
    if dev.type != "cuda" or not torch.cuda.is_available():
        return False
    return torch.cuda.get_device_capability(dev) >= (5, 3)
