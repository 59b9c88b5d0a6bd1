"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for NVIDIA
Hopper.

The package imports ``torch`` and never ``jax`` or ``paddle_tpu``. Its
entry points run on the CUDA card unless the caller passes
``device="cpu"``. Every TPU kernel on a ported path is a hand-written
CUDA kernel (``paddle_tpu_torch/csrc``) with a plain PyTorch version
beside it, which CPU tensors take.
"""

from .device import (default_device, device_info, generator,  # noqa: F401
                     resolve_device)

__version__ = "0.1.0"
