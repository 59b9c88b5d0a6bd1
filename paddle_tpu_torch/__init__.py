"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for NVIDIA
Hopper.

The package imports ``torch`` and never ``jax`` or ``paddle_tpu``. Its
entry points run on the CUDA card unless the caller passes
``device="cpu"``. Every TPU kernel on a ported path is a hand-written
CUDA kernel (``paddle_tpu_torch/csrc``) with a plain PyTorch version
beside it, which CPU tensors take.

The device helpers load on first use, so a process that imports only
``serving_fabric.client`` (a client of the front door) never imports
``torch``.
"""

__version__ = "0.1.0"

_DEVICE_NAMES = ("default_device", "device_info", "generator",
                 "resolve_device")


def __getattr__(name):
    if name in _DEVICE_NAMES:
        from . import device
        return getattr(device, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
