"""Device selection, card description and seeded generators.

The port's entry points run on the CUDA card unless the caller passes
``device="cpu"``. There is no silent move to the CPU: asking for the
default device on a machine without CUDA raises.
"""

from __future__ import annotations

import subprocess

import torch


def default_device() -> str:
    """``"cuda"`` — the port's default. Raises when no card is visible,
    so a caller that meant the CPU has to say so."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' explicitly to run on the CPU")
    return "cuda"


def resolve_device(device=None) -> torch.device:
    """``device`` as given, or :func:`default_device` when None."""
    return torch.device(default_device() if device is None else device)


def device_info() -> str:
    """The card's name and power limit, one line per card, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def generator(seed: int, device=None) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed`` — the
    explicit random stream every initializer in the port draws from."""
    g = torch.Generator(device=resolve_device(device))
    g.manual_seed(int(seed))
    return g


def dtype_of(name) -> torch.dtype:
    """``"bfloat16"``/``"float32"`` or a torch dtype → torch dtype (the
    two types the port's kernels take)."""
    if isinstance(name, torch.dtype):
        return name
    table = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if name not in table:
        raise ValueError(f"unknown dtype {name!r}")
    return table[name]


__all__ = ["default_device", "resolve_device", "device_info", "generator",
           "dtype_of"]
