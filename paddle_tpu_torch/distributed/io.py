"""paddle.distributed.io: save and load a model's persistables
(counterpart of ``paddle_tpu/distributed/io.py``; reference:
python/paddle/distributed/io.py over static programs).

Persistables are a module's state dict (parameters and buffers). Only
rank 0 writes (the reference's ``is_first_worker()`` gating); every rank
may load.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import torch
import torch.distributed as dist

__all__ = ["save_persistables", "load_persistables", "is_persistable"]


def _is_chief() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def _path(dirname: str, filename: Optional[str]) -> str:
    return os.path.join(dirname, filename or "persistables.pdparams")


def save_persistables(executor=None, dirname: str = "", main_program=None,
                      filename: Optional[str] = None) -> None:
    """Save a module's state dict (``main_program`` a module, or a state
    dict itself) to ``dirname/filename`` on rank 0; ``executor`` is
    accepted and not read."""
    state: Any = main_program
    if hasattr(main_program, "state_dict"):
        state = main_program.state_dict()
    if state is None:
        raise ValueError("save_persistables: pass a module or state dict")
    if _is_chief():
        os.makedirs(dirname or ".", exist_ok=True)
        torch.save({k: v.detach().cpu() if torch.is_tensor(v) else v
                    for k, v in state.items()}, _path(dirname, filename))


def load_persistables(executor=None, dirname: str = "", main_program=None,
                      filename: Optional[str] = None):
    """Load what :func:`save_persistables` saved; when ``main_program`` is
    a module its state is set in place (each tensor copied to its
    parameter's device) and the module returned, else the state dict."""
    state = torch.load(_path(dirname, filename), map_location="cpu",
                       weights_only=True)
    if hasattr(main_program, "set_state_dict"):
        main_program.set_state_dict(state)
        return main_program
    if isinstance(main_program, torch.nn.Module):
        main_program.load_state_dict(state)
        return main_program
    return state


def is_persistable(var) -> bool:
    return bool(getattr(var, "persistable", True))
