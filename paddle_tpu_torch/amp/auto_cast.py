"""auto_cast: mixed-precision regions (counterpart of
``paddle_tpu/amp/auto_cast.py``).

A context sets thread-local amp state; the compute-heavy functional ops
consult ``maybe_cast_inputs`` to cast floating inputs to the
low-precision dtype when they are white-listed, while black-listed ops
(norms, losses) keep computing their statistics in fp32. O2 also
expects the model cast, through ``decorate``. The port's one call site
is ``nn.functional.scaled_dot_product_attention`` ("attention"); the
``linear`` and ``conv`` ones come with the rest of ``nn``.
"""

from __future__ import annotations

import contextlib
import threading

import torch

WHITE_LIST = {"conv1d", "conv2d", "conv3d", "einsum", "matmul", "matmul_v2",
              "mul", "linear", "attention", "fused_rope", "bmm"}
BLACK_LIST = {"softmax", "log_softmax", "cross_entropy", "layer_norm",
              "rms_norm", "group_norm", "batch_norm", "exp", "log", "mean",
              "sum", "cumsum"}

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


def _dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype not in _DTYPES:
        raise ValueError(f"amp dtype {dtype!r}: one of {sorted(_DTYPES)}")
    return _DTYPES[dtype]


def white_list():
    return set(WHITE_LIST)


def black_list():
    return set(BLACK_LIST)


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = torch.bfloat16
        self.level = "O1"
        self.white = frozenset(WHITE_LIST)
        self.black = frozenset(BLACK_LIST)


_STATE = _AmpState()


def amp_state() -> _AmpState:
    return _STATE


@contextlib.contextmanager
def auto_cast(enable: bool = True, custom_white_list=None,
              custom_black_list=None, level: str = "O1",
              dtype: str = "bfloat16"):
    """A mixed-precision region on this thread; the lists extend the
    defaults, and the black list wins over the white."""
    dt = _dtype(dtype)             # raises before the state changes
    prev = (_STATE.enabled, _STATE.dtype, _STATE.level, _STATE.white,
            _STATE.black)
    _STATE.enabled = enable
    _STATE.dtype = dt
    _STATE.level = level
    white = set(WHITE_LIST) | set(custom_white_list or ())
    black = set(BLACK_LIST) | set(custom_black_list or ())
    _STATE.white = frozenset(white - black)
    _STATE.black = frozenset(black)
    try:
        yield
    finally:
        (_STATE.enabled, _STATE.dtype, _STATE.level,
         _STATE.white, _STATE.black) = prev


amp_guard = auto_cast


def maybe_cast_inputs(op_name: str, *xs):
    """The inputs, floating ones cast to the amp dtype when inside an
    enabled region and ``op_name`` is white-listed."""
    if not _STATE.enabled or op_name not in _STATE.white:
        return xs
    return tuple(x.to(_STATE.dtype)
                 if isinstance(x, torch.Tensor) and x.is_floating_point()
                 and x.dtype != _STATE.dtype else x
                 for x in xs)


def decorate(models, optimizers=None, level: str = "O2",
             dtype: str = "bfloat16", master_weight=None, save_dtype=None):
    """O2: cast the models' parameters to the amp dtype (the fp32 masters
    live in the optimizer state, ``multi_precision``)."""
    single = not isinstance(models, (list, tuple))
    ms = [models] if single else list(models)
    if level == "O2":
        for m in ms:
            m.to(dtype=_dtype(dtype))
    if optimizers is None:
        return models if single else ms
    return (models if single else ms), optimizers


__all__ = ["auto_cast", "amp_guard", "amp_state", "maybe_cast_inputs",
           "decorate", "white_list", "black_list", "WHITE_LIST",
           "BLACK_LIST"]
