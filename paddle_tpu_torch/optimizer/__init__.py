"""Optimizers, gradient clipping and learning-rate schedules of the
training slice (counterpart of ``paddle_tpu/optimizer``)."""

from . import lr  # noqa: F401
from .clip import (ClipGradBase, ClipGradByGlobalNorm,  # noqa: F401
                   ClipGradByNorm, ClipGradByValue)
from .lbfgs import LBFGS  # noqa: F401
from .optimizer import (SGD, Adadelta, Adagrad, Adam, Adamax,  # noqa: F401
                        AdamW, Lamb, Momentum, Optimizer, RMSProp, Rprop,
                        place_opt_state)
