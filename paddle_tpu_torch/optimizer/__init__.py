"""Optimizers, gradient clipping and learning-rate schedules of the
training slice (counterpart of ``paddle_tpu/optimizer``)."""

from . import lr  # noqa: F401
from .clip import (ClipGradBase, ClipGradByGlobalNorm,  # noqa: F401
                   ClipGradByNorm, ClipGradByValue)
from .optimizer import (Adam, AdamW, Optimizer,  # noqa: F401
                        place_opt_state)
