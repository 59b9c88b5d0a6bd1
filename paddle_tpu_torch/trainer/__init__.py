"""The training loop (counterpart of ``paddle_tpu/trainer``)."""

from .trainer import (PEAK_FLOPS, TrainMetrics, Trainer,  # noqa: F401
                      device_peak_flops)
