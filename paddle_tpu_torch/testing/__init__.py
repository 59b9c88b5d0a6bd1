"""Test and chaos helpers of the port (counterpart of
``paddle_tpu/testing``)."""

from .chaos import (corrupt_checkpoint, hang_replica,  # noqa: F401
                    kill_at_step, kill_mid_save, kill_replica, nan_batch,
                    nan_injector, spawn_trainer, unhang_replica)

__all__ = ["kill_mid_save", "corrupt_checkpoint", "nan_batch",
           "nan_injector", "kill_at_step", "spawn_trainer", "kill_replica",
           "hang_replica", "unhang_replica"]
