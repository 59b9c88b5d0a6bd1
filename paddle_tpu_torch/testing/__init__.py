"""Test and chaos helpers of the port (counterpart of
``paddle_tpu/testing``)."""

from .chaos import hang_replica, kill_replica, unhang_replica  # noqa: F401

__all__ = ["kill_replica", "hang_replica", "unhang_replica"]
