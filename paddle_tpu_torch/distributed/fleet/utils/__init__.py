"""``fleet.utils`` subpackage path: activation recompute and the
sequence-parallel utilities."""
from . import sequence_parallel_utils
from ...recompute import recompute

__all__ = ["recompute", "sequence_parallel_utils"]
