"""``distributed.models`` path (counterpart of
``paddle_tpu/distributed/models``): it holds the moe package."""
from . import moe  # noqa: F401
