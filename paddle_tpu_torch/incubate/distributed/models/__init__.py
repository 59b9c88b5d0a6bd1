"""``incubate.distributed.models`` path: the moe package."""
from . import moe  # noqa: F401
