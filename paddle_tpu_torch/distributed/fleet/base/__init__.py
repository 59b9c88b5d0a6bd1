"""``fleet.base`` subpackage path."""
from . import topology  # noqa: F401
