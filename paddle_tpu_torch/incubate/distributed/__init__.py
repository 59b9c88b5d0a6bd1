"""``incubate.distributed`` path (counterpart of
``paddle_tpu/incubate/distributed``): the MoE model package."""
from . import models  # noqa: F401
