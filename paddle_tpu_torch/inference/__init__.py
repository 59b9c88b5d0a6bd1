"""Serving of the port (counterpart of ``paddle_tpu/inference``)."""

from .admission import (AdmissionPolicy, SLOAdmissionPolicy,  # noqa: F401
                        VictimInfo)
from . import generation  # noqa: F401
from .generation import GenerationConfig, generate  # noqa: F401
from .prefix_cache import PrefixLock, RadixPrefixCache  # noqa: F401
from .serving import ContinuousBatchingEngine  # noqa: F401
from .speculative import DraftProvider, NgramDraftProvider  # noqa: F401
