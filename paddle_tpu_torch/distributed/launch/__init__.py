"""paddle_tpu_torch.distributed.launch: the multi-process, multi-host
launcher (counterpart of ``paddle_tpu/distributed/launch``; reference:
python/paddle/distributed/launch/).

One worker process per rank (one a card), started with each rank's
environment; the multi-node tier meets through a membership service on
``torch.distributed.TCPStore`` (:mod:`.master`).

Usage:
    python -m paddle_tpu_torch.distributed.launch --nproc_per_node=4 \\
        train.py ...
"""

from .main import Container, LaunchConfig, Pod, build_pod, launch

__all__ = ["launch", "build_pod", "LaunchConfig", "Pod", "Container"]
