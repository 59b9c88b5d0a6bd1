"""Command-line tools of the port, run as ``python -m
paddle_tpu_torch.tools.<name>`` (counterparts of the JAX package's
``tools/``): ``serve_fabric`` drives a replica pool through the router
from a trace, ``load_test`` drives the front door under load;
``io_probe`` measures the disk, sha256 and pinned-copy rates a
checkpoint depends on."""
