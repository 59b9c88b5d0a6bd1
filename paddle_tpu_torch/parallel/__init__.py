"""Parallel layers and the device mesh of the port (counterpart of
``paddle_tpu/parallel``): ``mesh`` (HybridMesh over torch.distributed),
``api`` (placements, ``shard_layer``), ``reshard``, ``mp_layers``
(tensor parallelism), ``ring_attention`` and ``ulysses`` (sequence
parallelism), the Mixture-of-Experts layer (``moe``), and pipeline
parallelism (``pipeline``, ``schedules``). Import the submodules; this
package loads none of them."""

# the JAX package's modules that wait for ROADMAP.md A.4c
LATER = ("scale", "projection")


def __getattr__(name):
    if name in LATER:
        raise NotImplementedError(
            f"paddle_tpu_torch.parallel.{name} is not ported yet: it comes "
            f"with ROADMAP.md A.4c")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
