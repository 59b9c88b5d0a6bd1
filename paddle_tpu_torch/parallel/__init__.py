"""Parallel layers and the device mesh of the port (counterpart of
``paddle_tpu/parallel``): ``mesh`` (HybridMesh over torch.distributed),
``api`` (placements, ``shard_layer``), ``reshard``, ``mp_layers``
(tensor parallelism), ``ring_attention`` and ``ulysses`` (sequence
parallelism), and the Mixture-of-Experts layer (``moe``). Import the
submodules; this package loads none of them."""
