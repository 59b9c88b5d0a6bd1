"""Parallel layers and the device mesh of the port (counterpart of
``paddle_tpu/parallel``): ``mesh`` (HybridMesh over torch.distributed),
``api`` (placements, ``shard_layer``), ``reshard``, ``mp_layers``
(tensor parallelism), ``ring_attention`` and ``ulysses`` (sequence
parallelism), the Mixture-of-Experts layer (``moe``), pipeline
parallelism (``pipeline``, ``schedules``), the memory fit (``scale``)
and the many-card projection (``projection``). Import the submodules;
this package loads none of them."""
