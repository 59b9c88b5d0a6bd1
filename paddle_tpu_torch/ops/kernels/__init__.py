"""Hand-written CUDA kernels for Hopper and their launch wrappers.

One wrapper module per TPU kernel file of ``paddle_tpu/ops/pallas/``,
under the same basename; sources live in ``paddle_tpu_torch/csrc/`` and
are built by :mod:`._build` at first use.
"""
