"""Parallel layers of the port (counterpart of ``paddle_tpu/parallel``):
the Mixture-of-Experts layer."""
