"""Serving quantization of the port (counterpart of the serving part of
``paddle_tpu/quantization``): weight-only int8 conversion of a trained
Llama."""

from .serving import (PROJ_SUFFIXES, int8_config,  # noqa: F401
                      quantize_model, quantize_state_dict)
