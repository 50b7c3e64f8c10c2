"""Functionals (port of ``paddle_tpu/nn/functional``)."""
from .activation import gelu
from .attention import scaled_dot_product_attention, sdpa_reference_raw
from .norm import layer_norm

__all__ = ["gelu", "scaled_dot_product_attention", "sdpa_reference_raw",
           "layer_norm"]
