"""Functionals (port of ``paddle_tpu/nn/functional``)."""
from .activation import gelu
from .attention import scaled_dot_product_attention, sdpa_reference_raw
from .loss import cross_entropy, softmax_with_cross_entropy_raw
from .norm import layer_norm

__all__ = ["gelu", "scaled_dot_product_attention", "sdpa_reference_raw",
           "cross_entropy", "softmax_with_cross_entropy_raw", "layer_norm"]
