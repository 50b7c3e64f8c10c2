"""Functionals (port of ``paddle_tpu/nn/functional``)."""
from . import activation as _activation
from .activation import *  # noqa: F401,F403  (as the JAX package's)
from .attention import scaled_dot_product_attention, sdpa_reference_raw
from .loss import (cross_entropy, nll_loss, softmax_with_cross_entropy,
                   softmax_with_cross_entropy_raw)
from .norm import layer_norm

__all__ = list(_activation.__all__) + [
    "scaled_dot_product_attention", "sdpa_reference_raw", "cross_entropy",
    "nll_loss", "softmax_with_cross_entropy",
    "softmax_with_cross_entropy_raw", "layer_norm"]
