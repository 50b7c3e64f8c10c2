"""The nn subset the GPT path uses (port of ``paddle_tpu/nn``)."""
from . import functional
from .layer.common import Dropout, Embedding, Linear
from .layer.norm import LayerNorm

__all__ = ["functional", "Dropout", "Embedding", "Linear", "LayerNorm"]
