"""The nn subset the GPT path uses (port of ``paddle_tpu/nn``)."""
from . import functional, initializer
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_)
from .layer.common import Dropout, Embedding, Linear
from .layer.norm import LayerNorm

__all__ = ["functional", "initializer", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", "clip_grad_norm_", "Dropout", "Embedding",
           "Linear", "LayerNorm"]
