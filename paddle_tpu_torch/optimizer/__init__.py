"""Optimizers (port of ``paddle_tpu/optimizer``)."""
from . import lr
from .optimizer import Optimizer
from .optimizers import SGD, Adam, AdamW, Momentum

__all__ = ["lr", "Optimizer", "SGD", "Momentum", "Adam", "AdamW"]
