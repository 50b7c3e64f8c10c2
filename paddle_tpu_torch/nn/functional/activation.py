"""Activations (port of ``paddle_tpu/nn/functional/activation.py``)."""
from __future__ import annotations

import torch.nn.functional as F


def gelu(x, approximate=False):
    """GELU; ``approximate=True`` is the tanh form the GPT MLP uses."""
    return F.gelu(x, approximate="tanh" if approximate else "none")
