"""Linear / Embedding / Dropout (port of ``paddle_tpu/nn/layer/common.py``).

``Linear`` keeps paddle's (in_features, out_features) weight layout, so a
``paddle_tpu`` state dict loads by a plain copy.  Parameters are created
on the CPU and initialised by their owner (the GPT model draws them from
an explicit generator)."""
from __future__ import annotations

import torch
from torch import nn


class Linear(nn.Module):
    """y = x @ W + b with W stored (in_features, out_features)."""

    def __init__(self, in_features, out_features, bias_attr=None):
        super().__init__()
        self.in_features = int(in_features)
        self.out_features = int(out_features)
        self.weight = nn.Parameter(torch.zeros(self.in_features,
                                               self.out_features))
        if bias_attr is False:
            self.bias = None
        else:
            self.bias = nn.Parameter(torch.zeros(self.out_features))

    def forward(self, x):
        y = x @ self.weight
        return y if self.bias is None else y + self.bias

    def extra_repr(self):
        return "in_features=%d, out_features=%d" % (self.in_features,
                                                    self.out_features)


class Embedding(nn.Module):
    """Lookup by int ids in a (num_embeddings, embedding_dim) table.  Ids
    past the table clamp to its last row, as ``jnp`` gathers do in the
    JAX package (a decode step's inactive slots may index one past the
    position table)."""

    def __init__(self, num_embeddings, embedding_dim):
        super().__init__()
        self.num_embeddings = int(num_embeddings)
        self.embedding_dim = int(embedding_dim)
        self.weight = nn.Parameter(torch.zeros(self.num_embeddings,
                                               self.embedding_dim))

    def forward(self, ids):
        ids = ids.clamp(0, self.num_embeddings - 1)
        return torch.nn.functional.embedding(ids, self.weight)

    def extra_repr(self):
        return "%d, %d" % (self.num_embeddings, self.embedding_dim)


class Dropout(nn.Module):
    """Upscale-in-train dropout; the identity in eval mode.  ``generator``
    (None: PyTorch's default generator) draws the masks; a
    ``jit.TrainStep`` sets its own on every module that has the
    attribute."""

    def __init__(self, p=0.5):
        super().__init__()
        self.p = float(p)
        self.generator = None

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.generator,
                          device=x.device) >= self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros_like(x))

    def extra_repr(self):
        return "p=%s" % self.p
