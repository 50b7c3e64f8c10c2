"""Linear / Embedding / Dropout (port of ``paddle_tpu/nn/layer/common.py``).

``Linear`` keeps paddle's (in_features, out_features) weight layout, so a
``paddle_tpu`` state dict loads by a plain copy.  Parameters are created
on the CPU with the reference's defaults: weights drawn from
``XavierNormal`` on PyTorch's default generator, biases ``Constant(0.0)``.
An owner may redraw them (the GPT model draws its own from an explicit
generator)."""
from __future__ import annotations

import torch
from torch import nn

from .. import initializer as I


class Linear(nn.Module):
    """y = x @ W + b with W stored (in_features, out_features)."""

    def __init__(self, in_features, out_features, bias_attr=None):
        super().__init__()
        self.in_features = int(in_features)
        self.out_features = int(out_features)
        self.weight = nn.Parameter(I.XavierNormal()(
            (self.in_features, self.out_features)))
        if bias_attr is False:
            self.bias = None
        else:
            self.bias = nn.Parameter(I.Constant(0.0)((self.out_features,)))

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
    position table).  ``padding_idx`` (a negative one counts from the
    end) names a row that starts as zeros and whose lookups return zeros,
    as the reference's."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None):
        super().__init__()
        self.num_embeddings = int(num_embeddings)
        self.embedding_dim = int(embedding_dim)
        self.padding_idx = (padding_idx if padding_idx is None
                            or padding_idx >= 0
                            else self.num_embeddings + int(padding_idx))
        weight = I.XavierNormal()((self.num_embeddings, self.embedding_dim))
        if self.padding_idx is not None:
            weight[self.padding_idx] = 0.0
        self.weight = nn.Parameter(weight)

    def forward(self, ids):
        out = torch.nn.functional.embedding(
            ids.clamp(0, self.num_embeddings - 1), self.weight)
        if self.padding_idx is not None:
            out = torch.where((ids == self.padding_idx)[..., None],
                              torch.zeros((), dtype=out.dtype,
                                          device=out.device), out)
        return out

    def extra_repr(self):
        pad = ("" if self.padding_idx is None
               else ", padding_idx=%d" % self.padding_idx)
        return "%d, %d%s" % (self.num_embeddings, self.embedding_dim, pad)


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
