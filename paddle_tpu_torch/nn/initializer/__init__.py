"""Weight initializers (port of the part of ``paddle_tpu/nn/initializer``
that the layers' defaults use: ``Constant``, ``Normal``,
``XavierNormal``).

Each initializer is a callable ``(shape, dtype=None, generator=None) ->
tensor``, drawn on the CPU from ``generator`` (None: PyTorch's default
generator).  The JAX package draws from its global key stream instead,
so the two give other numbers from one seed and the same distribution.
Fans are the reference's: an (in, out) weight has fan_in = in and
fan_out = out, a vector its length for both.
"""
from __future__ import annotations

import math

import torch

from ...core.dtype import convert_dtype

__all__ = ["Initializer", "Constant", "Normal", "XavierNormal"]


def _fan(shape):
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    # conv kernels: paddle's (out, in, kh, kw) layout
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


def _dtype(dtype):
    return torch.get_default_dtype() if dtype is None else convert_dtype(dtype)


class Initializer:
    def __call__(self, shape, dtype=None, generator=None):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype=None, generator=None):
        return torch.full(tuple(shape), float(self.value),
                          dtype=_dtype(dtype))


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype=None, generator=None):
        out = torch.empty(tuple(shape), dtype=_dtype(dtype))
        return out.normal_(float(self.mean), float(self.std),
                           generator=generator)


class XavierNormal(Initializer):
    """Normal(0, gain * sqrt(2 / (fan_in + fan_out)))."""

    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype=None, generator=None):
        fi, fo = _fan(tuple(shape))
        fi = self.fan_in or fi
        fo = self.fan_out or fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return Normal(0.0, std)(shape, dtype, generator)
