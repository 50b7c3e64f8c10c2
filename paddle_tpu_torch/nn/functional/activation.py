"""Activations (port of ``paddle_tpu/nn/functional/activation.py``):
plain functions on tensors, with the JAX package's formulas and default
arguments, so values and gradients agree with its functions (``where``
branches as there: the gradient of a kink is the branch's own).  The two
that draw noise, :func:`gumbel_softmax` and :func:`rrelu`, take an
explicit ``torch.Generator`` (None: PyTorch's default one) in place of the
JAX package's global key."""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["relu", "relu6", "elu", "selu", "celu", "gelu", "silu", "swish",
           "mish", "sigmoid", "hardsigmoid", "hardswish", "hardtanh",
           "hardshrink", "softshrink", "tanhshrink", "leaky_relu",
           "log_sigmoid", "softplus", "softsign", "tanh", "thresholded_relu",
           "softmax", "log_softmax", "gumbel_softmax", "prelu", "maxout",
           "glu", "rrelu"]


def _zero(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


def _softplus0(x):
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, _zero(x))


def relu(x):
    return torch.relu(x)


def relu6(x):
    return F.relu6(x)


def elu(x, alpha=1.0):
    # jax.nn.elu: expm1 of a safe input, so the unused branch stays finite
    pos = x > 0
    return torch.where(pos, x, alpha * torch.expm1(torch.where(pos, _zero(x),
                                                               x)))


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def celu(x, alpha=1.0):
    return torch.where(x > 0, x, alpha * torch.expm1(x / alpha))


def gelu(x, approximate=False):
    """GELU; ``approximate=True`` is the tanh form the GPT MLP uses."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def silu(x):
    return x * torch.sigmoid(x)


swish = silu


def mish(x):
    return x * torch.tanh(_softplus0(x))


def sigmoid(x):
    return torch.sigmoid(x)


def hardsigmoid(x, slope=1.0 / 6, offset=0.5):
    return torch.clamp(slope * x + offset, 0.0, 1.0)


def hardswish(x):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def hardtanh(x, min=-1.0, max=1.0):  # noqa: A002  (the JAX names)
    return torch.clamp(x, min, max)


def hardshrink(x, threshold=0.5):
    return torch.where(torch.abs(x) > threshold, x, _zero(x))


def softshrink(x, threshold=0.5):
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, _zero(x)))


def tanhshrink(x):
    return x - torch.tanh(x)


def leaky_relu(x, negative_slope=0.01):
    return torch.where(x >= 0, x, negative_slope * x)


def log_sigmoid(x):
    return -_softplus0(-x)


def softplus(x, beta=1.0, threshold=20.0):
    return torch.where(beta * x > threshold, x,
                       torch.log1p(torch.exp(beta * x)) / beta)


def softsign(x):
    return x / (torch.abs(x) + 1)


def tanh(x):
    return torch.tanh(x)


def thresholded_relu(x, threshold=1.0):
    return torch.where(x > threshold, x, _zero(x))


def _cast(x, dtype):
    if dtype is None:
        return x
    from ...core.dtype import convert_dtype
    return x.to(convert_dtype(dtype))


def softmax(x, axis=-1, dtype=None):
    return torch.softmax(_cast(x, dtype), dim=axis)


def log_softmax(x, axis=-1, dtype=None):
    return torch.log_softmax(_cast(x, dtype), dim=axis)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, generator=None):
    """Softmax of ``(x + g) / temperature`` with Gumbel noise ``g`` drawn
    from ``generator``; ``hard`` gives the one-hot of the argmax with the
    soft sample's gradient (straight-through)."""
    tiny = torch.finfo(x.dtype).tiny
    u = torch.rand(x.shape, generator=generator, dtype=x.dtype,
                   device=x.device)
    g = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
    y = torch.softmax((x + g) / temperature, dim=axis)
    if hard:
        idx = torch.argmax(y, dim=axis, keepdim=True)
        hard_y = torch.zeros_like(y).scatter(axis, idx, 1.0)
        y = hard_y + y - y.detach()
    return y


def prelu(x, weight, data_format="NCHW"):
    w = weight
    if w.ndim == 1 and w.shape[0] > 1 and x.ndim > 2:
        if data_format == "NCHW":
            w = w.reshape((1, -1) + (1,) * (x.ndim - 2))
        else:
            w = w.reshape((1,) * (x.ndim - 1) + (-1,))
    return torch.where(x > 0, x, w * x)


def maxout(x, groups, axis=1):
    axis = axis % x.ndim
    shape = list(x.shape)
    c = shape[axis]
    shape[axis:axis + 1] = [c // groups, groups]
    return torch.amax(x.reshape(shape), dim=axis + 1)


def glu(x, axis=-1):
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


def rrelu(x, lower=1.0 / 8, upper=1.0 / 3, training=True, generator=None):
    """Randomized leaky ReLU: in training each negative element's slope
    is drawn uniformly from [lower, upper) by ``generator``, else it is
    their mean."""
    if training:
        slope = torch.rand(x.shape, generator=generator, dtype=x.dtype,
                           device=x.device) * (upper - lower) + lower
    else:
        slope = (lower + upper) / 2.0
    return torch.where(x >= 0, x, slope * x)
