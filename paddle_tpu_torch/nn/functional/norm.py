"""Normalization functionals (port of ``paddle_tpu/nn/functional/norm.py``).

``layer_norm`` computes its statistics in f32 and casts the output back
to the input dtype.  Under ``FLAGS_use_pallas_norm`` it routes through the
CUDA LayerNorm kernels (``kernels/norm_cuda.py``: the forward, and the
backward through its autograd Function) with the JAX package's
shape gate: one normalized axis, weight and bias present, last dim % 128
== 0 and rows % 8 == 0.  The kernel uses the one-pass variance
E[x^2] - mean^2 of the TPU kernel, while the default path uses the
two-pass E[(x - mean)^2]; in f32 the two agree to ~1e-6 on unit-scale
activations.
"""
from __future__ import annotations

import torch

from ...observability import costs as _costs
from ...utils.flags import fast_get


def _normalized_axes(normalized_shape):
    if isinstance(normalized_shape, (list, tuple)):
        return len(normalized_shape)
    return 1


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    if _costs.counting_active():
        # kernels B and D's work, whichever route runs (observability.costs)
        fwd, bwd = _costs.layer_norm_flops(x.numel())
        return _costs.counted(
            lambda x_, w_, b_: _layer_norm(x_, normalized_shape, w_, b_,
                                           epsilon),
            (x, weight, bias), fwd, bwd)
    return _layer_norm(x, normalized_shape, weight, bias, epsilon)


def _layer_norm(x, normalized_shape, weight, bias, epsilon):
    n_axes = _normalized_axes(normalized_shape)
    if fast_get("use_pallas_norm") and n_axes == 1 and weight is not None \
            and bias is not None and x.shape[-1] % 128 == 0:
        rows = x.numel() // x.shape[-1]
        if rows % 8 == 0:
            from ...kernels.norm_cuda import layer_norm as kernel_ln
            f = x.shape[-1]
            out = kernel_ln(x.reshape(-1, f).contiguous(), weight, bias,
                            epsilon)
            return out.reshape(x.shape)
    axes = tuple(range(x.dim() - n_axes, x.dim()))
    xf = x.float()
    mean = xf.mean(dim=axes, keepdim=True)
    var = (xf - mean).square().mean(dim=axes, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + epsilon)
    if weight is not None:
        out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)
