"""LayerNorm forward: the CUDA kernel ``csrc/layer_norm_fwd.cu`` and its
plain PyTorch version (port of ``paddle_tpu/kernels/norm_pallas.py``
``_ln_fwd_kernel`` through ``layer_norm_pallas``).

Rows of x (R, F) normalise with f32 statistics and the one-pass variance
E[x^2] - mean^2 of the TPU kernel; the output keeps x's dtype.  The kernel
takes float32 and bfloat16 x, float32 or bfloat16 gamma/beta, a dense x
and F a multiple of 8 (the JAX gate asks F % 128 == 0).

A CUDA tensor launches the kernel (or raises); only a CPU tensor takes
the plain version :func:`_layer_norm_reference`.  ``layer_norm_fwd_launches``
counts kernel launches.
"""
from __future__ import annotations

import torch

from . import _build

#: kernel launches since import (or since a caller reset it)
layer_norm_fwd_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _layer_norm_reference(x, gamma, beta, eps):
    """Plain LayerNorm over the rows of x (R, F), one-pass variance as in
    the TPU kernel: returns (out in x's dtype, mean (R,), rstd (R,))."""
    xf = x.float()
    mean = xf.mean(dim=-1)
    var = (xf * xf).mean(dim=-1) - mean * mean
    rstd = torch.rsqrt(var + eps)
    out = (xf - mean[:, None]) * rstd[:, None]
    out = out * gamma.float()[None, :] + beta.float()[None, :]
    return out.to(x.dtype), mean, rstd


def _check(x, gamma, beta):
    if not isinstance(x, torch.Tensor) or x.dim() != 2:
        raise ValueError("layer_norm_fwd: x must be a 2-D (rows, F) tensor")
    if x.dtype not in _DTYPES:
        raise TypeError("layer_norm_fwd: x dtype %s not supported (float32 "
                        "or bfloat16)" % (x.dtype,))
    if not x.is_contiguous():
        raise ValueError("layer_norm_fwd: x must be contiguous")
    f = x.shape[1]
    if f % 8:
        raise ValueError("layer_norm_fwd: feature dim %d not a multiple of "
                         "8" % f)
    for name, t in (("gamma", gamma), ("beta", beta)):
        if t.shape != (f,) or not t.is_contiguous():
            raise ValueError("layer_norm_fwd: %s must be a dense (%d,) "
                             "tensor" % (name, f))
        if t.dtype not in _DTYPES:
            raise TypeError("layer_norm_fwd: %s dtype %s not supported"
                            % (name, t.dtype))
        if t.device != x.device:
            raise ValueError("layer_norm_fwd: %s on %s, x on %s"
                             % (name, t.device, x.device))
    if gamma.dtype != beta.dtype:
        raise TypeError("layer_norm_fwd: gamma and beta dtypes differ")


def layer_norm_fwd(x, gamma, beta, eps=1e-5):
    """x (R, F), gamma/beta (F,) -> (out (R, F), mean (R,), rstd (R,))."""
    global layer_norm_fwd_launches
    _check(x, gamma, beta)
    if x.device.type == "cpu":
        return _layer_norm_reference(x, gamma, beta, eps)
    if x.device.type != "cuda":
        raise ValueError("layer_norm_fwd: unsupported device %s" % x.device)
    if x.data_ptr() % 16:
        raise ValueError("layer_norm_fwd: x must be 16-byte aligned")
    r, f = x.shape
    out = torch.empty_like(x)
    mean = torch.empty((r,), dtype=torch.float32, device=x.device)
    rstd = torch.empty((r,), dtype=torch.float32, device=x.device)
    err = _build.library().paddle_layer_norm_fwd(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), r, f, float(eps),
        _DTYPES[x.dtype], _DTYPES[gamma.dtype],
        _build.current_stream(x.device))
    _build.check(err, "layer_norm_fwd launch")
    layer_norm_fwd_launches += 1
    return out, mean, rstd
