"""LayerNorm and row softmax: the CUDA kernels ``csrc/layer_norm_fwd.cu``
(forward, kernel B), ``csrc/layer_norm_bwd.cu`` (backward, kernel D) and
``csrc/softmax_fwd.cu`` (kernel F), their plain PyTorch versions and the
autograd Function that joins B and D (port of
``paddle_tpu/kernels/norm_pallas.py``: ``_ln_fwd_kernel`` /
``_ln_bwd_kernel`` through ``layer_norm_pallas`` and its ``custom_vjp``,
and ``_softmax_kernel`` through ``softmax_pallas``).

Rows of x (R, F) normalise with f32 statistics and the one-pass variance
E[x^2] - mean^2 of the TPU kernel; the output keeps x's dtype.  The
kernels take float32 and bfloat16 x (and dO, of x's dtype), float32 or
bfloat16 gamma/beta, a dense x and F a multiple of 8 (the JAX gate asks
F % 128 == 0).  The backward returns dgamma / dbeta in gamma's dtype.

A CUDA tensor launches the kernels (or raises); only a CPU tensor takes
the plain versions :func:`_layer_norm_reference` /
:func:`_layer_norm_bwd_reference`.  :func:`layer_norm` saves what the JAX
``custom_vjp`` saves, (x, gamma, mean, rstd), and only when autograd will
use it.  :func:`softmax_pallas` is forward-only, as in the JAX package.
``layer_norm_fwd_launches``, ``layer_norm_bwd_launches`` and
``softmax_fwd_launches`` count kernel launches.
"""
from __future__ import annotations

import torch

from . import _build

#: kernel launches since import (or since a caller reset them)
layer_norm_fwd_launches = 0
layer_norm_bwd_launches = 0
softmax_fwd_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SOFTMAX_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
DEFAULT_BLOCK_ROWS = 256


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


def _layer_norm_bwd_reference(x, gamma, mean, rstd, dout):
    """Plain LayerNorm backward from the saved row statistics, f32 as in
    ``_ln_bwd_kernel``: returns (dx in x's dtype, dgamma, dbeta in gamma's
    dtype), the parameter grads summed over all rows."""
    xf, do = x.float(), dout.float()
    xhat = (xf - mean[:, None]) * rstd[:, None]
    dxhat = do * gamma.float()[None, :]
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    dx = rstd[:, None] * (dxhat - m1 - xhat * m2)
    return (dx.to(x.dtype), (do * xhat).sum(0).to(gamma.dtype),
            do.sum(0).to(gamma.dtype))


def _check(what, x, gamma, beta=None):
    if not isinstance(x, torch.Tensor) or x.dim() != 2:
        raise ValueError("%s: x must be a 2-D (rows, F) tensor" % what)
    if x.dtype not in _DTYPES:
        raise TypeError("%s: x dtype %s not supported (float32 or "
                        "bfloat16)" % (what, x.dtype))
    if not x.is_contiguous():
        raise ValueError("%s: x must be contiguous" % what)
    f = x.shape[1]
    if f % 8:
        raise ValueError("%s: feature dim %d not a multiple of 8"
                         % (what, f))
    params = [("gamma", gamma)] + ([] if beta is None else [("beta", beta)])
    for name, t in params:
        if t.shape != (f,) or not t.is_contiguous():
            raise ValueError("%s: %s must be a dense (%d,) tensor"
                             % (what, name, f))
        if t.dtype not in _DTYPES:
            raise TypeError("%s: %s dtype %s not supported"
                            % (what, name, t.dtype))
        if t.device != x.device:
            raise ValueError("%s: %s on %s, x on %s"
                             % (what, name, t.device, x.device))
    if beta is not None and gamma.dtype != beta.dtype:
        raise TypeError("%s: gamma and beta dtypes differ" % what)


def layer_norm_fwd(x, gamma, beta, eps=1e-5):
    """x (R, F), gamma/beta (F,) -> (out (R, F), mean (R,), rstd (R,))."""
    global layer_norm_fwd_launches
    _check("layer_norm_fwd", x, gamma, beta)
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


def layer_norm_bwd(x, gamma, mean, rstd, dout):
    """x, dout (R, F), gamma (F,), the forward's f32 mean / rstd (R,) ->
    (dx (R, F) in x's dtype, dgamma (F,), dbeta (F,) in gamma's dtype)."""
    global layer_norm_bwd_launches
    _check("layer_norm_bwd", x, gamma)
    r, f = x.shape
    for name, t in (("mean", mean), ("rstd", rstd)):
        if t.shape != (r,) or t.dtype != torch.float32 or \
                t.device != x.device:
            raise ValueError("layer_norm_bwd: %s must be (%d,) float32 on "
                             "%s" % (name, r, x.device))
    if dout.shape != x.shape or dout.dtype != x.dtype or \
            dout.device != x.device:
        raise ValueError("layer_norm_bwd: dout must match x (%s %s on %s)"
                         % (tuple(x.shape), x.dtype, x.device))
    if x.device.type == "cpu":
        return _layer_norm_bwd_reference(x, gamma, mean, rstd, dout)
    if x.device.type != "cuda":
        raise ValueError("layer_norm_bwd: unsupported device %s" % x.device)
    dout = dout.contiguous()
    if x.data_ptr() % 16 or dout.data_ptr() % 16:
        raise ValueError("layer_norm_bwd: x and dout must be 16-byte "
                         "aligned")
    lib = _build.library()
    parts = lib.paddle_layer_norm_bwd_parts(r)
    part_g = torch.empty((parts, f), dtype=torch.float32, device=x.device)
    part_b = torch.empty_like(part_g)
    dx = torch.empty_like(x)
    dgamma = torch.empty_like(gamma)
    dbeta = torch.empty_like(gamma)
    err = lib.paddle_layer_norm_bwd(
        x.data_ptr(), gamma.data_ptr(), mean.contiguous().data_ptr(),
        rstd.contiguous().data_ptr(), dout.data_ptr(), dx.data_ptr(),
        part_g.data_ptr(), part_b.data_ptr(), dgamma.data_ptr(),
        dbeta.data_ptr(), r, f, _DTYPES[x.dtype], _DTYPES[gamma.dtype],
        _build.current_stream(x.device))
    _build.check(err, "layer_norm_bwd launch")
    layer_norm_bwd_launches += 1
    return dx, dgamma, dbeta


class _LayerNorm(torch.autograd.Function):
    """out = LayerNorm(x2); saves (x, gamma, mean, rstd) as the JAX
    ``_ln_vjp_fwd`` does and differentiates through :func:`layer_norm_bwd`."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        out, mean, rstd = layer_norm_fwd(x, gamma, beta, eps)
        ctx.save_for_backward(x, gamma, mean, rstd)
        return out

    @staticmethod
    def backward(ctx, dout):
        x, gamma, mean, rstd = ctx.saved_tensors
        dx, dgamma, dbeta = layer_norm_bwd(x, gamma, mean, rstd, dout)
        return dx, dgamma, dbeta, None


def layer_norm(x, gamma, beta, eps=1e-5):
    """x (R, F) -> LayerNorm(x) (R, F) through the kernels, differentiable
    in x, gamma and beta."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, gamma, beta)):
        return _LayerNorm.apply(x, gamma, beta, eps)
    return layer_norm_fwd(x, gamma, beta, eps)[0]


def _softmax_reference(x2):
    """Plain softmax over the rows of x2 (N, F): f32 statistics, the
    output in x's dtype."""
    xf = x2.float()
    e = torch.exp(xf - xf.amax(dim=-1, keepdim=True))
    return (e / e.sum(dim=-1, keepdim=True)).to(x2.dtype)


def softmax_pallas(x, block_rows=DEFAULT_BLOCK_ROWS):
    """Numerically stable softmax over the last dim (f32 statistics), in
    x's dtype, through kernel F on a card.  Forward only, as the JAX
    ``softmax_pallas``: with grad enabled and ``x.requires_grad`` it
    raises rather than return an output without a ``grad_fn``.  It takes
    the shapes the JAX function takes (the row-block halving and F %
    128) and raises ``ValueError`` on the others."""
    f = x.shape[-1]
    x2 = x.reshape(-1, f)
    n = x2.shape[0]
    br = min(block_rows, n)
    while br > 8 and n % br:
        br //= 2
    if n % br or f % 128:
        raise ValueError("softmax_pallas: shape (%d, %d) not tileable"
                         % (n, f))
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("softmax_pallas is forward-only (no backward "
                           "kernel, as in the JAX package); call it under "
                           "torch.no_grad() or on a detached tensor")
    if x.dtype not in _SOFTMAX_DTYPES:
        raise TypeError("softmax_pallas: dtype %s not supported (float32, "
                        "bfloat16 or float16)" % x.dtype)
    if x.device.type == "cpu":
        return _softmax_reference(x2).reshape(x.shape)
    if x.device.type != "cuda":
        raise ValueError("softmax_pallas: unsupported device %s" % x.device)
    global softmax_fwd_launches
    x2 = x2.contiguous()
    if x2.data_ptr() % 16:
        raise ValueError("softmax_pallas: x must be 16-byte aligned")
    out = torch.empty_like(x2)
    _build.check(_build.library().paddle_softmax_fwd(
        x2.data_ptr(), out.data_ptr(), n, f, _SOFTMAX_DTYPES[x.dtype],
        _build.current_stream(x.device)), "softmax_fwd launch")
    softmax_fwd_launches += 1
    return out.reshape(x.shape)
