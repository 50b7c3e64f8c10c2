"""Flash attention: the CUDA kernels ``csrc/flash_fwd.cu`` (forward, kernel
A) and ``csrc/flash_bwd.cu`` (backward: C1 merged, C2 dQ, C3 dK/dV), their
plain PyTorch versions, and the autograd Functions that join them (port of
``paddle_tpu/kernels/flash_attention_pallas.py``: ``_fwd_kernel`` /
``_fwd_kernel_streamed`` and ``_bwd_kernel`` / ``_bwd_dq_kernel`` /
``_bwd_dkv_kernel`` through ``flash_attention_bshd_native`` /
``flash_attention_bshd_with_lse`` and their ``custom_vjp``s).

Tensors are (B, S, H, D), the model's native layout: no transposes.  The
kernels take float32 and bfloat16, S a multiple of 64, S_q == S_k and a
start-aligned causal mask; the forward takes D in {64, 128, 256}, the
backward D in {64, 128}.  q/k/v (and the backward's dO) need dense (H, D)
inner dimensions; their sequence and batch strides are free, so the
model's q/k/v slices of the fused projection go in without a copy.  A dO
whose (H, D) dimensions are not dense is made contiguous first.  Kernel A
streams 64-row K/V tiles at any S, so it is also the counterpart of the
TPU's long-sequence ``_fwd_kernel_streamed``.

A CUDA tensor launches the kernels (or raises); only a CPU tensor takes
the plain versions :func:`_flash_reference` / :func:`_flash_bwd_reference`.
The forward saves what the JAX ``custom_vjp`` saves, (q, k, v, out, lse),
and only when autograd will use it.  ``flash_fwd_launches``,
``flash_bwd_launches``, ``flash_bwd_dq_launches`` and
``flash_bwd_dkv_launches`` count kernel launches.
"""
from __future__ import annotations

import math

import torch

from . import _build
from .flash_attention import _bwd_route

#: kernel launches since import (or since a caller reset them)
flash_fwd_launches = 0
flash_bwd_launches = 0
flash_bwd_dq_launches = 0
flash_bwd_dkv_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128, 256)
BWD_HEAD_DIMS = (64, 128)
_BLOCK = 64


def _flash_reference(q, k, v, causal, scale):
    """Plain f32 softmax attention over (B, S, H, D): returns (out in q's
    dtype, base-e row logsumexp (B, S, H) f32).  The causal mask is
    start-aligned (key t is visible to query s iff t <= s)."""
    qf, kf, vf = q.float(), k.float(), v.float()
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * float(scale)
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        vis = torch.ones((sq, sk), dtype=torch.bool,
                         device=q.device).tril()
        logits = logits.masked_fill(~vis, -1e30)
    lse = torch.logsumexp(logits, dim=-1)                  # (B, H, S)
    p = torch.exp(logits - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)
    return out, lse.transpose(1, 2).contiguous()


def _flash_bwd_reference(q, k, v, out, lse, dout, causal, scale, dlse=None):
    """Plain f32 backward of :func:`_flash_reference`, P recomputed from the
    saved base-e lse (B, S, H) as the kernels do: returns (dq, dk, dv) in
    q/k/v's dtypes.  ``dlse`` is the lse output's cotangent, folded in as
    ``delta - dlse``."""
    qf, kf, vf, of, gf = (t.float() for t in (q, k, v, out, dout))
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * float(scale)
    p = torch.exp(logits - lse.float().transpose(1, 2)[..., None])
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        vis = torch.ones((sq, sk), dtype=torch.bool,
                         device=q.device).tril()
        p = p.masked_fill(~vis, 0.0)
    delta = (gf * of).sum(-1)                              # (B, S, H)
    if dlse is not None:
        delta = delta - dlse.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    ds = p * (dp - delta.transpose(1, 2)[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * float(scale)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * float(scale)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.dim() != 4:
            raise ValueError("flash attention: %s must be a 4-D (B, S, H, D)"
                             " tensor" % name)
        if t.dtype not in _DTYPES:
            raise TypeError("flash attention: %s dtype %s not supported "
                            "(float32 or bfloat16)" % (name, t.dtype))
        if not _dense_head(t):
            raise ValueError("flash attention: %s needs dense (H, D) inner "
                             "dimensions, got strides %s"
                             % (name, tuple(t.stride())))
    if not (q.shape == k.shape == v.shape):
        raise ValueError("flash attention: q/k/v shapes differ: %s %s %s"
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("flash attention: q/k/v dtypes differ")
    if not (q.device == k.device == v.device):
        raise ValueError("flash attention: q/k/v on different devices")
    _b, s, _h, d = q.shape
    if d not in _HEAD_DIMS:
        raise ValueError("flash attention: head_dim %d not in %s"
                         % (d, _HEAD_DIMS))
    if s % _BLOCK:
        raise ValueError("flash attention: sequence length %d is not a "
                         "multiple of %d" % (s, _BLOCK))


def _dense_head(t):
    return t.stride(3) == 1 and t.stride(2) == t.shape[3]


def _launch(q, k, v, causal, scale, want_lse):
    global flash_fwd_launches
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, s, h), dtype=torch.float32, device=q.device)
           if want_lse else None)
    err = _build.library().paddle_flash_fwd_bshd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, s, h, d,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), int(bool(causal)), float(scale),
        _DTYPES[q.dtype], _build.current_stream(q.device))
    _build.check(err, "flash_fwd launch")
    flash_fwd_launches += 1
    return out, lse


def _forward(q, k, v, causal, scale, want_lse):
    """(out, lse or None) from kernel A on a card, the plain version on
    the CPU."""
    if q.device.type == "cpu":
        out, lse = _flash_reference(q, k, v, causal, scale)
        return out, (lse if want_lse else None)
    if q.device.type != "cuda":
        raise ValueError("flash attention: unsupported device %s" % q.device)
    return _launch(q, k, v, causal, scale, want_lse)


def flash_attention_bwd(q, k, v, out, lse, dout, causal, scale, dlse=None,
                        route=None):
    """Gradients (dq, dk, dv) of :func:`flash_attention_bshd_with_lse`'s
    (out, lse) for the cotangents ``dout`` and ``dlse`` (None: zero).
    ``lse`` is the forward's base-e (B, S, H) f32 row logsumexp.

    On a card: ``route=None`` takes the route the JAX package takes at
    this shape (:func:`..flash_attention._bwd_route`): ``"merged"``
    launches C1, ``"split"`` C2 then C3.  A given ``route`` pins it (for
    the kernel checks); it is not a user setting."""
    _check(q, k, v)
    b, s, h, d = q.shape
    given = [("out", out, (b, s, h, d)), ("dout", dout, (b, s, h, d)),
             ("lse", lse, (b, s, h))]
    if dlse is not None:
        given.append(("dlse", dlse, (b, s, h)))
    for name, t, shape in given:
        if tuple(t.shape) != shape or t.device != q.device:
            raise ValueError("flash attention backward: %s must be %s on "
                             "%s, got %s on %s" % (name, shape, q.device,
                                                   tuple(t.shape), t.device))
    if q.device.type == "cpu":
        return _flash_bwd_reference(q, k, v, out, lse, dout, causal, scale,
                                    dlse)
    if q.device.type != "cuda":
        raise ValueError("flash attention: unsupported device %s" % q.device)
    if d not in BWD_HEAD_DIMS:
        raise NotImplementedError(
            "flash attention backward: head_dim %d on a card is not ported "
            "yet (the kernels take %s; ROADMAP.md section B)"
            % (d, BWD_HEAD_DIMS))
    if dout.dtype != q.dtype or lse.dtype != torch.float32:
        raise TypeError("flash attention backward: dout must be %s and lse "
                        "float32" % q.dtype)
    if route is None:
        route = _bwd_route(s, h, d)
    if route not in ("merged", "split"):
        raise ValueError("flash attention backward: route %r is not "
                         "'merged' or 'split'" % (route,))
    if not _dense_head(dout):
        dout = dout.contiguous()
    # delta = rowsum(dO * O) in f32, outside the kernels as in the JAX
    # package (_flash_bwd); the lse cotangent folds in as delta - dlse
    delta = (dout.float() * out.float()).sum(-1)
    if dlse is not None:
        delta = delta - dlse.float()
    args = (q, k, v, dout, lse.contiguous(), delta, causal, scale)
    if route == "merged":
        return _launch_bwd_merged(*args)
    return (_launch_bwd_dq(*args),) + _launch_bwd_dkv(*args)


def _bwd_args(q, k, v, dout, lse, delta, causal, scale):
    """The C entry points' (inputs, shape-and-strides tail) arguments."""
    b, s, h, d = q.shape
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
              lse.data_ptr(), delta.data_ptr())
    tail = (b, s, h, d, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), dout.stride(0), dout.stride(1),
            int(bool(causal)), float(scale), _DTYPES[q.dtype],
            _build.current_stream(q.device))
    return common, tail


def _launch_bwd_merged(q, k, v, dout, lse, delta, causal, scale):
    """C1: (dq, dk, dv); dq summed by atomics in an f32 workspace."""
    global flash_bwd_launches
    common, tail = _bwd_args(q, k, v, dout, lse, delta, causal, scale)
    dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    _build.check(_build.library().paddle_flash_bwd(
        *common, dq_acc.data_ptr(), dk.data_ptr(), dv.data_ptr(), *tail),
        "flash_bwd launch")
    flash_bwd_launches += 1
    return dq_acc.mul_(float(scale)).to(q.dtype), dk, dv


def _launch_bwd_dq(q, k, v, dout, lse, delta, causal, scale):
    """C2: dq."""
    global flash_bwd_dq_launches
    common, tail = _bwd_args(q, k, v, dout, lse, delta, causal, scale)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _build.check(_build.library().paddle_flash_bwd_dq(
        *common, dq.data_ptr(), *tail), "flash_bwd_dq launch")
    flash_bwd_dq_launches += 1
    return dq


def _launch_bwd_dkv(q, k, v, dout, lse, delta, causal, scale):
    """C3: (dk, dv)."""
    global flash_bwd_dkv_launches
    common, tail = _bwd_args(q, k, v, dout, lse, delta, causal, scale)
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    _build.check(_build.library().paddle_flash_bwd_dkv(
        *common, dk.data_ptr(), dv.data_ptr(), *tail), "flash_bwd_dkv launch")
    flash_bwd_dkv_launches += 1
    return dk, dv


class _FlashAttention(torch.autograd.Function):
    """out = attention(q, k, v); saves (q, k, v, out, lse) as the JAX
    ``_flash_vjp_fwd`` does and differentiates through
    :func:`flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = _forward(q, k, v, causal, scale, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                         ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


class _FlashAttentionWithLse(torch.autograd.Function):
    """(out, lse) = attention(q, k, v) with the base-e row logsumexp; the
    lse cotangent folds into the backward as ``delta - dlse``
    (``_flash_lse_vjp_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = _forward(q, k, v, causal, scale, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                         ctx.causal, ctx.scale, dlse=dlse)
        return dq, dk, dv, None, None


def _needs_grad(*ts):
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def flash_attention_bshd_with_lse(q, k, v, causal=False, scale=None):
    """(out, lse): out (B, S, H, D) in q's dtype, lse the base-e row
    logsumexp (B, S, H) f32; differentiable in both."""
    _check(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if _needs_grad(q, k, v):
        return _FlashAttentionWithLse.apply(q, k, v, causal, scale)
    return _forward(q, k, v, causal, scale, True)


def flash_attention_bshd(q, k, v, causal=False, scale=None):
    """q, k, v: (B, S, H, D) -> (B, S, H, D); differentiable."""
    _check(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if _needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, scale)
    return _forward(q, k, v, causal, scale, False)[0]
