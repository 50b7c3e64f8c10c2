"""Flash-attention forward: the CUDA kernel ``csrc/flash_fwd.cu`` and its
plain PyTorch version (port of ``paddle_tpu/kernels/flash_attention_pallas.py``
``_fwd_kernel`` through ``flash_attention_bshd_native`` /
``flash_attention_bshd_with_lse``).

Tensors are (B, S, H, D), the model's native layout: no transposes.  The
kernel takes float32 and bfloat16, D in {64, 128, 256}, S a multiple of 64,
S_q == S_k, and a start-aligned causal mask.  q/k/v need dense (H, D)
inner dimensions; their sequence and batch strides are free, so the
model's q/k/v slices of the fused projection go in without a copy.

A CUDA tensor launches the kernel (or raises); only a CPU tensor takes
the plain version :func:`_flash_reference`.  ``flash_fwd_launches`` counts
kernel launches.
"""
from __future__ import annotations

import math

import torch

from . import _build

#: kernel launches since import (or since a caller reset it)
flash_fwd_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128, 256)
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


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.dim() != 4:
            raise ValueError("flash attention: %s must be a 4-D (B, S, H, D)"
                             " tensor" % name)
        if t.dtype not in _DTYPES:
            raise TypeError("flash attention: %s dtype %s not supported "
                            "(float32 or bfloat16)" % (name, t.dtype))
        if t.stride(3) != 1 or t.stride(2) != t.shape[3]:
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


def flash_attention_bshd_with_lse(q, k, v, causal=False, scale=None):
    """(out, lse): out (B, S, H, D) in q's dtype, lse the base-e row
    logsumexp (B, S, H) f32."""
    _check(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return _flash_reference(q, k, v, causal, scale)
    if q.device.type != "cuda":
        raise ValueError("flash attention: unsupported device %s" % q.device)
    return _launch(q, k, v, causal, scale, True)


def flash_attention_bshd(q, k, v, causal=False, scale=None):
    """q, k, v: (B, S, H, D) -> (B, S, H, D)."""
    _check(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return _flash_reference(q, k, v, causal, scale)[0]
    if q.device.type != "cuda":
        raise ValueError("flash attention: unsupported device %s" % q.device)
    return _launch(q, k, v, causal, scale, False)[0]
