"""Attention functionals (port of ``paddle_tpu/nn/functional/attention.py``).

``scaled_dot_product_attention`` routes to the CUDA flash attention
(kernel A forward, the backward kernels through its autograd Function)
when :func:`..kernels.flash_attention.supported` holds (a card, square
self-attention, aligned shapes) and to :func:`sdpa_reference_raw`
elsewhere.  The ``'sep'`` sequence-parallel ring is not ported yet.
"""
from __future__ import annotations

import math

import torch


def sdpa_reference_raw(q, k, v, attn_mask=None, dropout_p=0.0,
                       is_causal=False, scale=None, generator=None):
    """Plain attention over (B, S, H, D).  The products run in the input
    dtype and the softmax in f32, as in the JAX version; the causal mask
    is end-aligned (``tril`` offset ``sk - sq``), which equals the
    start-aligned mask when ``sq == sk``."""
    q_, k_, v_ = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    d = q_.shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.einsum("...qd,...kd->...qk", q_, k_) * s
    if is_causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        causal = torch.ones((sq, sk), dtype=torch.bool,
                            device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~causal, -1e30)
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            logits = logits.masked_fill(~attn_mask, -1e30)
        else:
            logits = logits + attn_mask
    probs = torch.softmax(logits.float(), dim=-1).to(q_.dtype)
    if dropout_p > 0.0:
        keep = torch.rand(probs.shape, generator=generator,
                          device=probs.device) >= dropout_p
        probs = torch.where(keep, probs / (1.0 - dropout_p),
                            torch.zeros((), dtype=probs.dtype,
                                        device=probs.device))
    out = torch.einsum("...qk,...kd->...qd", probs, v_)
    return out.transpose(1, 2)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, scale=None, use_flash=True,
                                 generator=None):
    """q/k/v: (batch, seq, heads, head_dim)."""
    if not training:
        dropout_p = 0.0
    if use_flash and attn_mask is None and dropout_p == 0.0:
        from ...kernels import flash_attention as fa
        if fa.supported(query, key):
            return fa.flash_attention_bshd(query, key, value,
                                           causal=is_causal, scale=scale)
    return sdpa_reference_raw(query, key, value, attn_mask, dropout_p,
                              is_causal, scale, generator)
