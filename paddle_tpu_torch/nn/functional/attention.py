"""Attention functionals (port of ``paddle_tpu/nn/functional/attention.py``).

``scaled_dot_product_attention`` routes to the CUDA flash attention
(the flash forward kernels, the backward kernels through its autograd
Function) when :func:`..kernels.flash_attention.supported` holds (a card,
square self-attention, aligned shapes) and to :func:`sdpa_reference_raw`
elsewhere.  The ``'sep'`` sequence-parallel ring is not ported yet.
"""
from __future__ import annotations

import torch

from ...core.random import before_draw


def _default_scale(d, dtype):
    """``1 / sqrt(d)`` rounded to ``dtype`` at each step, as the JAX
    version's ``1.0 / jnp.sqrt(jnp.asarray(d, dtype))``: formed on the
    host, so the product with the logits runs against the same value in
    any dtype (exact at head dims 16, 64 and 256, not at 32, 96 or 128)."""
    root = torch.sqrt(torch.tensor(float(d), dtype=dtype))
    return float(torch.reciprocal(root))


def sdpa_reference_raw(q, k, v, attn_mask=None, dropout_p=0.0,
                       is_causal=False, scale=None, generator=None):
    """Plain attention over (B, S, H, D), or over (..., S, D) for input
    of another rank, as in the JAX version, which swaps axes only for 4-D
    input.  The products run in the input dtype and the softmax in f32;
    the causal mask is end-aligned (``tril`` offset ``sk - sq``), which
    equals the start-aligned mask when ``sq == sk``.  Masked logits take
    -1e30 in the logits' dtype, as ``jnp.asarray(-1e30, logits.dtype)``
    does: -inf in fp16."""
    bshd = q.dim() == 4
    if bshd:
        q_, k_, v_ = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    else:
        q_, k_, v_ = q, k, v
    d = q_.shape[-1]
    s = scale if scale is not None else _default_scale(d, q_.dtype)
    logits = torch.einsum("...qd,...kd->...qk", q_, k_) * s
    if is_causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        causal = torch.ones((sq, sk), dtype=torch.bool,
                            device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~causal, logits.new_tensor(-1e30))
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            logits = logits.masked_fill(~attn_mask, logits.new_tensor(-1e30))
        else:
            logits = logits + attn_mask
    probs = torch.softmax(logits.float(), dim=-1).to(q_.dtype)
    if dropout_p > 0.0:
        if generator is not None:
            before_draw(generator)
        keep = torch.rand(probs.shape, generator=generator,
                          device=probs.device) >= dropout_p
        probs = torch.where(keep, probs / (1.0 - dropout_p),
                            torch.zeros((), dtype=probs.dtype,
                                        device=probs.device))
    out = torch.einsum("...qk,...kd->...qd", probs, v_)
    return out.transpose(1, 2) if bshd else out


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
