"""Attention functionals (port of ``paddle_tpu/nn/functional/attention.py``).

``scaled_dot_product_attention`` routes to the CUDA flash attention
(the flash forward kernels, the backward kernels through its autograd
Function) when :func:`..kernels.flash_attention.supported` holds (a card,
square self-attention, aligned shapes) and to :func:`sdpa_reference_raw`
elsewhere.  Where the global mesh has a ``sep`` group with a process
group (the port's reading of JAX's "the ``sep`` axis is bound in this
trace"), q/k/v are the rank's sequence shards and the call runs
:func:`...distributed.ring_attention.ring_attention` over that group.
"""
from __future__ import annotations

import torch

from ...core.random import before_draw
from ...observability import costs as _costs


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


def _sequence_parallel(q, k, v, m, dropout_p, is_causal, scale):
    """The ``sep`` ring route of :func:`scaled_dot_product_attention`, with
    the JAX version's refusals: what the ring cannot express raises, since
    attending shard by shard would be silently wrong."""
    if dropout_p > 0.0 or q.dim() != 4 or q.shape[1] != k.shape[1]:
        raise NotImplementedError(
            "scaled_dot_product_attention under the 'sep' sequence-parallel "
            "axis supports only dropout-free self-attention (the ring "
            "schedule); disable attention dropout under sequence "
            "parallelism, or pass sequence_parallel=False if the sequence "
            "was already gathered")
    if q.shape[2] % k.shape[2]:
        raise NotImplementedError(
            "grouped-query attention under the 'sep' ring needs q heads "
            "(%d) divisible by k/v heads (%d)" % (q.shape[2], k.shape[2]))
    if m is not None:
        # the ring's contract: an ADDITIVE mask, local q rows x global keys
        if m.dtype == torch.bool:
            raise NotImplementedError(
                "boolean attn_mask under the 'sep' ring is not supported — "
                "pass an additive float mask of shape (..., S_local, "
                "S_global) (its rows are this rank's local q positions)")
        if m.shape[-2] != q.shape[1]:
            raise ValueError(
                "attn_mask rows (%d) must equal the LOCAL sequence shard "
                "(%d) under the 'sep' ring; columns span the GLOBAL key axis"
                % (m.shape[-2], q.shape[1]))
    from ...distributed.ring_attention import ring_attention
    out = ring_attention(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), "sep", causal=is_causal,
                         scale=scale, attn_mask=m)
    return out.transpose(1, 2)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, scale=None, use_flash=True,
                                 generator=None, sequence_parallel="auto"):
    """q/k/v: (batch, seq, heads, head_dim).

    SEQUENCE PARALLELISM: where the global mesh has a ``sep`` group with
    a process group, q/k/v are this rank's contiguous sequence shards and
    attention runs through the ring over that group
    (``distributed.ring_attention``); a configuration the ring cannot
    express (active dropout, cached or cross attention, a boolean mask, a
    mask whose rows are not the local shard) raises.  Pass
    ``sequence_parallel=False`` where the sequence was already gathered.
    Without a ``sep`` group the route is unchanged."""
    if not training:
        dropout_p = 0.0
    if sequence_parallel:
        from ...distributed.collective import bound_group
        if bound_group("sep") is not None:
            return _sequence_parallel(query, key, value, attn_mask,
                                      dropout_p, is_causal, scale)

    def attend(q, k, v):
        if use_flash and attn_mask is None and dropout_p == 0.0:
            from ...kernels import flash_attention as fa
            if fa.supported(q, k):
                return fa.flash_attention_bshd(q, k, v, causal=is_causal,
                                               scale=scale)
        return sdpa_reference_raw(q, k, v, attn_mask, dropout_p,
                                  is_causal, scale, generator)
    if _costs.counting_active() and query.dim() == 4:
        # the flash kernel's work, whichever route runs (observability.
        # costs): the plain route forms the whole S x S product
        b, sq, h, d = query.shape
        fwd, bwd = _costs.attention_flops(b, h, d, sq, key.shape[1],
                                          is_causal)
        return _costs.counted(attend, (query, key, value), fwd, bwd)
    return attend(query, key, value)
