"""Decode attention — length-masked attention over the slotted cache
(port of ``paddle_tpu/kernels/decode_attention.py`` ``decode_attention``
with its default ``masked`` variant).

The JAX function is plain ``jnp`` (no Pallas kernel), so the port is
plain PyTorch.  Query offset ``j`` of a slot with pre-append length ``n``
attends keys ``t <= n + j``.  As in the JAX version, both products read
the input dtype with f32 accumulation (the operands are widened to f32,
which is exact), the softmax statistics are f32, and ``p`` is cast back
to the input dtype before the second product.  The autotuned chunked and
int8/fp8 variants are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import math

import torch

_NEG_INF = -1e30


def _scale(scale, d):
    return 1.0 / math.sqrt(float(d)) if scale is None else float(scale)


def _masked(q, k, v, pos, scale):
    """One-shot masked softmax attention (f32 statistics)."""
    s, t = q.shape[1], k.shape[1]
    # (B, s, H, D) x (B, T, H, D) -> (B, H, s, T), f32 accumulation
    logits = torch.einsum("bqhd,bthd->bhqt", q.float(), k.float())
    logits = logits * _scale(scale, q.shape[-1])
    t_ids = torch.arange(t, dtype=torch.int32, device=q.device)
    q_pos = pos[:, None] + torch.arange(s, dtype=torch.int32,
                                        device=q.device)[None, :]
    valid = t_ids[None, None, None, :] <= q_pos[:, None, :, None]
    logits = logits.masked_fill(~valid, _NEG_INF)
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhqt,bthd->bqhd", p.float(), v.float())
    return out.to(q.dtype)


def decode_attention(q, k, v, lengths, scale=None):
    """Length-masked attention for the slotted decode step.

    q: (slots, s, heads, d); k/v: (slots, max_len, heads, d); lengths:
    (slots,) int32 — each slot's PRE-append valid length (the new rows
    were already written at [lengths, lengths + s))."""
    return _masked(q, k, v, lengths, scale)
