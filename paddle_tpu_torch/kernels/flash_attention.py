"""Flash-attention dispatch (port of ``paddle_tpu/kernels/flash_attention.py``).

:func:`supported` keeps every shape condition of the JAX gate and its
``PADDLE_TPU_DISABLE_FLASH`` switch, and retargets its platform condition
from "running on a TPU" to "q lies on a card".  The JAX gate's VMEM
budget (``max_supported_seq``) has no counterpart: the CUDA kernels
stream K/V tiles, so any multiple-of-64 length fits.
:func:`_card_bwd_route` picks the backward on a card: bf16 and fp16 take
the split pair (the tensor-core C2 + C3) at every length; f32 takes
:func:`_bwd_route`, which picks it exactly where the JAX package does
(``flash_attention_pallas._resolve_specs``).
"""
from __future__ import annotations

import os

import torch

_DEFAULT_BLOCK_Q = 128

# the JAX package's VMEM budget for the merged backward's full-sequence
# f32 dq scratch (flash_attention_pallas._DQ_SCRATCH_BUDGET)
_DQ_SCRATCH_BUDGET = 4 * 1024 * 1024


def _aligned_groups(h: int, d: int):
    """Head groups whose width hg * d is lane-aligned (% 128) and divides
    h, largest first (flash_attention_pallas._aligned_groups)."""
    out = [hg for hg in (8, 4, 2, 1)
           if h % hg == 0 and (hg * d) % 128 == 0]
    return out or [h]


def _pick_head_group(h: int, d: int, s: int) -> int:
    """The backward's head group (flash_attention_pallas._pick_head_group
    without its environment override): the largest aligned group with
    hg * d <= 256 whose dq scratch fits at this length, else the largest
    with hg * d <= 256."""
    groups = _aligned_groups(h, d)
    for hg in groups:
        if hg * d <= 256 and s * hg * d * 4 <= _DQ_SCRATCH_BUDGET:
            return hg
    for hg in groups:
        if hg * d <= 256:
            return hg
    return groups[-1]


def _bwd_route(s: int, h: int, d: int) -> str:
    """``"merged"`` (kernel C1) or ``"split"`` (C2 + C3): split iff the
    merged kernel's dq scratch would exceed the budget, the rule of
    ``_resolve_specs``, so both packages take the same backward at the
    same shape."""
    hg = _pick_head_group(h, d, s)
    return "split" if s * hg * d * 4 > _DQ_SCRATCH_BUDGET else "merged"


def _card_bwd_route(s: int, h: int, d: int, dtype) -> str:
    """The backward route of a call with ``route=None``: ``"split"`` for
    bf16 and fp16, whose C2 + C3 run on the tensor cores and have no VMEM
    budget to respect (and sum dQ without atomics); f32 keeps the JAX
    package's rule, :func:`_bwd_route`."""
    if dtype in (torch.bfloat16, torch.float16):
        return "split"
    return _bwd_route(s, h, d)


def supported(q, k=None) -> bool:
    """Whether the CUDA kernels apply to (B, S, H, D) query/key.

    Restricted to square self-attention (s_q == s_k, block-aligned): the
    kernel's causal mask is start-aligned, so cross or cached attention
    takes the plain path.  ``PADDLE_TPU_DISABLE_FLASH`` ("1", "true",
    "yes") sends every call to the plain path, as in the JAX gate."""
    if os.getenv("PADDLE_TPU_DISABLE_FLASH", "").lower() in ("1", "true",
                                                             "yes"):
        return False
    if not q.is_cuda or q.dim() != 4:
        return False
    s, d = q.shape[1], q.shape[3]
    if k is not None and k.shape[1] != s:
        return False
    return s % _DEFAULT_BLOCK_Q == 0 and d in (64, 128, 256)


def flash_attention_bshd(q, k, v, causal=False, scale=None):
    """q, k, v: (B, S, H, D) -> (B, S, H, D), native layout."""
    from .flash_attention_cuda import flash_attention_bshd as impl
    return impl(q, k, v, causal=causal, scale=scale)
