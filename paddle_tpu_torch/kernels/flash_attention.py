"""Flash-attention dispatch (port of ``paddle_tpu/kernels/flash_attention.py``).

:func:`supported` keeps every shape condition of the JAX gate and
retargets its platform condition from "running on a TPU" to "q lies on a
card".  The JAX gate's VMEM budget (``max_supported_seq``) has no
counterpart: the CUDA kernel streams K/V tiles, so any multiple-of-64
length fits.
"""
from __future__ import annotations

_DEFAULT_BLOCK_Q = 128


def supported(q, k=None) -> bool:
    """Whether the CUDA kernel applies to (B, S, H, D) query/key.

    Restricted to square self-attention (s_q == s_k, block-aligned): the
    kernel's causal mask is start-aligned, so cross or cached attention
    takes the plain path."""
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
