"""Gradient clipping (port of ``paddle_tpu/nn/__init__.py``'s
``ClipGradByNorm`` / ``ClipGradByGlobalNorm`` / ``ClipGradByValue``, which
the optimizers apply to their gradients, and ``paddle_tpu/nn/clip.py``'s
in-place ``clip_grad_norm_``)."""
from __future__ import annotations

import torch


class ClipGradByNorm:
    """Clip each gradient to the L2 norm ``clip_norm``."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm


class ClipGradByGlobalNorm:
    """Scale all gradients together to a global L2 norm of at most
    ``clip_norm``."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = clip_norm


class ClipGradByValue:
    """Clamp every gradient element into [min, max] (min defaults to
    -max)."""

    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm, norm_type=2.0):
    """Global-norm clip of the parameters' ``.grad`` in place; returns the
    norm before clipping."""
    grads = [p.grad for p in parameters if p.grad is not None]
    if not grads:
        return torch.zeros((), dtype=torch.float32)
    if norm_type == float("inf"):
        total = torch.stack([g.abs().max().float() for g in grads]).max()
    else:
        total = torch.stack([(g.abs() ** norm_type).sum().float()
                             for g in grads]).sum() ** (1.0 / norm_type)
    clip_coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    for g in grads:
        g.mul_(clip_coef.to(g.dtype))
    return total
