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


def global_norm_sq(grads, groups):
    """The squared global L2 norm over sharded gradients: the squares of
    the shards (``groups[i]`` the group gradient ``i`` is sliced over, or a
    tuple of groups for a tensor-parallel shard that ZeRO slices again)
    are summed over their groups, the replicated gradients (LayerNorms,
    row-parallel biases, position embeddings: None), which every rank
    holds whole, counted once.  Equal to the unsharded norm's square."""
    from ..distributed import collective as _coll
    repl = [g.float().square().sum() for g, grp in zip(grads, groups)
            if grp is None]
    total = torch.stack(repl).sum() if repl else None
    by_group = {}
    for g, grp in zip(grads, groups):
        if grp is not None:
            grps = grp if isinstance(grp, tuple) else (grp,)
            by_group.setdefault(tuple(id(x) for x in grps), (grps, []))[
                1].append(g.float().square().sum())
    for grps, sq in by_group.values():
        part = torch.stack(sq).sum()
        for grp in grps:
            _coll.all_reduce(part, group=grp)
        total = part if total is None else total + part
    return total


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm, norm_type=2.0):
    """Global-norm clip of the parameters' ``.grad`` in place; returns the
    norm before clipping.  Over tensor-parallel shards (parameters that
    ``distributed.parallelize`` sliced carry ``mp_group``) the 2-norm is
    the unsharded one."""
    parameters = [p for p in parameters if p.grad is not None]
    grads = [p.grad for p in parameters]
    if not grads:
        return torch.zeros((), dtype=torch.float32)
    groups = [getattr(p, "mp_group", None) for p in parameters]
    if norm_type == 2.0 and any(g is not None for g in groups):
        total = torch.sqrt(global_norm_sq(grads, groups))
    elif norm_type == float("inf"):
        total = torch.stack([g.abs().max().float() for g in grads]).max()
    else:
        total = torch.stack([(g.abs() ** norm_type).sum().float()
                             for g in grads]).sum() ** (1.0 / norm_type)
    clip_coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    for g in grads:
        g.mul_(clip_coef.to(g.dtype))
    return total
