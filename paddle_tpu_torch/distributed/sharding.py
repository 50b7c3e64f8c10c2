"""ZeRO sharded training (port of ``paddle_tpu/distributed/sharding.py``;
reference surface: fleet/meta_parallel/sharding/sharding_stage2.py:43,
sharding_stage3.py:50, python/paddle/distributed/sharding/group_sharded.py
``group_sharded_parallel``).

The JAX package's ZeRO is sharding annotations: ``TrainStep`` places the
optimizer slots (stage 1), the gradients (stage 2) and the parameters
(stage 3) sharded over the ``sdp`` mesh axis, and GSPMD inserts the
reduce-scatters and all-gathers.  The port's is run-time collectives
over the mesh's ``sdp`` group, driven by ``jit.TrainStep(zero_stage=...)``
through :class:`ZeroPartition`:

* each rank owns the slice of each f32 master that :func:`_stage_spec_for`
  picks (the largest dimension the axis divides; a tensor under 4096
  elements, or with no such dimension, stays whole on every rank);
* **stage 1**: a rank keeps only its slice of the optimizer slots.  The
  gradients are averaged as without ZeRO; each rank updates its slice of
  the masters and the updated slices are all-gathered before the write-
  back into the model;
* **stage 2**: as stage 1, but the gradients of the sliced masters are
  reduce-scattered (averaged) onto the slices;
* **stage 3**: the masters also rest as slices between steps.  They are
  all-gathered at the start of the next step (or at ``sync_to_model``),
  written back into the model's parameters, and the full masters freed:
  memory is saved at rest, not during the forward and backward (the JAX
  package's GSPMD gathers each weight where it is used; ROADMAP.md §A5).

:func:`shard_params` and :func:`shard_optimizer_state` are the placement
helpers: the first records each parameter's ZeRO spec (``zero_spec``; the
model's forward keeps its full tensors, as the JAX package's sharded
arrays stay global ones), the second cuts slot tensors to this rank's
slices.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from . import collective as _coll
from . import mesh as _mesh
from .mesh import PartitionSpec

__all__ = ["ZeroPartition", "shard_optimizer_state", "shard_params",
           "ShardingParallel", "group_sharded_parallel",
           "save_group_sharded_model"]

#: group_sharded_parallel's levels and the stages they name
LEVELS = {"os": 1, "os_g": 2, "p_g_os": 3}


def _stage_spec_for(arr, axis: str, min_size=2 ** 12, fixed=()):
    """Shard the largest divisible dim of ``arr`` over ``axis`` (ZeRO
    slicing is layout-free in the reference; the JAX package picks a dim so
    that XLA keeps layouts tileable).  ``fixed`` pins the leading dims to
    the given axis names (pipeline-stacked slots); those dims keep their
    sharding and are excluded from the pick."""
    n = _mesh.axis_size(axis)
    base = list(fixed) + [None] * (arr.ndim - len(fixed))
    numel = int(np.prod(arr.shape)) if arr.ndim else 1
    if n <= 1 or numel < min_size:
        return PartitionSpec(*base) if fixed else PartitionSpec()
    free = [d for d in np.argsort(tuple(arr.shape))[::-1]
            if d >= len(fixed)]
    for d in free:
        if arr.shape[d] % n == 0:
            base[int(d)] = axis
            return PartitionSpec(*base)
    return PartitionSpec(*base) if fixed else PartitionSpec()


def _dim_of(spec, axis):
    """The dimension ``spec`` shards over ``axis``, or None."""
    for d, a in enumerate(tuple(spec)):
        if a == axis:
            return d
    return None


class ZeroPartition:
    """This rank's slices of a set of name-keyed f32 masters over the
    ``axis`` group of the global mesh, for ``TrainStep(zero_stage=...)``:
    the dimension each is cut on (``dims``; None for a tensor every rank
    holds whole), the cuts, and the collectives that move between slices
    and full tensors.

    The JAX step's check comes first: an ``axis`` of size <= 1 on a mesh of
    more than one rank raises ``ValueError`` (the sharding would silently
    be a no-op).  On a mesh of one rank nothing is cut, as in JAX."""

    def __init__(self, params, stage, axis="sdp"):
        mesh = _mesh.ensure_mesh()
        if _mesh.axis_size(axis) <= 1 and mesh.size > 1:
            raise ValueError(
                "zero_stage=%d requested but mesh axis %r has size <= 1 "
                "(mesh axes: %s) — init_mesh({'%s': N, ...}) first or "
                "the sharding would silently be a no-op"
                % (stage, axis, dict(mesh.shape), axis))
        self.stage = int(stage)
        self.axis = axis
        self.group = _coll._resolve(axis) if axis in mesh.shape else None
        n = self.group.nranks if self.group is not None else 1
        self.rank = self.group.rank if self.group is not None else 0
        self.dims = {}
        for name, t in params.items():
            d = _dim_of(_stage_spec_for(t, axis), axis)
            self.dims[name] = d if self.group is not None and n > 1 else None
        self.nranks = n

    def sliced(self, name):
        return self.dims.get(name) is not None

    def cut(self, name, t):
        """This rank's slice of the full ``t`` (a view)."""
        d = self.dims.get(name)
        if d is None:
            return t
        size = int(t.shape[d]) // self.nranks
        return t.narrow(d, self.rank * size, size)

    def cut_all(self, tree):
        return {n: self.cut(n, t) for n, t in tree.items()}

    def gather(self, name, t):
        """The full tensor from every rank's slice ``t`` (a collective
        over the group)."""
        d = self.dims.get(name)
        if d is None:
            return t
        parts = _coll.all_gather([], t.contiguous(), group=self.group)
        return torch.cat(parts, dim=d)

    def reduce_scatter(self, name, g):
        """This rank's slice of the average of every rank's full ``g``:
        one reduce-scatter over the group (along dim 0 of ``g`` with its
        cut dimension moved first)."""
        d = self.dims[name]
        moved = torch.movedim(g, d, 0).contiguous()
        _coll.reduce_scatter(moved, op=_coll.ReduceOp.AVG, group=self.group)
        return torch.movedim(moved, 0, d).contiguous()


def shard_optimizer_state(opt_state, axis="sdp"):
    """Stage 1: each slot tensor cut to this rank's slice over ``axis``
    by :func:`_stage_spec_for` (0-d slots, and those it leaves whole,
    stay whole)."""
    group = _coll._resolve(axis)
    if group is None or group.nranks < 2:
        return opt_state

    def place(x):
        if isinstance(x, torch.Tensor) and x.ndim > 0:
            d = _dim_of(_stage_spec_for(x, axis), axis)
            if d is not None:
                size = int(x.shape[d]) // group.nranks
                return x.narrow(d, group.rank * size, size).clone()
        return x

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return place(t)
    return walk(opt_state)


def shard_params(model: nn.Module, axis="sdp"):
    """Stage 3: record each parameter's ZeRO placement as ``zero_spec``.
    The model keeps its full tensors (the JAX package's sharded arrays
    stay global ones); ``TrainStep(zero_stage=3)`` holds the slices."""
    for _, p in model.named_parameters():
        p.zero_spec = _stage_spec_for(p, axis)
    return model


class ShardingParallel(nn.Module):
    """Model wrapper for the sharding mode (fleet dispatch target)."""

    def __init__(self, layers, hcg=None, strategy=None):
        super().__init__()
        self._layers = layers
        stage = 1
        if strategy is not None:
            stage = strategy.sharding_configs.stage
        if stage >= 3:
            shard_params(layers)

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)


def group_sharded_parallel(model, optimizer, level="os_g", scaler=None,
                           group=None, offload=False, sync_buffers=False,
                           buffer_max_size=2 ** 23, segment_size=2 ** 20,
                           sync_comm=False):
    """reference parity: python/paddle/distributed/sharding/group_sharded.py.

    level: "os" (stage 1) | "os_g" (stage 2) | "p_g_os" (stage 3), kept as
    ``model._sharding_level``; the slicing itself is
    ``TrainStep(zero_stage=...)``'s."""
    if level not in LEVELS:
        raise ValueError("group_sharded_parallel: level must be one of %s, "
                         "got %r" % (sorted(LEVELS), level))
    if level in ("p_g_os",):
        shard_params(model)
    model._sharding_level = level
    if scaler is not None:
        return model, optimizer, scaler
    return model, optimizer


def save_group_sharded_model(model, output, optimizer=None):
    """The model's state to ``output + ".pdparams"`` and, given, the
    optimizer's to ``output + ".pdopt"`` (``torch.save``)."""
    torch.save(model.state_dict(), output + ".pdparams")
    if optimizer is not None:
        torch.save(optimizer.state_dict(), output + ".pdopt")
