"""Meshes of ranks (port of ``paddle_tpu/distributed/mesh.py``).

The JAX package is single-controller: one process holds a
``jax.sharding.Mesh`` of devices, and a mesh axis plays the role of a
communication ring.  The port runs one process per rank on
``torch.distributed``, so a mesh here is a grid of RANKS: ``init_mesh({"dp":
2, "mp": 2})`` lays the world's ranks out in the JAX device order
(row-major over the axes in :data:`AXIS_ORDER`, rank ``r`` standing where
device ``r`` stands) and makes one process group for every slice of the
grid along every axis.  A rank's coordinate names the shard it holds.

Without an initialized process group the world is one rank: a mesh of
size 1 has groups without a process group, and every collective over
them is the identity, as a JAX collective is outside ``shard_map``.

:class:`CommunicateTopology` and :class:`HybridCommunicateGroup` are the
fleet topology's host arithmetic, with the JAX package's values.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import numpy as np
import torch.distributed as dist

# canonical axis order (outer..inner), the JAX package's: data and
# pipeline axes outermost, tensor-parallel axes innermost
AXIS_ORDER = ("dp", "pp", "sdp", "sep", "mp", "ep")

_global_mesh = None


class PartitionSpec(tuple):
    """Per-dimension mesh-axis names of a placement (the port of
    ``jax.sharding.PartitionSpec``): ``PartitionSpec(None, "mp")`` shards
    dimension 1 over the ``mp`` axis and replicates dimension 0."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return "PartitionSpec%s" % (tuple.__repr__(self),)


class NamedSharding:
    """A placement: a :class:`PartitionSpec` over a :class:`Mesh`."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = (spec if isinstance(spec, PartitionSpec)
                     else PartitionSpec(*spec))

    def __repr__(self):
        return "NamedSharding(%r, %r)" % (self.mesh, self.spec)


class Mesh:
    """The world's ranks as a grid with named axes.  ``shape`` maps each
    axis to its size; ``devices`` holds the ranks in the grid (the JAX
    mesh's device array); ``coord`` is this rank's index on each axis
    (None when this rank lies outside a mesh smaller than the world)."""

    def __init__(self, names, sizes, rank):
        self.axis_names = tuple(names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in sizes)))
        self.size = int(np.prod(sizes)) if len(sizes) else 1
        self.devices = np.arange(self.size).reshape(
            tuple(sizes) if len(sizes) else (1,))
        self.rank = int(rank)
        if self.rank < self.size:
            idx = np.unravel_index(self.rank, self.devices.shape)
            self.coord = {a: int(i) for a, i in zip(self.axis_names, idx)}
        else:
            self.coord = None
        self._groups = {}

    def group(self, axis):
        """The :class:`~.collective.Group` of this rank's slice along
        ``axis`` (None for an axis the mesh does not have)."""
        return self._groups.get(axis)

    def axis_rank(self, axis):
        """This rank's index along ``axis`` (0 for an absent axis)."""
        if self.coord is None:
            return 0
        return self.coord.get(axis, 0)

    def __repr__(self):
        return "Mesh(%s)" % (", ".join("%s=%d" % kv
                                       for kv in self.shape.items()),)


def _world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _ordered(axes):
    names = [a for a in AXIS_ORDER if a in axes]
    names += [a for a in axes if a not in AXIS_ORDER]
    return names


def _build(names, sizes):
    """A mesh over the world's first ``prod(sizes)`` ranks with a group for
    every slice along every axis.  Every rank of the world makes every
    group, in one order, as ``torch.distributed.new_group`` asks."""
    from .collective import Group
    rank, world = _world()
    n = int(np.prod(sizes)) if sizes else 1
    if n > world:
        raise ValueError("mesh needs %d devices, have %d (ranks of the "
                         "torch.distributed world)" % (n, world))
    mesh = Mesh(names or ("dp",), sizes or (1,), rank)
    grid = mesh.devices
    initialized = dist.is_available() and dist.is_initialized()
    for ax, name in enumerate(mesh.axis_names):
        moved = np.moveaxis(grid, ax, -1).reshape(-1, grid.shape[ax])
        for row in moved:
            ranks = [int(r) for r in row]
            pg = None
            if initialized:
                pg = (dist.group.WORLD if len(ranks) == world
                      else dist.new_group(ranks))
            if rank in ranks:
                mesh._groups[name] = Group(name, ranks, pg)
    return mesh


def init_mesh(axes: Dict[str, int], devices=None) -> Mesh:
    """Create and install the global mesh.  ``axes`` e.g. ``{"dp": 2,
    "mp": 4}``; their product may not exceed the world size.
    ``devices`` is accepted for the JAX signature and must be None: the
    ranks are the world's."""
    global _global_mesh
    if devices is not None:
        raise ValueError("init_mesh(devices=...): the port's mesh is laid "
                         "over the torch.distributed world's ranks")
    names = _ordered(axes)
    _global_mesh = _build(names, [int(axes[a]) for a in names])
    return _global_mesh


def init_hybrid_mesh(dcn_axes: Dict[str, int], ici_axes: Dict[str, int],
                     devices=None) -> Mesh:
    """The JAX package's multi-slice mesh: ``dcn_axes`` outermost, then
    ``ici_axes``.  The ranks of one host are consecutive, so the DCN axes
    (changing slowest) span hosts and the ICI axes stay within one, as
    the JAX package's row-major fallback lays them out."""
    global _global_mesh
    dcn = _ordered(dcn_axes)
    ici = _ordered(ici_axes)
    overlap = set(dcn) & set(ici)
    if overlap:
        raise ValueError("axes cannot be both DCN and ICI: %s"
                         % sorted(overlap))
    if devices is not None:
        raise ValueError("init_hybrid_mesh(devices=...): the port's mesh "
                         "is laid over the torch.distributed world's ranks")
    _global_mesh = _build(dcn + ici, [int(dcn_axes[a]) for a in dcn]
                          + [int(ici_axes[a]) for a in ici])
    return _global_mesh


def get_mesh() -> Optional[Mesh]:
    return _global_mesh


def set_mesh(mesh):
    global _global_mesh
    _global_mesh = mesh


@contextlib.contextmanager
def mesh_scope(mesh):
    """Install ``mesh`` as the global mesh for the block, then restore the
    previous one."""
    global _global_mesh
    prev = _global_mesh
    _global_mesh = mesh
    try:
        yield mesh
    finally:
        _global_mesh = prev


def ensure_mesh() -> Mesh:
    """The global mesh, made as ``{"dp": world size}`` when there is none
    (the JAX package's ``{"dp": len(jax.devices())}``)."""
    if _global_mesh is None:
        init_mesh({"dp": _world()[1]})
    return _global_mesh


def axis_size(name: str) -> int:
    mesh = get_mesh()
    if mesh is None or name not in mesh.shape:
        return 1
    return mesh.shape[name]


def named_sharding(*spec) -> NamedSharding:
    return NamedSharding(ensure_mesh(), PartitionSpec(*spec))


class CommunicateTopology:
    """reference parity: fleet/base/topology.py:52 — cartesian rank topology
    over named axes."""

    def __init__(self, hybrid_group_names=("data", "pipe", "sharding", "model"),
                 dims=(1, 1, 1, 1)):
        self._names = list(hybrid_group_names)
        self._dims = list(dims)
        self._world = int(np.prod(dims))
        self._coords = list(np.ndindex(*dims))
        self._coord_to_rank = {c: i for i, c in enumerate(self._coords)}

    def get_hybrid_group_names(self):
        return self._names

    def get_dim(self, name):
        return self._dims[self._names.index(name)]

    get_dim_size = get_dim

    def world_size(self):
        return self._world

    def get_rank(self, **kwargs):
        coord = tuple(kwargs[n] for n in self._names)
        return self._coord_to_rank[coord]

    def get_coord(self, rank):
        return self._coords[rank]

    def get_axis_list(self, axis_name, index):
        axis = self._names.index(axis_name)
        return [r for r, c in enumerate(self._coords) if c[axis] == index]

    def get_comm_list(self, axis_name):
        """All groups along axis_name (reference: topology.py get_comm_list)."""
        axis = self._names.index(axis_name)
        other_dims = [d for i, d in enumerate(self._dims) if i != axis]
        groups = []
        for other in np.ndindex(*other_dims):
            group = []
            for k in range(self._dims[axis]):
                coord = list(other)
                coord.insert(axis, k)
                group.append(self._coord_to_rank[tuple(coord)])
            groups.append(group)
        return groups

    def get_rank_from_stage(self, global_rank, **kwargs):
        coord = list(self.get_coord(global_rank))
        for name, idx in kwargs.items():
            coord[self._names.index(name)] = idx
        return self._coord_to_rank[tuple(coord)]


class HybridCommunicateGroup:
    """reference parity: fleet/base/topology.py:133.  Maps the fleet
    nomenclature (dp/pp/sharding/mp groups and ranks within each) onto
    mesh axis names; a group it returns names its axis, so a collective
    given it runs over the global mesh's group of that axis."""

    AXIS_MAP = {"data": "dp", "pipe": "pp", "sharding": "sdp", "model": "mp",
                "sep": "sep", "expert": "ep"}

    def __init__(self, topology: CommunicateTopology, global_rank: int = 0):
        self._topo = topology
        self.global_rank = global_rank
        self.nranks = topology.world_size()
        for name in topology.get_hybrid_group_names():
            setattr(self, f"_{name}_degree", topology.get_dim(name))

    def _coord(self, name):
        return self._topo.get_coord(self.global_rank)[
            self._topo._names.index(name)]

    # data parallel
    def get_data_parallel_rank(self):
        return self._coord("data")

    def get_data_parallel_world_size(self):
        return self._topo.get_dim("data")

    def get_data_parallel_group(self):
        return _AxisGroup("dp", self._topo, "data", self.global_rank)

    def get_data_parallel_group_src_rank(self):
        return self._topo.get_axis_list(
            "data", 0)[0] if self.nranks else 0

    # model (tensor) parallel
    def get_model_parallel_rank(self):
        return self._coord("model")

    def get_model_parallel_world_size(self):
        return self._topo.get_dim("model")

    def get_model_parallel_group(self):
        return _AxisGroup("mp", self._topo, "model", self.global_rank)

    def get_model_parallel_group_src_rank(self):
        return 0

    # pipeline
    def get_stage_id(self):
        return self._coord("pipe")

    def get_pipe_parallel_world_size(self):
        return self._topo.get_dim("pipe")

    def get_pipe_parallel_group(self):
        return _AxisGroup("pp", self._topo, "pipe", self.global_rank)

    # sharding
    def get_sharding_parallel_rank(self):
        return self._coord("sharding")

    def get_sharding_parallel_world_size(self):
        return self._topo.get_dim("sharding")

    def get_sharding_parallel_group(self):
        return _AxisGroup("sdp", self._topo, "sharding", self.global_rank)

    def get_parallel_mode(self):
        if self.get_model_parallel_world_size() > 1 or \
                self.get_pipe_parallel_world_size() > 1:
            return "hybrid"
        if self.get_sharding_parallel_world_size() > 1:
            return "sharding"
        return "data"

    def topology(self):
        return self._topo

    def get_global_rank(self):
        return self.global_rank


class _AxisGroup:
    """A communication group named by one mesh axis (the ring_id
    analogue); ``ranks`` are the topology's ranks of this rank's slice."""

    def __init__(self, axis, topo, topo_name, global_rank):
        self.axis = axis
        self._topo = topo
        self._name = topo_name
        self._global_rank = global_rank
        self.nranks = topo.get_dim(topo_name)
        coord = topo.get_coord(global_rank)
        self.rank = coord[topo._names.index(topo_name)]

    @property
    def world_size(self):
        return self.nranks

    def get_group_rank(self, global_rank):
        coord = self._topo.get_coord(global_rank)
        return coord[self._topo._names.index(self._name)]

    @property
    def ranks(self):
        idx = [i for i, n in enumerate(self._topo._names) if n != self._name]
        my = self._topo.get_coord(self._global_rank)
        return [r for r, c in enumerate(self._topo._coords)
                if all(c[i] == my[i] for i in idx)]
