"""The parallel environment and parameter placement (port of
``paddle_tpu/distributed/parallel_base.py``).

``init_parallel_env`` starts the ``torch.distributed`` world (NCCL unless
the caller asks for another backend: gloo on the CPU) and installs the
global mesh (:mod:`.mesh`).  Where the JAX package places a global array
by a ``PartitionSpec``, every rank here holds the global value and keeps
the slice its mesh coordinate names (:func:`shard_tensor`,
:func:`parallelize`); gathering the slices of every rank
(:func:`unshard_state`) gives the global array back.

A parameter may carry ``mp_parts`` beside its ``pspec``: the sharded
dimension is the concatenation of that many equal parts (the fused q/k/v
projection's columns are [q | k | v]), and a rank keeps its slice of
EACH part, so rank ``r`` of ``mp`` holds the q, k and v columns of its
own heads.  (The JAX package cuts the fused axis contiguously and lets
GSPMD re-deal it to heads behind the scenes.)
"""
from __future__ import annotations

import os
import socket

import numpy as np
import torch
import torch.distributed as dist

from ..nn.parallel import DataParallel  # noqa: F401  (re-export)
from . import collective as _coll
from . import mesh as _mesh
from .mesh import PartitionSpec

__all__ = ["ParallelEnv", "init_parallel_env", "get_rank", "get_world_size",
           "is_initialized", "shard_tensor", "parallelize",
           "shard_dataloader", "shard_slice", "unshard_slices",
           "unshard_state", "local_rows", "shard_module", "reshard_into",
           "DataParallel"]


class ParallelEnv:
    """reference parity: fluid/dygraph/parallel.py:76 — the environment's
    view of the cluster (``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
    ``PADDLE_TRAINER_ENDPOINTS``, ``PADDLE_CURRENT_ENDPOINT``), falling
    back to the initialized world."""

    def __init__(self):
        rank, world = _mesh._world()
        self._rank = int(os.getenv("PADDLE_TRAINER_ID", str(rank)))
        self._world_size = int(os.getenv("PADDLE_TRAINERS_NUM", str(world)))
        self._device_id = _local_rank(self._rank)
        self._trainer_endpoints = os.getenv("PADDLE_TRAINER_ENDPOINTS",
                                            "").split(",")
        self._current_endpoint = os.getenv("PADDLE_CURRENT_ENDPOINT", "")

    @property
    def rank(self):
        return self._rank

    @property
    def world_size(self):
        return self._world_size

    @property
    def device_id(self):
        return self._device_id

    @property
    def trainer_endpoints(self):
        return self._trainer_endpoints

    @property
    def current_endpoint(self):
        return self._current_endpoint

    local_rank = rank
    nranks = world_size


def _local_rank(rank):
    """The rank's card on its host: ``PADDLE_LOCAL_RANK`` or
    ``LOCAL_RANK``, else the rank modulo the host's card count."""
    env = os.getenv("PADDLE_LOCAL_RANK") or os.getenv("LOCAL_RANK")
    if env is not None:
        return int(env)
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return int(rank) % n if n else 0


def _free_port():
    s = socket.socket()
    try:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
    finally:
        s.close()


def init_parallel_env(backend=None, mesh_axes=None, device=None):
    """Start the world and install the global mesh; returns a
    :class:`ParallelEnv`.

    ``backend`` defaults to NCCL, whose rank then works on card
    ``local rank`` (``core.device.resolve_device(None)`` resolves there);
    a CPU run passes ``backend="gloo", device="cpu"``.  Nothing picks a
    backend or a device by itself.  Rendezvous: ``PADDLE_MASTER``
    (host:port) or ``MASTER_ADDR`` / ``MASTER_PORT``; the rank is
    ``PADDLE_TRAINER_ID`` (or ``RANK``), the world size
    ``PADDLE_TRAINERS_NUM`` (or ``WORLD_SIZE``).  A world of one without
    an address meets on a free port of 127.0.0.1.  ``mesh_axes``
    (``{"dp": 2, "mp": 2}``) lays the ranks out; without it the mesh is
    ``{"dp": world size}``."""
    backend = backend or "nccl"
    if backend == "nccl" and device is not None \
            and torch.device(device).type != "cuda":
        raise ValueError("the nccl backend runs on cards; pass "
                         "backend='gloo' for device=%r" % (device,))
    if not dist.is_initialized():
        rank = int(os.getenv("PADDLE_TRAINER_ID", os.getenv("RANK", "0")))
        world = int(os.getenv("PADDLE_TRAINERS_NUM",
                              os.getenv("WORLD_SIZE", "1")))
        master = os.getenv("PADDLE_MASTER")
        if not master and os.getenv("MASTER_ADDR"):
            master = "%s:%s" % (os.getenv("MASTER_ADDR"),
                                os.getenv("MASTER_PORT", "29500"))
        if not master:
            if world > 1:
                raise ValueError(
                    "init_parallel_env: a world of %d ranks needs an "
                    "address (PADDLE_MASTER=host:port or MASTER_ADDR / "
                    "MASTER_PORT)" % world)
            master = "127.0.0.1:%d" % _free_port()
        if backend == "nccl":
            if not torch.cuda.is_available():
                raise RuntimeError("the nccl backend needs a CUDA device; "
                                   "pass backend='gloo', device='cpu'")
            torch.cuda.set_device(_local_rank(rank))
        dist.init_process_group(backend, init_method="tcp://" + master,
                                rank=rank, world_size=world)
    if mesh_axes:
        _mesh.init_mesh(mesh_axes)
    else:
        _mesh.ensure_mesh()
    return ParallelEnv()


def get_rank(group=None):
    """This process's rank in the world, or in ``group`` when given."""
    if group is not None:
        g = _coll._resolve(group)
        return 0 if g is None else g.rank
    return _mesh._world()[0]


def get_world_size(group=None):
    return _coll.get_world_size(group)


def is_initialized():
    return dist.is_available() and dist.is_initialized()


# -- placement ---------------------------------------------------------------

def _cat(parts, dim):
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts, dim)
    return np.concatenate(parts, dim)


def _narrow(x, dim, start, size):
    idx = (slice(None),) * dim + (slice(start, start + size),)
    return x[idx]


def shard_slice(x, spec, coords, sizes, parts=1):
    """The slice of the global ``x`` (a tensor or a numpy array) that the
    rank at ``coords`` ({axis: index}) keeps under ``spec``: each
    dimension named by an axis of size > 1 is cut into ``sizes[axis]``
    pieces, each of its ``parts`` equal parts alike (the dealing rule of
    the module docstring)."""
    for dim, axis in enumerate(tuple(spec or ())):
        if axis is None:
            continue
        axes = axis if isinstance(axis, (tuple, list)) else (axis,)
        n_dev = int(np.prod([sizes.get(a, 1) for a in axes]))
        if n_dev == 1:
            continue
        idx = 0
        for a in axes:
            idx = idx * sizes.get(a, 1) + coords.get(a, 0)
        n = int(x.shape[dim])
        if n % (parts * n_dev):
            raise ValueError("dimension %d of size %d does not divide "
                             "into %d parts of %d shards"
                             % (dim, n, parts, n_dev))
        part, piece = n // parts, n // (parts * n_dev)
        x = _cat([_narrow(x, dim, p * part + idx * piece, piece)
                  for p in range(parts)], dim)
    return x


def unshard_slices(shards, dim, parts=1):
    """Inverse of :func:`shard_slice` along one dimension: ``shards`` are
    the ranks' slices in rank order."""
    n_dev = len(shards)
    if n_dev == 1:
        return shards[0]
    piece = int(shards[0].shape[dim]) // parts
    return _cat([_narrow(s, dim, p * piece, piece)
                 for p in range(parts) for s in shards], dim)


def _mesh_sizes(mesh):
    return dict(mesh.shape), dict(mesh.coord or {})


def _as_spec(spec):
    if spec is None:
        return PartitionSpec()
    if isinstance(spec, PartitionSpec):
        return spec
    return PartitionSpec(*spec)


def shard_tensor(x, mesh=None, placement=None, process_mesh=None,
                 shard_spec=None):
    """The rank's slice of the global ``x`` by ``placement`` (a
    ``PartitionSpec`` or a list of axis names).  A parameter is sliced in
    place (its data replaced) and keeps the spec as ``pspec``."""
    spec = _as_spec(placement if placement is not None else shard_spec)
    mesh = mesh or process_mesh or _mesh.ensure_mesh()
    sizes, coords = _mesh_sizes(mesh)
    parts = int(getattr(x, "mp_parts", 1))
    local = shard_slice(x.detach() if isinstance(x, torch.Tensor) else x,
                        spec, coords, sizes, parts)
    if isinstance(x, torch.nn.Parameter):
        x.data = local.contiguous()
        x.pspec = spec
        return x
    return local


def _tag(model):
    """A model that names its parameters' placements (the GPT model's
    ``_tag_layout``) sets them now: a deep copy of it has lost them."""
    tag = getattr(model, "_tag_layout", None)
    if tag is not None:
        tag()


def _shard_params(model, sizes, coords, group_of, mp):
    """Slice ``model``'s parameters by their pspecs over axes of
    ``sizes`` (``group_of(axis)`` the group of an axis), mark the sliced
    ones, and give every module ``mp`` as ``_mp_group``."""
    for _name, p in model.named_parameters():
        spec = _as_spec(getattr(p, "pspec", None))
        axes = [a for axis in spec if axis is not None
                for a in (axis if isinstance(axis, (tuple, list))
                          else (axis,)) if sizes.get(a, 1) > 1]
        if axes:
            with torch.no_grad():
                p.data = shard_slice(p.data, spec, coords, sizes,
                                     int(getattr(p, "mp_parts", 1))
                                     ).contiguous()
            p.is_distributed = True
            p.mp_group = group_of(axes[0])
        p.pspec = spec
    for m in model.modules():
        m._mp_group = mp
    check = getattr(model, "_check_parallel", None)
    if check is not None:
        check()
    return model


def parallelize(model, mesh=None, dp_axis="dp", mp_axis=None,
                param_rules=None):
    """Replace each parameter of ``model`` with the rank's slice by its
    ``pspec`` (``param_rules`` — ``{name substring: spec}`` — overrides
    it), keeping the spec as ``pspec``.  A sliced parameter is marked
    ``is_distributed`` and carries the group it is sliced over
    (``mp_group``).  Every module gets ``_mp_group``: the mesh's group of
    the tensor-parallel axis (``mp_axis``, default ``"mp"``) when that
    axis has more than one rank, else None; the GPT model and the
    :mod:`.mp_layers` layers run their collectives over it.  Inputs and
    replicated parameters are left as they are: every rank holds the
    same global values (one seed)."""
    mesh = mesh or _mesh.ensure_mesh()
    mp_axis = mp_axis or "mp"
    sizes, coords = _mesh_sizes(mesh)
    _tag(model)
    if param_rules:
        for name, p in model.named_parameters():
            for pattern, spec in param_rules.items():
                if pattern in name:
                    p.pspec = _as_spec(spec)
    mp = mesh.group(mp_axis) if mesh.shape.get(mp_axis, 1) > 1 else None
    return _shard_params(model, sizes, coords, mesh.group, mp)


def shard_module(model, group, axis="mp"):
    """:func:`parallelize` over one group in place of a mesh: the
    parameters whose pspec names ``axis`` keep this rank's slice over
    ``group`` (the serving engine's tensor-parallel copy)."""
    _tag(model)
    return _shard_params(model, {axis: group.nranks}, {axis: group.rank},
                         lambda _a: group, group if group.nranks > 1
                         else None)


@torch.no_grad()
def reshard_into(sharded, full, group, axis="mp"):
    """Copy ``full``'s parameters and buffers into ``sharded`` (a
    :func:`shard_module` copy of it): each sliced parameter takes this
    rank's slice, in place, so the copy keeps its tensors."""
    sizes, coords = {axis: group.nranks}, {axis: group.rank}
    src = dict(full.named_parameters())
    src.update(full.named_buffers())
    dst = dict(sharded.named_parameters())
    dst.update(sharded.named_buffers())
    for name, t in dst.items():
        value = src[name].detach()
        if getattr(t, "mp_group", None) is not None:
            value = shard_slice(value, t.pspec, coords, sizes,
                                int(getattr(t, "mp_parts", 1)))
        t.copy_(value)


def unshard_state(model):
    """The model's global state by name: each sliced parameter
    all-gathered over its group and re-joined by its dealing rule, every
    other entry as it is (a collective: every rank of the groups calls
    it)."""
    out = {}
    named = dict(model.named_parameters())
    for name, t in model.state_dict().items():
        p = named.get(name)
        group = getattr(p, "mp_group", None) if p is not None else None
        if group is None:
            out[name] = t.detach().clone()
            continue
        spec = tuple(p.pspec)
        dim = next(d for d, a in enumerate(spec) if a is not None)
        shards = _coll.all_gather([], t.detach().contiguous(), group=group)
        out[name] = unshard_slices(shards, dim, int(getattr(p, "mp_parts",
                                                            1)))
    return out


def local_rows(x, axis="dp", mesh=None):
    """The rows of the global batch ``x`` (a tensor, a numpy array, or a
    list / tuple / dict of them) that this rank keeps: dim 0 cut into
    ``axis_size(axis)`` equal pieces, the piece of this rank's
    coordinate."""
    mesh = mesh or _mesh.get_mesh()
    if mesh is None:
        return x
    axes = axis if isinstance(axis, (tuple, list)) else (axis,)
    spec = PartitionSpec(tuple(axes))
    sizes, coords = _mesh_sizes(mesh)

    def one(t):
        if isinstance(t, (list, tuple)):
            return type(t)(one(u) for u in t)
        if isinstance(t, dict):
            return {k: one(v) for k, v in t.items()}
        if isinstance(t, (torch.Tensor, np.ndarray)) and t.ndim > 0:
            return shard_slice(t, spec, coords, sizes)
        return t
    return one(x)


def shard_dataloader(dataloader, mesh=None, axis="dp"):
    """Wrap a data loader so that each batch it yields holds this rank's
    rows of the global batch (:func:`local_rows`) — the input half of
    data parallelism."""
    mesh = mesh or _mesh.ensure_mesh()

    class _Sharded:
        def __init__(self, inner):
            self._inner = inner

        def __iter__(self):
            for batch in self._inner:
                yield local_rows(batch, axis, mesh)

        def __len__(self):
            return len(self._inner)

    return _Sharded(dataloader)
