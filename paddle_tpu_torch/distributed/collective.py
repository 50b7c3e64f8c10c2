"""Collective communication (port of ``paddle_tpu/distributed/collective.py``).

In the JAX package a collective is a ``lax`` primitive over a mesh axis
inside ``shard_map``; outside a trace it is the identity over a world of
one.  Here each rank is a process and each call maps onto the
``torch.distributed`` op that computes it, over the process group of the
rank's slice along the named axis (:mod:`.mesh`).

* A call takes a group or an axis name, as in JAX (``_axis_of``): None is
  the default axis (``"dp"``, or the one :func:`split_group_axis` sets),
  a string names an axis of the global mesh, a :class:`Group` or any
  object with an ``axis`` attribute (the fleet topology's groups) picks
  that axis.
* With no process group (no mesh, an axis the mesh lacks, or no
  ``torch.distributed`` world) every collective is the identity.  A group
  of one rank with a process group still issues its op (the result is
  the identity), so a one-card run exercises the backend.
* As Paddle's, the collectives work in place on their input tensor.
* :func:`issued` counts the ops handed to the backend, by name.

Ops a backend lacks are built from ops it has: ``ReduceOp.AVG`` is a sum
then a division by the group's size (gloo has no average), ``alltoall``
of a list is one ``all_to_all_single`` over the stacked list (gloo has
no list form), and ``reduce`` reduces a copy so that the other ranks'
tensors keep their values, as JAX's ``reduce`` leaves them.
``ReduceOp.PROD`` is a real product (JAX's is ``exp(psum(log x))``).
:func:`ppermute` (``lax.ppermute``) is one ``all_to_all_single`` with
uneven split sizes, since gloo aborts on ``send`` / ``recv`` of CUDA
tensors.

The all-to-all that Ulysses attention and MoE run inside a model's
forward is differentiable (the JAX primitive is):
:func:`all_to_all_autograd` (``lax.all_to_all(..., tiled=True)`` on dim
0) runs the same exchange on the cotangent, which is its own inverse.
Ring attention's backward is written by hand and permutes with plain
:func:`ppermute`.  Gloo and NCCL match a group's collectives by the
order they are issued in, so a caller that moves several tensors stacks
them into one call, and every rank issues its calls in one order.
"""
from __future__ import annotations

import collections
import contextlib

import torch
import torch.distributed as dist

from . import mesh as _mesh

__all__ = ["ReduceOp", "all_reduce", "all_gather", "all_gather_object",
           "reduce_scatter", "broadcast", "reduce", "scatter", "alltoall",
           "all_to_all", "all_to_all_single", "send", "recv", "isend",
           "irecv", "ppermute", "barrier", "new_group", "get_group", "wait",
           "split_group_axis", "Group", "issued", "reset_counts",
           "all_to_all_autograd", "bound_group"]


class ReduceOp:
    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3
    AVG = 4


_TORCH_OPS = {ReduceOp.SUM: "SUM", ReduceOp.MAX: "MAX",
              ReduceOp.MIN: "MIN", ReduceOp.PROD: "PRODUCT",
              ReduceOp.AVG: "SUM"}


class Group:
    """A communication group: the global ``ranks`` of one slice of the
    mesh along ``axis`` and their process group (``pg``; None without a
    ``torch.distributed`` world).  ``rank`` is this process's index in
    ``ranks`` (-1 when it is not a member)."""

    def __init__(self, axis, ranks=None, pg=None, gid=0):
        self.axis = axis
        self.ranks = list(ranks) if ranks else [0]
        self.pg = pg
        self.id = gid
        me = dist.get_rank() if pg is not None else 0
        self.rank = self.ranks.index(me) if me in self.ranks else -1

    @property
    def nranks(self):
        return len(self.ranks)

    world_size = nranks

    def global_rank(self, group_rank):
        return self.ranks[int(group_rank)]

    def __repr__(self):
        return "Group(axis=%s, nranks=%d)" % (self.axis, self.nranks)


_groups = {}
_default_axis = "dp"
_issued = collections.Counter()


def issued():
    """{op name: count} of the ops handed to a backend since the last
    :func:`reset_counts`."""
    return dict(_issued)


def reset_counts():
    _issued.clear()


def _axis_of(group) -> str:
    if group is None:
        return _default_axis
    if isinstance(group, str):
        return group
    ax = getattr(group, "axis", None)
    return ax if ax is not None else _default_axis


def _resolve(group):
    """The :class:`Group` a call runs over, or None for the identity."""
    if isinstance(group, Group):
        return group if group.pg is not None else None
    axis = _axis_of(group)
    mesh = _mesh.get_mesh()
    if mesh is None:
        if not (dist.is_available() and dist.is_initialized()):
            return None
        mesh = _mesh.ensure_mesh()
    g = mesh.group(axis)
    return g if g is not None and g.pg is not None else None


def bound_group(axis):
    """The :class:`Group` of ``axis`` (a name, a :class:`Group` or an
    object with an ``axis`` attribute) on the installed global mesh when
    it has a process group, else None: the port's counterpart of "``axis``
    is bound in this ``shard_map`` trace".  Unlike :func:`_resolve`, it
    never installs a default mesh."""
    if isinstance(axis, Group):
        return axis if axis.pg is not None else None
    axis = _axis_of(axis)
    mesh = _mesh.get_mesh()
    g = mesh.group(axis) if mesh is not None else None
    return g if g is not None and g.pg is not None else None


def _issue(name):
    _issued[name] += 1


def _op(op):
    return getattr(dist.ReduceOp, _TORCH_OPS[int(op)])


def _finish_avg(t, op, n):
    if int(op) == ReduceOp.AVG:
        if t.is_floating_point():
            t.div_(n)
        else:
            t.floor_divide_(n)
    return t


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """Reduce ``tensor`` over the group, in place; returns it."""
    g = _resolve(group)
    if g is None:
        return tensor
    _issue("all_reduce")
    dist.all_reduce(tensor, op=_op(op), group=g.pg)
    return _finish_avg(tensor, op, g.nranks)


def all_gather(tensor_list, tensor=None, group=None, sync_op=True, axis=0):
    """List form ``all_gather(tensor_list, tensor)``: fills
    ``tensor_list`` with every rank's ``tensor`` in rank order.  Tensor
    form ``all_gather(tensor)``: returns the ranks' tensors concatenated
    on dim 0."""
    if tensor is None:
        tensor, tensor_list = tensor_list, None
    g = _resolve(group)
    if tensor_list is not None:
        if g is None:
            parts = [tensor]
        else:
            _issue("all_gather")
            parts = [torch.empty_like(tensor) for _ in range(g.nranks)]
            dist.all_gather(parts, tensor.contiguous(), group=g.pg)
        tensor_list.clear()
        tensor_list.extend(parts)
        return tensor_list
    if g is None:
        return tensor
    _issue("all_gather")
    x = tensor.contiguous()
    out = x.new_empty((x.shape[0] * g.nranks,) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=g.pg)
    return out


def all_gather_object(obj_list, obj, group=None):
    g = _resolve(group)
    if g is None:
        obj_list.clear()
        obj_list.append(obj)
        return obj_list
    _issue("all_gather_object")
    out = [None] * g.nranks
    dist.all_gather_object(out, obj, group=g.pg)
    obj_list.clear()
    obj_list.extend(out)
    return obj_list


def reduce_scatter(tensor, tensor_list=None, op=ReduceOp.SUM, group=None,
                   sync_op=True):
    """Reduce the concatenation of ``tensor_list`` (or ``tensor`` itself
    when no list is given) over the group and keep this rank's piece of
    dim 0: written into ``tensor`` when a list is given, else returned
    and made ``tensor``'s data (JAX replaces the input's array)."""
    src = (torch.cat(list(tensor_list), 0) if tensor_list is not None
           else tensor)
    g = _resolve(group)
    if g is None:
        out = src
    else:
        _issue("reduce_scatter")
        src = src.contiguous()
        out = src.new_empty((src.shape[0] // g.nranks,)
                            + tuple(src.shape[1:]))
        dist.reduce_scatter_tensor(out, src, op=_op(op), group=g.pg)
        _finish_avg(out, op, g.nranks)
    if tensor_list is not None:
        with torch.no_grad():
            tensor.copy_(out)
        return tensor
    if out is not tensor:
        tensor.data = out
    return tensor


def broadcast(tensor, src=0, group=None, sync_op=True):
    """Every rank's ``tensor`` takes the value of group rank ``src``'s,
    in place."""
    g = _resolve(group)
    if g is None:
        return tensor
    _issue("broadcast")
    dist.broadcast(tensor, src=g.global_rank(src), group=g.pg)
    return tensor


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """Group rank ``dst``'s ``tensor`` becomes the reduction; the others
    keep their values."""
    g = _resolve(group)
    if g is None:
        return tensor
    _issue("reduce")
    tmp = tensor.clone()
    dist.reduce(tmp, dst=g.global_rank(dst), op=_op(op), group=g.pg)
    if g.rank == int(dst):
        with torch.no_grad():
            tensor.copy_(_finish_avg(tmp, op, g.nranks))
    return tensor


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """Group rank ``i``'s ``tensor`` takes ``tensor_list[i]`` of group rank
    ``src``, in place.  Without a group, ``tensor_list[src]``."""
    g = _resolve(group)
    if tensor_list is None and g is None:
        return tensor
    if g is None:
        with torch.no_grad():
            tensor.copy_(tensor_list[src])
        return tensor
    _issue("scatter")
    parts = None
    if g.rank == int(src):
        parts = [t.contiguous() for t in tensor_list]
    out = torch.empty_like(tensor)
    dist.scatter(out, parts, src=g.global_rank(src), group=g.pg)
    with torch.no_grad():
        tensor.copy_(out)
    return tensor


def alltoall(in_tensor_list, out_tensor_list=None, group=None, sync_op=True):
    """Group rank ``j`` receives entry ``j`` of every rank's list: entry
    ``i`` of its output is rank ``i``'s ``in_tensor_list[j]``.  A tensor
    in place of the list is split on dim 0.  Built as one
    ``all_to_all_single`` over the stacked list."""
    x = (torch.stack(list(in_tensor_list), 0)
         if isinstance(in_tensor_list, (list, tuple)) else in_tensor_list)
    g = _resolve(group)
    if g is None:
        out = x
    else:
        _issue("alltoall")
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=g.pg)
    if out_tensor_list is not None:
        out_tensor_list.clear()
        out_tensor_list.extend(torch.unbind(out, 0))
        return out_tensor_list
    return out


all_to_all = alltoall


def all_to_all_single(in_tensor, out_tensor=None, in_split_sizes=None,
                      out_split_sizes=None, group=None, sync_op=True):
    """Split ``in_tensor`` on dim 0 (equally, or by ``in_split_sizes``),
    send piece ``j`` to group rank ``j`` and concatenate what arrives, in
    rank order, into ``out_tensor`` (made when not given)."""
    g = _resolve(group)
    if g is None:
        if out_tensor is not None:
            with torch.no_grad():
                out_tensor.copy_(in_tensor)
            return out_tensor
        return in_tensor
    _issue("all_to_all_single")
    x = in_tensor.contiguous()
    if out_tensor is None:
        rows = (sum(int(s) for s in out_split_sizes)
                if out_split_sizes is not None else x.shape[0])
        out_tensor = x.new_empty((rows,) + tuple(x.shape[1:]))
    dist.all_to_all_single(out_tensor, x, out_split_sizes, in_split_sizes,
                           group=g.pg)
    return out_tensor


class _Permuted:
    """A :func:`ppermute` in flight: ``wait()`` returns the tensor that
    arrived."""

    def __init__(self, out, work=None):
        self._out, self._work = out, work

    def wait(self):
        if self._work is not None:
            self._work.wait()
            self._work = None
        return self._out

    def is_completed(self):
        return self._work is None or self._work.is_completed()


def _peers(perm, me, n):
    """(destination, source) of group rank ``me`` in ``perm`` (None where
    it sends or receives nothing); ``perm`` must pair each rank at most
    once on each side, as ``lax.ppermute`` asks."""
    pairs = [(int(s), int(d)) for s, d in perm]
    srcs, dsts = [s for s, _ in pairs], [d for _, d in pairs]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts) \
            or not all(0 <= r < n for r in srcs + dsts):
        raise ValueError("ppermute: %r is not a permutation of the %d "
                         "ranks of the group" % (perm, n))
    dst = next((d for s, d in pairs if s == me), None)
    src = next((s for s, d in pairs if d == me), None)
    return dst, src


def ppermute(tensor, perm, group=None, async_op=False):
    """The counterpart of ``lax.ppermute``: ``perm`` lists ``(source,
    destination)`` pairs of group ranks; this rank sends ``tensor`` to its
    destination and returns what its source sent (zeros where no rank
    sends to it, as in JAX).  One ``all_to_all_single`` with uneven split
    sizes — the whole tensor to the one destination, nothing to the other
    ranks — which gloo takes on CPU and CUDA tensors (where it aborts on
    ``send`` / ``recv``) and NCCL on cards.  With ``async_op`` the call
    returns a handle whose ``wait()`` gives the tensor, so the caller can
    compute while the transfer runs.  Without a process group the
    identity permutation returns the tensor itself."""
    g = _resolve(group)
    if g is None:
        dst, src = _peers(perm, 0, 1)
        out = tensor if src is not None else torch.zeros_like(tensor)
        return _Permuted(out) if async_op else out
    dst, src = _peers(perm, g.rank, g.nranks)
    _issue("ppermute")
    x = tensor.contiguous().reshape(-1)
    n = int(x.numel())
    # a rank that sends nothing (or receives nothing) under a partial
    # permutation hands the backend an empty input (or output): the split
    # sizes must add up to the tensors' lengths
    send = x if dst is not None else x[:0]
    recv = torch.empty_like(x) if src is not None else x.new_empty((0,))
    work = dist.all_to_all_single(
        recv, send, [n if j == src else 0 for j in range(g.nranks)],
        [n if j == dst else 0 for j in range(g.nranks)], group=g.pg,
        async_op=async_op)
    out = (recv.view(tensor.shape) if src is not None
           else torch.zeros_like(tensor))
    return _Permuted(out, work) if async_op else out


def _tiled_all_to_all(x, g):
    """Dim 0 of ``x`` cut into ``g.nranks`` equal pieces, piece ``j`` to
    group rank ``j``; what arrives concatenated in rank order."""
    if x.shape[0] % g.nranks:
        raise ValueError("all_to_all: dim 0 (%d) is not a multiple of the "
                         "group's %d ranks" % (x.shape[0], g.nranks))
    _issue("all_to_all_single")
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=g.pg)
    return out


class _AllToAllFn(torch.autograd.Function):
    """The tiled all-to-all over dim 0; its own inverse, so the backward
    runs it on the cotangent."""

    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return _tiled_all_to_all(x, g)

    @staticmethod
    def backward(ctx, grad):
        return _tiled_all_to_all(grad, ctx.g), None


def all_to_all_autograd(tensor, group=None):
    """``lax.all_to_all(x, axis, 0, 0, tiled=True)``, differentiable: dim 0
    cut into one piece a rank of the group, piece ``j`` sent to rank
    ``j``, the pieces that arrive concatenated in rank order.  The
    identity where no process group resolves."""
    g = _resolve(group)
    if g is None:
        return tensor
    return _AllToAllFn.apply(tensor, g)


def _p2p_group(group, peer):
    """The group of a point-to-point call, or None where it is the
    identity (no process group, or ``peer`` is this rank itself)."""
    g = _resolve(group)
    if g is None or g.rank == int(peer):
        return None
    return g


def send(tensor, dst=0, group=None, sync_op=True):
    """Send ``tensor`` to group rank ``dst`` (the identity toward this
    rank itself)."""
    g = _p2p_group(group, dst)
    if g is not None:
        _issue("send")
        dist.send(tensor.contiguous(), dst=g.global_rank(dst), group=g.pg)
    return tensor


def recv(tensor, src=0, group=None, sync_op=True):
    """Receive into ``tensor`` from group rank ``src``, in place."""
    g = _p2p_group(group, src)
    if g is not None:
        _issue("recv")
        dist.recv(tensor, src=g.global_rank(src), group=g.pg)
    return tensor


class _Task:
    """A point-to-point call in flight (``torch.distributed``'s work
    handle); a call that was the identity is complete at once."""

    def __init__(self, work=None):
        self._work = work

    def wait(self):
        if self._work is not None:
            self._work.wait()
        return True

    def is_completed(self):
        return self._work is None or self._work.is_completed()


def isend(tensor, dst=0, group=None):
    g = _p2p_group(group, dst)
    if g is None:
        return _Task()
    _issue("isend")
    return _Task(dist.isend(tensor.contiguous(), dst=g.global_rank(dst),
                            group=g.pg))


def irecv(tensor, src=0, group=None):
    g = _p2p_group(group, src)
    if g is None:
        return _Task()
    _issue("irecv")
    return _Task(dist.irecv(tensor, src=g.global_rank(src), group=g.pg))


def barrier(group=None):
    g = _resolve(group)
    if g is not None:
        _issue("barrier")
        dist.barrier(group=g.pg)


def wait(tensor, group=None, use_calc_stream=True):
    """Wait until the device has finished the work queued on
    ``tensor``'s stream (a CPU tensor is always ready)."""
    if isinstance(tensor, torch.Tensor) and tensor.is_cuda:
        torch.cuda.current_stream(tensor.device).synchronize()


def new_group(ranks=None, backend=None, axis=None, timeout=None):
    """A group over an axis of the global mesh (``axis``), or over the
    given global ``ranks`` (every rank of the world must call it, as
    ``torch.distributed.new_group`` asks), or the default axis."""
    gid = len(_groups) + 1
    if axis is None and ranks is not None and dist.is_available() \
            and dist.is_initialized():
        ranks = sorted(int(r) for r in ranks)
        pg = (dist.group.WORLD if len(ranks) == dist.get_world_size()
              else dist.new_group(ranks, backend=backend))
        g = Group("ranks", ranks, pg, gid)
    else:
        base = _resolve(axis or _default_axis)
        g = (Group(axis or _default_axis, gid=gid) if base is None
             else Group(base.axis, base.ranks, base.pg, gid))
    _groups[gid] = g
    return g


def get_group(gid=0):
    g = _groups.get(gid)
    if g is not None:
        return g
    base = _resolve(_default_axis)
    return base if base is not None else Group(_default_axis)


def split_group_axis(axis: str):
    """Scope helper to retarget the default axis."""
    @contextlib.contextmanager
    def ctx():
        global _default_axis
        prev = _default_axis
        _default_axis = axis
        try:
            yield
        finally:
            _default_axis = prev

    return ctx()


def get_world_size(group=None):
    if group is not None:
        g = _resolve(group)
        return 1 if g is None else g.nranks
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1
