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
* **stage 3**: the masters also rest as slices between steps, and so do
  the model's parameters: each sliced parameter holds this rank's slice
  in its own dtype (the cast of the master's slice) and is gathered
  where it is used (:class:`GatherOnUse`), as the JAX package's GSPMD
  gathers each weight where it is used.  A gather unit's forward
  (a module marked ``_zero_gather_unit``, such as a GPT block, else the
  parameter's own module) all-gathers its parameters and frees them
  after; a module of stacked (L, ...) parameters marked
  ``_zero_gather_layers`` (the scan-layers blocks) gathers one layer's
  rows of each at a time; the backward gathers each saved use again;
  each parameter's gradient is reduce-scattered onto the rank's slice as
  soon as autograd produces it.  ``TrainStep(stack_layers=True)`` keeps
  the whole parameters in the model: the masters rest as slices and are
  all-gathered into the model when the next step starts (ROADMAP.md
  §C).

:func:`shard_params` and :func:`shard_optimizer_state` are the placement
helpers: the first records each parameter's ZeRO spec (``zero_spec``),
the second cuts slot tensors to this rank's slices.
"""
from __future__ import annotations

import weakref

import numpy as np
import torch
from torch import nn


from . import collective as _coll
from . import mesh as _mesh
from .mesh import PartitionSpec

__all__ = ["ZeroPartition", "GatherOnUse", "shard_optimizer_state",
           "shard_params", "ShardingParallel", "group_sharded_parallel",
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
    be a no-op).  On a mesh of one rank nothing is cut, as in JAX.

    ``stacked`` ({name: (stages, blocks)}) names the pipeline's block
    masters, which the JAX program holds stacked (stages, blocks, ...)
    with the stage dimension on ``pp``: the cut is picked on that stacked
    shape (``fixed=("pp",)``, the element count the stacked one), and a
    rank keeps the same slice of every block.  A cut the JAX program would
    put on the block dimension leaves the port's per-block masters
    whole."""

    def __init__(self, params, stage, axis="sdp", stacked=None):
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
        stacked = stacked or {}
        for name, t in params.items():
            lead = tuple(stacked.get(name, ()))
            if lead:
                probe = torch.empty(lead + tuple(t.shape), device="meta")
                d = _dim_of(_stage_spec_for(probe, axis, fixed=("pp",)),
                            axis)
                d = d - len(lead) if d is not None and d >= len(lead) \
                    else None
            else:
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

    def gather(self, name, t, dim=None):
        """The full tensor from every rank's slice ``t`` (a collective
        over the group), cut on ``name``'s dimension or on ``dim``."""
        d = self.dims.get(name) if dim is None else dim
        if d is None:
            return t
        parts = _coll.all_gather([], t.contiguous(), group=self.group)
        return torch.cat(parts, dim=d)

    def reduce_scatter(self, name, g, dim=None):
        """This rank's slice of the average of every rank's full ``g``:
        one reduce-scatter over the group (along dim 0 of ``g`` with its
        cut dimension, ``name``'s or ``dim``, moved first)."""
        d = self.dims[name] if dim is None else dim
        moved = torch.movedim(g, d, 0).contiguous()
        _coll.reduce_scatter(moved, op=_coll.ReduceOp.AVG, group=self.group)
        return torch.movedim(moved, 0, d).contiguous()


class _Regather:
    """A saved gathered parameter, packed as where to gather it from: the
    parameter's key (its name, or (name, layer)) and the saved view's
    geometry."""

    __slots__ = ("key", "size", "stride", "offset")

    def __init__(self, key, t):
        self.key = key
        self.size = tuple(t.size())
        self.stride = tuple(t.stride())
        self.offset = t.storage_offset()


class _GatherFn(torch.autograd.Function):
    """The full parameter (``key`` a name), or one layer's rows of a
    stacked one (``key`` (name, layer)), from this rank's slice ``param``;
    its backward hands the full gradient to :meth:`GatherOnUse._reduce`
    and passes nothing to the slice (whose gradient lives in the step's
    f32 slices)."""

    @staticmethod
    def forward(ctx, param, owner, key):
        ctx.owner, ctx.key = owner, key
        return owner._gather(key, owner._part(key, param))

    @staticmethod
    def backward(ctx, grad):
        ctx.owner._reduce(ctx.key, grad)
        return None, None, None


#: the stage-3 gatherer of each model (weakly: a model dropped drops it)
_GATHERS = weakref.WeakKeyDictionary()


class GatherOnUse:
    """ZeRO stage 3's parameters gathered where they are used, for
    ``jit.TrainStep(zero_stage=3)``.

    ``params`` ({name: Parameter}) are ``model``'s sliced parameters; each
    rests as this rank's slice of ``zero`` (a :class:`ZeroPartition`) in
    its dtype.  Each is gathered in the forward of its unit: the nearest
    enclosing module marked ``_zero_gather_unit`` (or naming it, relative
    to itself, in ``_zero_gather_whole``: the GPT's tied embedding, which
    the LM head reads outside the lookup), else the module that owns it.
    A forward pre-hook puts the gathered tensor in place of the
    parameter, a forward hook puts the parameter back and drops the
    tensor.  While the model's forward runs, a saved-tensor hook packs
    any saved view of a gathered tensor as a :class:`_Regather`, so the
    backward gathers it again and frees it after the node that reads it.

    A module marked ``_zero_gather_layers`` (stacked (L, ...) parameters
    it runs one layer at a time) has its parameters cut past the layer
    dimension gathered a layer at a time instead: while its forward runs
    its ``_zero_layer`` is a function that puts layer ``i``'s full rows
    into its per-layer dict (``fn(p, i)``; ``fn.names`` are the
    attributes it fills).

    ``reduce(name, full_grad, dim)`` turns the full gradient of a
    parameter (or of a layer, cut on ``dim``) into its reduced f32 slice;
    it runs in the backward once per parameter or layer (a unit gathers a
    parameter once a forward, and every use of it adds into that one
    gathered tensor), and :meth:`take_grads` hands the slices over.
    :attr:`whole` is True while the model holds its full parameters
    (after :meth:`make_whole`: ``sync_to_model``); the hooks then do
    nothing.  ``live_bytes`` / ``peak_bytes`` count the
    gathered full parameters alive at once (a weak reference each),
    ``gathers`` the gathers."""

    def __init__(self, model, zero, params, reduce):
        self.zero = zero
        self.params = dict(params)
        self._reduce_fn = reduce
        self.whole = False
        self.grads = {}
        self.live_bytes = self.peak_bytes = self.gathers = 0
        # storage address -> key of each gathered tensor of the forward
        self._held = {}
        self._saving = None
        self._layers = {}
        units = self._units(model)
        self._handles = []

        def hook(module, pre, fn, **kw):
            # a deep copy of the model carries the hooks: they act on the
            # modules they were made for only
            if pre:
                h = module.register_forward_pre_hook(
                    lambda m, _a: fn(m) if m is module else None, **kw)
            else:
                h = module.register_forward_hook(
                    lambda m, _a, _o: fn(m) if m is module else None,
                    always_call=True)
            self._handles.append(h)
        for unit, entries in units.items():
            hook(unit, True, lambda _m, e=entries: self._pre(e))
            hook(unit, False, lambda _m, e=entries: self._post(e))
        for module, names in self._layers.items():
            hook(module, True, lambda m, n=names: self._lend(m, n))
            hook(module, False, lambda m: setattr(m, "_zero_layer", None))
        hook(model, True, lambda _m: self._enter(), prepend=True)
        hook(model, False, lambda _m: self._exit())
        _GATHERS[model] = self

    def _units(self, model):
        """{unit module: [(owner module, attribute, name)]}: a parameter
        held in several places (tied) is swapped in each, in the unit of
        its first place, or the modules' nearest common ancestor when the
        places lie in different units."""
        by_id = {id(p): n for n, p in self.params.items()}
        whole = {}
        for prefix, m in model.named_modules():
            for rel in getattr(m, "_zero_gather_whole", ()):
                whole[(prefix + "." if prefix else "") + rel] = m
        places = {}

        def walk(m, path, unit):
            if getattr(m, "_zero_gather_unit", False):
                unit = m
            for attr, p in m._parameters.items():
                name = by_id.get(id(p)) if p is not None else None
                if name is not None:
                    places.setdefault(name, []).append(
                        (m, attr, unit if unit is not None else m, path))
            for cname, c in m._modules.items():
                if c is not None:
                    walk(c, path + (m,), unit)
        walk(model, (), None)
        units = {}
        for name, where in places.items():
            owner, attr = where[0][:2]
            d = self.zero.dims.get(name)
            if len(where) == 1 and d and getattr(
                    owner, "_zero_gather_layers", False):
                # stacked rows cut past the layer dimension: a layer at a
                # time, in the module's own loop
                self._layers.setdefault(owner, {})[attr] = name
                continue
            at = whole.get(name)
            if at is None:
                at = where[0][2]
                if any(w[2] is not at for w in where[1:]):
                    # the deepest module every place lies under
                    chains = [w[3] + (w[0],) for w in where]
                    common = [c[0] for c in zip(*chains)
                              if all(x is c[0] for x in c)]
                    at = common[-1]
            units.setdefault(at, []).extend(
                (owner, attr, name) for owner, attr, _u, _p in where)
        return units

    @staticmethod
    def release(model):
        """Take the hooks of a previous stage-3 step off ``model`` (a new
        step is being built on it).  A model that still rests as that
        step's slices raises ``ValueError``: the old step's
        ``sync_to_model()`` makes it whole first."""
        old = _GATHERS.get(model)
        if old is None:
            return
        if not old.whole:
            raise ValueError(
                "the model's parameters rest as another ZeRO stage-3 "
                "step's slices: call that step's sync_to_model() before "
                "building a new step on it")
        for h in old._handles:
            h.remove()
        del _GATHERS[model]

    # -- gathers ------------------------------------------------------------
    @staticmethod
    def _part(key, param):
        """The slice a key gathers from: the parameter's, or a layer's
        rows of it."""
        return param if isinstance(key, str) else param[key[1]]

    def _gather(self, key, part):
        name, layer = (key, None) if isinstance(key, str) else key
        full = self.zero.gather(name, part, None if layer is None
                                else self.zero.dims[name] - 1)
        nbytes = full.numel() * full.element_size()
        self.gathers += 1
        self.live_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(full, self._freed, nbytes,
                         full.untyped_storage().data_ptr())
        return full

    def _freed(self, nbytes, ptr):
        self.live_bytes -= nbytes
        self._held.pop(ptr, None)

    def _lend(self, module, names):
        """``module``'s ``_zero_layer`` for its forward: the function that
        gathers layer ``i``'s rows of its stacked parameters."""
        if self.whole:
            module._zero_layer = None
            return

        def layer(p, i):
            p = dict(p)
            for attr, name in names.items():
                full = _GatherFn.apply(self.params[name], self, (name, i))
                self._held[full.untyped_storage().data_ptr()] = (name, i)
                p[attr] = full
            return p
        layer.names = frozenset(names)
        module._zero_layer = layer

    def _pre(self, entries):
        if self.whole:
            return
        got = {}
        for owner, attr, name in entries:
            p = owner._parameters[attr]
            if not isinstance(p, nn.Parameter):
                continue            # gathered by an enclosing call
            full = got.get(name)
            if full is None:
                full = got[name] = _GatherFn.apply(p, self, name)
                self._held[full.untyped_storage().data_ptr()] = name
            owner._parameters[attr] = full

    def _post(self, entries):
        for owner, attr, name in entries:
            t = owner._parameters[attr]
            if isinstance(t, nn.Parameter):
                continue
            self._held.pop(t.untyped_storage().data_ptr(), None)
            owner._parameters[attr] = self.params[name]

    # -- the backward's gathers ---------------------------------------------
    def _enter(self):
        if self.whole or self._saving is not None:
            return
        self._saving = torch.autograd.graph.saved_tensors_hooks(
            self._pack, self._unpack)
        self._saving.__enter__()

    def _exit(self):
        if self._saving is not None:
            saving, self._saving = self._saving, None
            saving.__exit__(None, None, None)

    def _pack(self, t):
        if self._held and t.layout == torch.strided:
            try:
                name = self._held.get(t.untyped_storage().data_ptr())
            except (RuntimeError, NotImplementedError):
                return t            # a tensor without a storage of its own
            if name is not None:
                return _Regather(name, t)
        return t

    def _unpack(self, x):
        if not isinstance(x, _Regather):
            return x
        name = x.key if isinstance(x.key, str) else x.key[0]
        part = self._part(x.key, self.params[name].detach())
        with torch.no_grad():
            full = part if self.whole else self._gather(x.key, part)
        return full.as_strided(x.size, x.stride, x.offset)

    def _reduce(self, key, grad):
        if isinstance(key, str):
            g = self._reduce_fn(key, grad)
            have = self.grads.get(key)
            self.grads[key] = g if have is None else have + g
            return
        name, layer = key
        g = self._reduce_fn(name, grad, self.zero.dims[name] - 1)
        rows = self.grads.get(name)
        if rows is None:
            rows = self.grads[name] = g.new_zeros(
                (self.params[name].shape[0],) + tuple(g.shape))
        rows[layer].add_(g)

    def take_grads(self):
        """The reduced f32 slices of the last backward (a parameter that
        no forward read has none)."""
        out, self.grads = self.grads, {}
        return out

    # -- the model's parameters ---------------------------------------------
    @torch.no_grad()
    def rest(self, slices):
        """Each parameter holds this rank's slice (``slices``: {name: the
        slice in any dtype}, cast to the parameter's); full storage is
        freed."""
        for name, p in self.params.items():
            p.data = slices[name].to(p.dtype).contiguous()
        self.whole = False

    @torch.no_grad()
    def make_whole(self, full):
        """Each parameter holds its full tensor (``full``: {name: tensor}
        cast to the parameter's dtype); the hooks rest until
        :meth:`rest`."""
        for name, p in self.params.items():
            p.data = full[name].to(p.dtype).contiguous()
        self.whole = True


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
    The model keeps its full tensors until ``TrainStep(zero_stage=3)``
    rests them as slices (:class:`GatherOnUse`)."""
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
