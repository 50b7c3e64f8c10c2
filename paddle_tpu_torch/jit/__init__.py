"""The training step (port of ``paddle_tpu/jit/__init__.py`` ``TrainStep``).

The JAX package compiles forward, backward and optimizer update into one
XLA program.  PyTorch runs eagerly, so this step is eager inside and
keeps the JAX step's contract:

* trainable parameters are held as f32 masters; a bf16 / f16 parameter
  (AMP O2) keeps its compute dtype in the model, and the forward runs on
  it;
* the compute-dtype gradients are upcast to f32 and handed, by name, to
  ``optimizer.apply_gradients``; the updated masters are written back
  into the model's parameters (cast to their dtype).  LayerNorm
  parameters, f32 under O2, stay f32 end to end;
* ``step(*batch)`` sends ``batch[:num_inputs]`` to the model and the rest
  to ``loss_fn(*outputs, *labels)``;
* the LR scheduler steps after the update;
* the call returns the loss as a 0-d device tensor and does not wait for
  the device;
* dropout masks come from the step's own ``torch.Generator``
  (``seed``), set on every module with a ``generator`` attribute.

The step runs on the card unless ``device="cpu"`` is given, and moves
the model there.

``flat_master=True`` packs every f32 master below ``_FLAT_MAX_ELEMS``
elements into one 1-D f32 buffer, members sorted by compute dtype, then
by name, as in the JAX step: the optimizer updates it as one tensor.
The grads of each dtype group are concatenated into it (the JAX
unflatten's backward), and the model's parameters of a group are views
of one contiguous buffer, so the write-back is one cast per group.  It
is off by default, as in the JAX package, and refuses what would change
the math (``_flat_eligible``).

``stack_layers=True`` holds the masters of each group of per-layer
parameters that differ only in their layer index (``gpt.h.{i}.attn.
qkv_proj.weight``, same shape and dtype: ``_stack_layout``, computed on
the model's dtypes before the f32 promotion, as in the JAX step) as one
f32 (L, ...) tensor under the group's template name (``gpt.h.#.attn.
qkv_proj.weight``): the optimizer and its slots see the stacked names.
Each group's grads are stacked once and upcast, and the model's
parameters of a group are views of one (L, ...) buffer in their dtype,
so the write-back is one cast per group.  A model built with
``GPTConfig(scan_layers=True)`` needs none of this: its grads arrive
stacked.

``state_dict`` / ``set_state_dict`` use the JAX step's layout:
``{"params", "buffers", "opt_state": {"slots", "step"}, "opt_extra"}``,
per parameter name also under ``flat_master`` and ``stack_layers``, so a
checkpoint loads across the modes.

``in_shardings`` (a ``PartitionSpec`` for every batch element, or one
for each, as in the JAX step) shards the batch over the axis its first
dimension names (``PartitionSpec("dp", None)``): every rank is given the
global batch and keeps its rows of that axis
(``distributed.parallel_base.local_rows``).  After the backward the
gradients are averaged over the axis's group: one all-reduce a dtype
over the grads concatenated (under ``flat_master``, one more over the
flat master's gradient buffer as it is), in f32 — under AMP O2 after
the upcast of the bf16 / f16 grads — and a division by the group's
size.  The loss returned is
the average of the ranks' losses, the same on every rank: the global
batch's mean loss when every rank's rows weigh alike.  A model that
``distributed.parallelize`` sliced over ``mp`` keeps its shards as
masters; the global-norm clip sums their squares over ``mp``
(``nn.clip.global_norm_sq``), and ``flat_master`` packs only the
replicated ones.

On a mesh whose ``sep`` group has more than one rank, the GPT shards
its sequences itself (``models/gpt.py``): every rank is given the global
batch (its ``dp`` rows when the batch is sharded), runs its rows of each
sequence, and its loss and gradients are its shares of the one-device
ones.  The step sums the gradients over ``sep`` (one all-reduce a dtype,
before the average over the batch axis) and the loss too.  So the loss
must be such a share (``GPTPretrainingCriterion``'s, tagged
``sep_share``); another raises.
``in_shardings`` may name ``sep`` on the batch's second dimension
(``PartitionSpec("dp", "sep")``), which reads the same; any other axis
past the first dimension raises.  ZeRO on such a mesh raises (ROADMAP.md
§A5).

``zero_stage`` (1, 2 or 3) shards the step over the ``zero_axis`` group
of the global mesh (``"sdp"``; :mod:`..distributed.sharding`): each rank
owns the slice of each master that ``_stage_spec_for`` picks, and keeps
only its slices of the optimizer slots (stage 1); its gradients are
reduce-scattered onto those slices where they would be all-reduced
(stage 2: the batch sharded over ``zero_axis``; with the batch on
another axis or on none, each rank's gradients are already the global
ones and the reduce-scatter averages equal values); and the masters rest
as slices between steps (stage 3), all-gathered, written into the model
and freed at the start of the next step or at :meth:`sync_to_model`, so
under stage 3 the model's parameters take an update when the next step
starts.  Each rank updates its slices, and stages 1 and 2 all-gather the
updated masters before the write-back.  The global-norm clip sums the
squares of the slices over the group.  ``state_dict`` gives the full
masters and slots, and ``set_state_dict`` takes them, so a checkpoint
is the same with and without ZeRO.  As in the JAX step, a ``zero_axis``
of size <= 1 on a mesh of more than one rank raises ``ValueError``.
"""
from __future__ import annotations

import re
from typing import Callable

import numpy as np
import torch
from torch.autograd.graph import increment_version

from ..core.device import resolve_device
from ..optimizer.lr import LRScheduler

_LOW_PRECISION = (torch.bfloat16, torch.float16)

#: step-state key holding the single flat f32 master buffer (flat_master)
_FLAT_KEY = "__flat_master__"

#: masters at or above this element count stay out of the flat buffer
#: (GPT-2's 51.5M-element wte), as in the JAX step
_FLAT_MAX_ELEMS = 1 << 25

#: the layer index of a per-layer parameter name (``gpt.h.3.ln1.weight``)
_LAYER_IDX_RE = re.compile(r"\.(\d+)\.")


def _stack_layout(params):
    """``{template: [names in layer order]}`` for the groups of names that
    differ only in one numeric segment (the layer index, replaced by ``#``
    in the template), indexed 0 to L - 1 with L > 1, of one shape and one
    dtype (the JAX step's ``_stack_layout``)."""
    groups = {}
    for name in params:
        hits = _LAYER_IDX_RE.findall(name)
        if len(hits) != 1:
            continue
        template = _LAYER_IDX_RE.sub(".#.", name)
        groups.setdefault(template, []).append((int(hits[0]), name))
    layout = {}
    for template, members in groups.items():
        if len(members) < 2:
            continue
        members.sort()
        names = [n for _i, n in members]
        if [i for i, _n in members] == list(range(len(members))) \
                and len({tuple(params[n].shape) for n in names}) == 1 \
                and len({params[n].dtype for n in names}) == 1:
            layout[template] = names
    return layout

__all__ = ["TrainStep"]


class TrainStep:
    """One training step: forward, backward and optimizer update.

    Usage::

        step = TrainStep(model, loss_fn, opt)
        for x, y in loader:
            loss = step(x, y)

    ``in_shardings=PartitionSpec("dp", None)`` cuts the global batch it is
    given into the rank's rows; with ``local_batch=True`` each rank passes
    its own rows (from a ``DistributedBatchSampler``) and the step only
    averages over ``dp``.
    """

    def __init__(self, model: torch.nn.Module, loss_fn: Callable, optimizer,
                 num_inputs: int = 1, in_shardings=None, donate=True,
                 zero_stage=None, zero_axis: str = "sdp",
                 stack_layers: bool = False, flat_master=None, seed: int = 0,
                 device=None, local_batch: bool = False):
        if flat_master and not _flat_eligible(optimizer, zero_stage,
                                              stack_layers):
            raise ValueError(
                "flat_master=True is incompatible with this configuration "
                "(ZeRO/stack_layers/per-param optimizer semantics — see "
                "_flat_eligible)")
        self._batch_axis, self._in_specs = _batch_axis(in_shardings)
        # each rank passes its own rows (a DistributedBatchSampler's): the
        # step averages over the batch axis without cutting the batch
        self._local_rows_given = bool(local_batch)
        self._dp_group = None
        self._dp_bufs = {}
        if self._batch_axis is not None:
            from ..distributed import collective as _coll
            from ..distributed import mesh as _mesh
            _mesh.ensure_mesh()
            self._dp_group = _coll._resolve(self._batch_axis)
        # the sequence-sharded GPT's group: its grads and loss are summed
        from ..distributed.collective import bound_group
        self._sep_group = bound_group("sep")
        if self._sep_group is not None and self._sep_group.nranks < 2:
            self._sep_group = None
        if self._sep_group is not None and zero_stage:
            raise NotImplementedError(
                "TrainStep(zero_stage=%d) on a mesh whose 'sep' axis has %d "
                "ranks: ZeRO over sequence shards is not ported (ROADMAP.md "
                "§A5)" % (zero_stage, self._sep_group.nranks))
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.num_inputs = num_inputs
        self._model_params = {n: p for n, p in model.named_parameters()
                              if p.requires_grad}
        # the tensor-parallel shards, by name, with their group
        self._mp_groups = {n: p.mp_group
                           for n, p in self._model_params.items()
                           if getattr(p, "mp_group", None) is not None}
        if not self._model_params:
            raise ValueError("TrainStep: the model has no trainable "
                             "parameters")
        # on the model's dtypes, before the f32 promotion: a group whose
        # members mix dtypes stays unstacked
        self._stack = (_stack_layout(self._model_params) if stack_layers
                       else {})
        multi = getattr(optimizer, "_multi_precision", None) is not False
        self._compute_dtypes = {}
        self.params = {}
        for n, p in self._model_params.items():
            if multi and p.dtype in _LOW_PRECISION:
                self._compute_dtypes[n] = p.dtype
            self.params[n] = p.detach().to(
                torch.float32 if n in self._compute_dtypes else p.dtype,
                copy=True)
        self.buffers = dict(model.named_buffers())
        # flat_master: [(g0, g1, the model-side buffer, member names)] per
        # compute dtype, members contiguous in the f32 master
        self._flat_groups = []
        if flat_master:
            self._pack_flat()
        # stack_layers: the model-side (L, ...) buffer of each template
        self._stack_bufs = {}
        if self._stack:
            self._pack_stacked()
            for template, names in self._stack.items():
                if names[0] in self._mp_groups:
                    self._mp_groups[template] = self._mp_groups[names[0]]
        # ZeRO: this rank's slices of the masters; the slots are made on
        # them, and under stage 3 the masters rest as them
        self._zero = None
        self._zero_stale = False
        if zero_stage:
            from ..distributed.sharding import ZeroPartition
            self._zero = ZeroPartition(self.params, zero_stage, zero_axis)
            local = self._zero.cut_all(self.params)
            self.opt_state = optimizer.init_state(local)
            if self._zero.stage >= 3:
                self.params = {n: t.clone() if self._zero.sliced(n) else t
                               for n, t in local.items()}
        else:
            self.opt_state = optimizer.init_state(self.params)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))
        for m in model.modules():
            if hasattr(m, "generator"):
                m.generator = self.generator

    def _pack_flat(self):
        members = [n for n, v in self.params.items()
                   if v.dtype == torch.float32
                   and v.numel() < _FLAT_MAX_ELEMS
                   and n not in self._mp_groups]
        # same-compute-dtype members contiguous, so each group casts once
        members.sort(key=lambda n: (str(self._compute_dtypes.get(n, "")), n))
        if len(members) < 2:
            return
        by_dtype = {}
        for n in members:
            by_dtype.setdefault(self._compute_dtypes.get(n), []).append(n)
        off = 0
        with torch.no_grad():
            for dt, names in by_dtype.items():
                size = sum(self.params[n].numel() for n in names)
                # the model's parameters of the group become views of one
                # buffer in their dtype, which the write-back fills with
                # one cast
                buf = torch.empty(size, dtype=dt or torch.float32,
                                  device=self.device)
                o = 0
                for n in names:
                    p = self._model_params[n]
                    view = buf[o:o + p.numel()].view(p.shape)
                    view.copy_(p)
                    p.data = view
                    o += p.numel()
                self._flat_groups.append((off, off + size, buf, names))
                off += size
        self.params[_FLAT_KEY] = torch.cat(
            [self.params.pop(n).reshape(-1) for n in members])

    def _pack_stacked(self):
        """Each template's masters into one (L, ...) tensor, and its
        members' model parameters into views of one (L, ...) buffer in
        their dtype."""
        with torch.no_grad():
            for template, names in self._stack.items():
                members = [self._model_params[n] for n in names]
                buf = torch.empty((len(names),) + tuple(members[0].shape),
                                  dtype=members[0].dtype, device=self.device)
                for i, p in enumerate(members):
                    buf[i].copy_(p)
                    p.data = buf[i]
                self._stack_bufs[template] = buf
                self.params[template] = torch.stack(
                    [self.params.pop(n) for n in names])
                dt = self._compute_dtypes.pop(names[0], None)
                for n in names[1:]:
                    self._compute_dtypes.pop(n, None)
                if dt is not None:
                    self._compute_dtypes[template] = dt

    def _unstacked(self, tree):
        """Name-keyed ``tree`` with each stacked template split back into
        per-layer entries (views)."""
        tree = dict(tree)
        for template, names in self._stack.items():
            if template in tree:
                stacked = tree.pop(template)
                for i, n in enumerate(names):
                    tree[n] = stacked[i]
        return tree

    def _restacked(self, tree, stack):
        """Inverse of :meth:`_unstacked` for incoming per-layer entries
        (``stack`` joins one template's members)."""
        tree = dict(tree)
        for template, names in self._stack.items():
            if template not in tree and all(n in tree for n in names):
                tree[template] = stack([tree.pop(n) for n in names])
        return tree

    def _flat_grad(self):
        """The flat f32 gradient: each dtype group's member grads
        concatenated, then cast once into its slice."""
        flat = torch.empty_like(self.params[_FLAT_KEY])
        for g0, g1, _buf, names in self._flat_groups:
            flat[g0:g1].copy_(torch.cat([
                (p.grad if p.grad is not None
                 else torch.zeros_like(p)).reshape(-1)
                for p in (self._model_params[n] for n in names)]))
        return flat

    def _flat_members(self):
        """(name, offset, size, shape) of each flat member."""
        for g0, _g1, _buf, names in self._flat_groups:
            o = g0
            for n in names:
                p = self._model_params[n]
                yield n, o, p.numel(), p.shape
                o += p.numel()

    def _unflat(self, tree):
        """Name-keyed ``tree`` with its flat entry split back into
        per-name views."""
        tree = dict(tree)
        if self._flat_groups and _FLAT_KEY in tree:
            flat = tree.pop(_FLAT_KEY)
            for n, o, size, shape in self._flat_members():
                tree[n] = flat[o:o + size].view(shape)
        return tree

    def _as_tensor(self, x):
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return torch.as_tensor(np.asarray(x), device=self.device)

    def _local_batch(self, batch):
        """This rank's rows of each batch element whose spec shards its
        first dimension (the batch as it is under ``local_batch=True``)."""
        if self._batch_axis is None or self._local_rows_given:
            return batch
        from ..distributed.parallel_base import local_rows
        specs = self._in_specs
        if len(specs) == 1 and len(batch) > 1:
            specs = specs * len(batch)
        return [local_rows(b, self._batch_axis)
                if s and s[0] is not None else b
                for b, s in zip(batch, specs)]

    @torch.no_grad()
    def _average_grads(self, grads, group=None, average=True):
        """Average ``grads`` over the batch axis's group (or sum them over
        ``group`` with ``average=False``) in place: the flat master's
        buffer by itself, the other grads concatenated, one all-reduce a
        dtype."""
        from ..distributed import collective as _coll
        g = self._dp_group if group is None else group
        groups = [(grads[_FLAT_KEY].dtype, [_FLAT_KEY])] \
            if _FLAT_KEY in grads else []
        by_dtype = {}
        for n in sorted(grads):
            if n != _FLAT_KEY:
                by_dtype.setdefault(grads[n].dtype, []).append(n)
        for dt, names in groups + list(by_dtype.items()):
            if len(names) == 1:
                flat = grads[names[0]].reshape(-1)
            else:
                # one buffer a dtype, kept across steps: a fresh one each
                # step would be a fresh allocation each step
                size = sum(grads[n].numel() for n in names)
                # a buffer a group: the grads may be views of another's
                key = (g.axis, dt)
                flat = self._dp_bufs.get(key)
                if flat is None or flat.numel() != size:
                    flat = self._dp_bufs[key] = torch.empty(
                        size, dtype=dt, device=self.device)
                torch.cat([grads[n].reshape(-1) for n in names], out=flat)
            _coll.all_reduce(flat, group=g)
            if average and g.nranks > 1:
                flat.div_(torch.tensor(float(g.nranks), dtype=flat.dtype,
                                       device=flat.device))
            if len(names) == 1:
                grads[names[0]] = flat.view(grads[names[0]].shape)
                continue
            o = 0
            for n in names:
                k = grads[n].numel()
                grads[n] = flat[o:o + k].view(grads[n].shape)
                o += k

    @torch.no_grad()
    def _zero_grads(self, grads):
        """ZeRO's gradients, in place: the averaged gradient of each
        sliced master as this rank's slice of it — reduce-scattered over
        the ZeRO group (stage 2 and 3; after the batch axis's all-reduce
        where the batch is sharded over another axis), or cut from the
        averaged full gradient (stage 1)."""
        z = self._zero
        sliced = [n for n in grads if z.sliced(n)]
        if z.stage >= 2 and self._batch_axis == z.axis:
            # the reduce-scatter is the average over the batch axis
            whole = {n: g for n, g in grads.items() if not z.sliced(n)}
            if whole:
                self._average_grads(whole)
                grads.update(whole)
        elif self._dp_group is not None:
            self._average_grads(grads)
        for n in sliced:
            grads[n] = (z.reduce_scatter(n, grads[n]) if z.stage >= 2
                        else z.cut(n, grads[n]))

    def _zero_masters(self):
        """Stage 3: the full masters gathered from the slices (the
        write-back's input; freed after it)."""
        z = self._zero
        return {n: z.gather(n, t) for n, t in self.params.items()}

    def _shard_groups(self):
        """{name: group or groups} of every master a rank holds a part
        of (tensor-parallel shards, ZeRO slices): the global-norm clip sums
        their squares over them."""
        out = dict(self._mp_groups)
        z = self._zero
        if z is not None:
            for n in self.params:
                if z.sliced(n):
                    mp = out.get(n)
                    out[n] = z.group if mp is None else (mp, z.group)
        return out

    def __call__(self, *batch):
        if self._zero_stale:
            # stage 3: the last step's update reaches the model now
            self._write_model_params(self._zero_masters())
            self._zero_stale = False
        batch = [self._as_tensor(b) for b in self._local_batch(batch)]
        lr = self.optimizer.get_lr()
        self.model.train()
        for p in self._model_params.values():
            p.grad = None
        out = self.model(*batch[:self.num_inputs])
        outs = out if isinstance(out, tuple) else (out,)
        loss = self.loss_fn(*outs, *batch[self.num_inputs:])
        if self._sep_group is not None and not getattr(loss, "sep_share",
                                                       False):
            # any other loss of the rank's rows (a mean of them, say)
            # would not sum over 'sep' to the loss of the whole sequences
            raise NotImplementedError(
                "TrainStep on a mesh whose 'sep' axis has %d ranks takes a "
                "loss that is the rank's share of the global one, as "
                "GPTPretrainingCriterion gives; this loss_fn's is not "
                "(ROADMAP.md §A5)" % self._sep_group.nranks)
        loss.backward()
        with torch.no_grad():
            grads = {}
            if self._flat_groups:
                grads[_FLAT_KEY] = self._flat_grad()
            for template, names in self._stack.items():
                g = torch.stack([
                    p.grad if p.grad is not None else torch.zeros_like(p)
                    for p in (self._model_params[n] for n in names)])
                grads[template] = (g.float()
                                   if template in self._compute_dtypes
                                   else g)
            for n, p in self._model_params.items():
                # a parameter the loss does not reach gets a zero gradient,
                # as jax.grad gives it
                if n in self.params:
                    g = p.grad if p.grad is not None else torch.zeros_like(p)
                    grads[n] = g.float() if n in self._compute_dtypes else g
                p.grad = None
            if self._sep_group is not None:
                # the ranks' shares of the sequence-sharded gradients
                self._average_grads(grads, self._sep_group, average=False)
            if self._zero is not None:
                self._zero_grads(grads)
            elif self._dp_group is not None:
                self._average_grads(grads)
            # the shards' groups only where there are shards: the
            # optimizer's interface is otherwise the JAX step's
            groups = self._shard_groups()
            extra = {"mp_groups": groups} if groups else {}
            z = self._zero
            # this rank's slices (stage 3's masters rest as them)
            params = (self.params if z is None or z.stage >= 3
                      else z.cut_all(self.params))
            params, self.opt_state = self.optimizer.apply_gradients(
                params, grads, self.opt_state, lr, **extra)
            if z is None:
                self.params = params
                self._write_model_params()
            elif z.stage >= 3:
                self.params = params
                self._zero_stale = True
            else:
                self.params = {n: z.gather(n, t) for n, t in params.items()}
                self._write_model_params()
        sched = self.optimizer._learning_rate
        if isinstance(sched, LRScheduler):
            sched.step()
        loss = loss.detach()
        from ..distributed import collective as _coll
        if self._sep_group is not None:
            # the shares' sum
            loss = _coll.all_reduce(loss.clone(), group=self._sep_group)
        if self._dp_group is not None:
            loss = _coll.all_reduce(loss.clone(), op=_coll.ReduceOp.AVG,
                                    group=self._dp_group)
        return loss

    @torch.no_grad()
    def _write_model_params(self, params=None):
        """The masters (``params``, default the step's) cast into the
        model's parameters."""
        params = self.params if params is None else params
        for g0, g1, buf, names in self._flat_groups:
            buf.copy_(params[_FLAT_KEY][g0:g1])
            # a parameter repointed by ``p.data = view`` keeps its own
            # version counter, which a write through the buffer leaves
            # alone: bump it, so readers that key on ``_version`` (the
            # serving engine's prefix-cache purge) see the step
            for n in names:
                increment_version(self._model_params[n])
        for template, names in self._stack.items():
            # one cast of the (L, ...) master into the members' buffer;
            # the members are views of it, repointed like the flat ones
            self._stack_bufs[template].copy_(params[template])
            for n in names:
                increment_version(self._model_params[n])
        for n, p in self._model_params.items():
            if n in params:
                p.copy_(params[n])

    def sync_to_model(self):
        """Write the masters into the model's parameters (each step
        already does, but for ZeRO stage 3, whose masters rest as slices;
        kept for the JAX step's interface).  A collective under stage 3:
        every rank of the ZeRO group calls it."""
        if self._zero is not None and self._zero.stage >= 3:
            self._write_model_params(self._zero_masters())
            self._zero_stale = False
            return
        self._write_model_params()

    # -- checkpoint contract ------------------------------------------------
    def state_dict(self):
        """Everything needed to resume: f32 master params, buffers,
        optimizer slots and step, and the LR scheduler's state."""
        opt_extra = {}
        sched = self.optimizer._learning_rate
        if hasattr(sched, "state_dict"):
            opt_extra["lr_scheduler"] = sched.state_dict()
        slots = {n: dict(s) for n, s in self.opt_state["slots"].items()}
        params = self.params
        z = self._zero
        if z is not None:
            # the full slots and masters, gathered from the slices
            slots = {n: {k: z.gather(n, v) if _sliceable(v) else v
                         for k, v in s.items()} for n, s in slots.items()}
            if z.stage >= 3:
                params = self._zero_masters()
        for template, names in self._stack.items():
            grp = slots.pop(template)
            for i, n in enumerate(names):
                slots[n] = {k: v[i] for k, v in grp.items()}
        if _FLAT_KEY in slots:
            flat = slots.pop(_FLAT_KEY)
            for n, o, size, shape in self._flat_members():
                slots[n] = {k: v[o:o + size].view(shape)
                            for k, v in flat.items()}
        return {"params": self._unstacked(self._unflat(params)),
                "buffers": dict(self.buffers),
                "opt_state": {
                    "slots": slots,
                    "step": torch.tensor(self.opt_state["step"],
                                         dtype=torch.int32)},
                "opt_extra": opt_extra}

    def set_state_dict(self, state):
        """Restore from :meth:`state_dict` output (or
        ``convert.train_state_from_numpy``).  Every tensor is copied onto
        this step's device in the dtype the step holds it in, and the
        masters are written into the model."""
        def place_like(new, old):
            return torch.as_tensor(new).to(device=old.device,
                                           dtype=old.dtype, copy=True)
        def stack(values):
            return torch.stack([torch.as_tensor(v) for v in values])
        params = self._restacked(state["params"], stack)
        in_slots = self._restacked(
            state["opt_state"]["slots"],
            lambda per: {k: stack([p[k] for p in per]) for k in per[0]})
        if self._flat_groups and _FLAT_KEY not in params:
            flat = [n for n, *_ in self._flat_members()]
            # incoming per-name entries may carry a compute dtype (bf16);
            # the flat master is f32
            params[_FLAT_KEY] = torch.cat(
                [torch.as_tensor(params.pop(n)).float().reshape(-1)
                 for n in flat])
            per = [in_slots.pop(n) for n in flat]
            in_slots[_FLAT_KEY] = {
                k: torch.cat([torch.as_tensor(p[k]).reshape(-1)
                              for p in per]) for k in per[0]}
        names = set(self.params)
        if set(params) != names:
            raise KeyError("state params differ: missing %s, unexpected %s"
                           % (sorted(names - set(params)),
                              sorted(set(params) - names)))
        z = self._zero
        if z is not None:
            # this rank's slices of the full masters and slots
            if z.stage >= 3:
                params = {n: z.cut(n, torch.as_tensor(v))
                          for n, v in params.items()}
            in_slots = {n: {k: z.cut(n, torch.as_tensor(v))
                            if _sliceable(v) else v for k, v in s.items()}
                        for n, s in in_slots.items()}
        self.params = {n: place_like(v, self.params[n])
                       for n, v in params.items()}
        with torch.no_grad():
            for n, v in state.get("buffers", {}).items():
                self.buffers[n].copy_(torch.as_tensor(v))
        slots = {}
        for n, old in self.opt_state["slots"].items():
            new = in_slots[n]
            if set(new) != set(old):
                raise KeyError("%s: optimizer slots %s, state has %s"
                               % (n, sorted(old), sorted(new)))
            slots[n] = {k: place_like(new[k], old[k]) for k in old}
        self.opt_state = {"slots": slots,
                          "step": int(state["opt_state"]["step"])}
        sched = self.optimizer._learning_rate
        saved = state.get("opt_extra", {}).get("lr_scheduler")
        if saved is not None and hasattr(sched, "set_state_dict"):
            sched.set_state_dict(dict(saved))
        self.sync_to_model()


def _sliceable(v):
    return getattr(v, "ndim", 0) > 0


def _batch_axis(in_shardings):
    """(the mesh axis that shards the batch's first dimension, the specs
    as a list), or (None, None) without ``in_shardings``.  A spec may
    shard the first dimension over one axis, and the second over
    ``sep`` (the GPT's sequence sharding, which the model does itself)."""
    if in_shardings is None:
        return None, None
    from ..distributed.mesh import PartitionSpec
    specs = in_shardings
    if isinstance(specs, PartitionSpec) or not isinstance(specs,
                                                          (list, tuple)):
        specs = [specs]

    def one(s):
        s = getattr(s, "spec", s)
        return () if s is None else (s,) if isinstance(s, str) else tuple(s)
    specs = [one(s) for s in specs]
    axes = set()
    for spec in specs:
        for dim, axis in enumerate(spec):
            if axis is None:
                continue
            names = axis if isinstance(axis, (tuple, list)) else (axis,)
            if dim == 1 and tuple(names) == ("sep",):
                continue
            if dim > 0 or len(names) != 1:
                raise NotImplementedError(
                    "TrainStep(in_shardings=%r): only the batch's first "
                    "dimension over one mesh axis, and its second over "
                    "'sep', are ported (ROADMAP.md §A5)" % (in_shardings,))
            if names[0] == "sep":
                raise ValueError(
                    "TrainStep(in_shardings=%r): 'sep' shards the "
                    "sequence, the batch's second dimension"
                    % (in_shardings,))
            axes.add(names[0])
    if len(axes) > 1:
        raise ValueError("in_shardings shard the batch over several axes: "
                         "%s" % sorted(axes))
    return (axes.pop() if axes else None), specs


def _flat_eligible(optimizer, zero_stage, stack_layers) -> bool:
    """Whether ``flat_master`` keeps the update's math: only when the
    optimizer update and the grad clip are uniform elementwise over
    parameters (the JAX step's ``_flat_eligible``).

    * ZeRO lays slots and params out per name over the mesh.
    * stack_layers is the competing layout.
    * Lamb computes per-parameter trust norms (``_flat_safe = False``).
    * AdamW's ``apply_decay_param_fun`` makes weight decay per name.
    * ClipGradByNorm clips per-parameter norms (a global-norm clip is
      fine: the norm over the flat buffer is the tree's norm).
    """
    if zero_stage or stack_layers:
        return False
    if getattr(optimizer, "_flat_safe", True) is False:
        return False
    if getattr(optimizer, "_apply_decay_param_fun", None) is not None:
        return False
    from ..nn.clip import ClipGradByNorm
    return not isinstance(getattr(optimizer, "_grad_clip", None),
                          ClipGradByNorm)
