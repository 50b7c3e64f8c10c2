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
checkpoint loads across the modes.  The JAX step's options
``zero_stage`` and ``in_shardings`` are not ported yet (ROADMAP.md §A5)
and raise.
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
    """

    def __init__(self, model: torch.nn.Module, loss_fn: Callable, optimizer,
                 num_inputs: int = 1, in_shardings=None, donate=True,
                 zero_stage=None, zero_axis: str = "sdp",
                 stack_layers: bool = False, flat_master=None, seed: int = 0,
                 device=None):
        if flat_master and not _flat_eligible(optimizer, zero_stage,
                                              stack_layers):
            raise ValueError(
                "flat_master=True is incompatible with this configuration "
                "(ZeRO/stack_layers/per-param optimizer semantics — see "
                "_flat_eligible)")
        for opt_name, asked in (("zero_stage", bool(zero_stage)),
                                ("in_shardings", in_shardings is not None)):
            if asked:
                raise NotImplementedError(
                    "TrainStep(%s=...) is not ported yet (ROADMAP.md §A5)"
                    % opt_name)
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.num_inputs = num_inputs
        self._model_params = {n: p for n, p in model.named_parameters()
                              if p.requires_grad}
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
        self.opt_state = optimizer.init_state(self.params)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))
        for m in model.modules():
            if hasattr(m, "generator"):
                m.generator = self.generator

    def _pack_flat(self):
        members = [n for n, v in self.params.items()
                   if v.dtype == torch.float32
                   and v.numel() < _FLAT_MAX_ELEMS]
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

    def __call__(self, *batch):
        batch = [self._as_tensor(b) for b in batch]
        lr = self.optimizer.get_lr()
        self.model.train()
        for p in self._model_params.values():
            p.grad = None
        out = self.model(*batch[:self.num_inputs])
        outs = out if isinstance(out, tuple) else (out,)
        loss = self.loss_fn(*outs, *batch[self.num_inputs:])
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
            self.params, self.opt_state = self.optimizer.apply_gradients(
                self.params, grads, self.opt_state, lr)
            self._write_model_params()
        sched = self.optimizer._learning_rate
        if isinstance(sched, LRScheduler):
            sched.step()
        return loss.detach()

    @torch.no_grad()
    def _write_model_params(self):
        for g0, g1, buf, names in self._flat_groups:
            buf.copy_(self.params[_FLAT_KEY][g0:g1])
            # a parameter repointed by ``p.data = view`` keeps its own
            # version counter, which a write through the buffer leaves
            # alone: bump it, so readers that key on ``_version`` (the
            # serving engine's prefix-cache purge) see the step
            for n in names:
                increment_version(self._model_params[n])
        for template, names in self._stack.items():
            # one cast of the (L, ...) master into the members' buffer;
            # the members are views of it, repointed like the flat ones
            self._stack_bufs[template].copy_(self.params[template])
            for n in names:
                increment_version(self._model_params[n])
        for n, p in self._model_params.items():
            if n in self.params:
                p.copy_(self.params[n])

    def sync_to_model(self):
        """Write the masters into the model's parameters (each step
        already does; kept for the JAX step's interface)."""
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
        for template, names in self._stack.items():
            grp = slots.pop(template)
            for i, n in enumerate(names):
                slots[n] = {k: v[i] for k, v in grp.items()}
        if _FLAT_KEY in slots:
            flat = slots.pop(_FLAT_KEY)
            for n, o, size, shape in self._flat_members():
                slots[n] = {k: v[o:o + size].view(shape)
                            for k, v in flat.items()}
        return {"params": self._unstacked(self._unflat(self.params)),
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
        self._write_model_params()


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
