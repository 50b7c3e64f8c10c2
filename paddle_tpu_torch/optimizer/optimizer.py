"""Optimizer base (port of ``paddle_tpu/optimizer/optimizer.py``).

Every optimizer defines a functional core, ``init_one`` / ``update_one``
over tensors, with two callers, as in the JAX package:

* the eager path: ``opt.step()`` reads each parameter's ``.grad`` and
  writes the updated values into the parameter in place;
* the step path: :class:`paddle_tpu_torch.jit.TrainStep` calls
  ``opt.apply_gradients(params, grads, state, lr)`` over name-keyed
  dictionaries of f32 master tensors.

``update_one`` returns new tensors and never writes its inputs, like the
JAX function it ports; the f32 arithmetic keeps the JAX order of
operations.  Both callers hand the leaves to ``update_many`` in groups
that share their settings, which an optimizer may implement with
multi-tensor ops (Adam does).  A bf16 / f16 parameter on the eager path gets an f32
``master`` slot (unless ``multi_precision=False``), and then every slot
is f32 from the first step.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from .lr import LRScheduler

_LOW_PRECISION = (torch.bfloat16, torch.float16)


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, multi_precision=None):
        if parameters is None:
            raise ValueError("parameters=None: pass model.parameters()")
        self._param_groups = self._build_groups(parameters)
        self._learning_rate = learning_rate
        self.regularization = weight_decay
        self._grad_clip = grad_clip
        self._wd = self._coeff(weight_decay)
        # regularizer.L1Decay flips the coupled term to wd * sign(p)
        self._wd_mode = getattr(weight_decay, "_mode", "l2")
        self._accumulators: Dict[int, dict] = {}
        self._step_count = 0
        self._name = name or type(self).__name__
        # None = an f32 master copy for every bf16 / f16 parameter: without
        # it, lr ~1e-4 updates of bf16 weights vanish below the bf16 ulp
        self._multi_precision = multi_precision
        #: reduced-precision slot dtype (Adam(moment_dtype=...)); None = f32
        self._moment_dtype = None

    def _wants_master(self, p) -> bool:
        if self._multi_precision is False:
            return False
        return p.dtype in _LOW_PRECISION

    def _init_slots(self, p):
        slots = self.init_one(p)
        if self._wants_master(p):
            if self._moment_dtype is None:
                # every slot f32 from step 0, as the master-path update
                # returns f32 slots
                slots = {k: v.float() if v.is_floating_point() else v
                         for k, v in slots.items()}
            slots["master"] = p.detach().to(torch.float32, copy=True)
        return slots

    def _update_leaves(self, names, gs, ps, slots_list, lr, step):
        """``update_one`` over many leaves, each routed through its f32
        master copy when it has one (the JAX package's ``_update_leaf``).

        A name that AdamW's ``apply_decay_param_fun`` rejects updates with
        weight decay off (the JAX package's host-side flip of
        ``self._wd`` around the call).  Leaves that share decay and master
        routing go to one ``update_many`` call.  Returns (new params, new
        slot dicts) in the order given."""
        fn = getattr(self, "_apply_decay_param_fun", None)
        groups = {}
        for i, (n, s) in enumerate(zip(names, slots_list)):
            decay = not (fn is not None and n is not None and self._wd
                         and not fn(n))
            groups.setdefault((decay, "master" in s), []).append(i)
        new_p, new_s = [None] * len(ps), [None] * len(ps)
        saved = self._wd
        try:
            for (decay, master), idx in groups.items():
                self._wd = saved if decay else 0.0
                if not master:
                    out_p, out_s = self.update_many(
                        [gs[i] for i in idx], [ps[i] for i in idx],
                        [slots_list[i] for i in idx], lr, step)
                    for j, i in enumerate(idx):
                        new_p[i], new_s[i] = out_p[j], out_s[j]
                    continue
                inner = [{k: v for k, v in slots_list[i].items()
                          if k != "master"} for i in idx]
                out_m, out_s = self.update_many(
                    [gs[i].float() for i in idx],
                    [slots_list[i]["master"] for i in idx], inner, lr, step)
                for j, i in enumerate(idx):
                    out_s[j]["master"] = out_m[j]
                    new_p[i], new_s[i] = out_m[j].to(ps[i].dtype), out_s[j]
        finally:
            self._wd = saved
        return new_p, new_s

    @staticmethod
    def _coeff(weight_decay):
        if weight_decay is None:
            return 0.0
        if isinstance(weight_decay, (int, float)):
            return float(weight_decay)
        return float(getattr(weight_decay, "_coeff",
                             getattr(weight_decay, "coeff", 0.0)))

    def _build_groups(self, parameters):
        params = list(parameters)
        if params and isinstance(params[0], dict):
            return params
        return [{"params": params}]

    @property
    def _parameter_list(self) -> List[torch.nn.Parameter]:
        out = []
        for g in self._param_groups:
            out.extend(g["params"])
        return out

    # -- lr ------------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._learning_rate = float(value)

    # -- functional core (override in subclasses) ---------------------------
    def init_one(self, p):
        """Per-parameter slot init: tensor -> dict of tensors."""
        return {}

    def update_one(self, g, p, slots, lr, step):
        """Pure update: returns (new_p, new_slots)."""
        raise NotImplementedError

    def update_many(self, gs, ps, slots_list, lr, step):
        """``update_one`` over a list of leaves that share their settings:
        (new params, new slot dicts).  Adam overrides it with multi-tensor
        ops in the same f32 order."""
        out = [self.update_one(g, p, s, lr, step)
               for g, p, s in zip(gs, ps, slots_list)]
        return [o[0] for o in out], [o[1] for o in out]

    # decoupled weight decay? (AdamW overrides)
    _decoupled_wd = False

    # the update is uniform elementwise over parameters, so TrainStep may
    # pack them into one flat buffer (Lamb overrides: per-param trust norms)
    _flat_safe = True

    # -- step-path API -------------------------------------------------------
    def init_state(self, params: Dict[str, torch.Tensor]):
        return {"slots": {k: self._init_slots(p) for k, p in params.items()},
                "step": 0}

    def apply_gradients(self, params, grads, state, lr, mp_groups=None):
        """(new_params, new_state) from name-keyed ``params`` and ``grads``
        (a None grad leaves its parameter and slots as they are).  Names
        are visited in sorted order, the order of the JAX tree flatten,
        which fixes the global-norm clip's summation order.
        ``mp_groups`` ({name: group}) names the tensor-parallel shards,
        whose squares the global-norm clip sums over their group."""
        step = state["step"] + 1
        names = sorted(params)
        groups = None
        if mp_groups:
            groups = [mp_groups.get(n) for n in names]
        g_list = self._clip_tree([grads.get(n) for n in names], groups)
        new_p = {n: params[n] for n in names}
        new_slots = {n: state["slots"][n] for n in names}
        live = [(n, g) for n, g in zip(names, g_list) if g is not None]
        out_p, out_s = self._update_leaves(
            [n for n, _ in live], [g for _, g in live],
            [params[n] for n, _ in live],
            [state["slots"][n] for n, _ in live], lr, step)
        for (n, _), p, s in zip(live, out_p, out_s):
            new_p[n], new_slots[n] = p, s
        return new_p, {"slots": new_slots, "step": step}

    def _clip_tree(self, g_list, groups=None):
        """The clipped gradients.  ``groups`` (one entry a gradient: the
        tensor-parallel group a shard is sliced over, or None for a
        replicated one) makes the global norm the unsharded one
        (:func:`..nn.clip.global_norm_sq`)."""
        from ..nn.clip import (ClipGradByGlobalNorm, ClipGradByNorm,
                               ClipGradByValue, global_norm_sq)
        clip = self._grad_clip
        if clip is None:
            return g_list
        live = [(i, g) for i, g in enumerate(g_list) if g is not None]
        out = list(g_list)
        if isinstance(clip, ClipGradByGlobalNorm):
            if groups is not None and any(x is not None for x in groups):
                total = torch.sqrt(global_norm_sq(
                    [g for _, g in live], [groups[i] for i, _ in live]))
            else:
                total = torch.sqrt(sum(g.float().square().sum()
                                       for _, g in live))
            coef = clip.clip_norm / torch.clamp(total, min=clip.clip_norm)
            for i, g in live:
                out[i] = (g.float() * coef).to(g.dtype)
            return out
        if isinstance(clip, ClipGradByNorm):
            for i, g in live:
                n = torch.sqrt(g.float().square().sum())
                coef = clip.clip_norm / torch.clamp(n, min=clip.clip_norm)
                out[i] = (g.float() * coef).to(g.dtype)
            return out
        if isinstance(clip, ClipGradByValue):
            for i, g in live:
                out[i] = torch.clamp(g, clip.min, clip.max)
            return out
        return g_list

    # -- eager path ----------------------------------------------------------
    @torch.no_grad()
    def step(self):
        """Update every parameter that has a ``.grad`` in place.  A
        parameter's ``name`` attribute, where it has one, is what
        ``apply_decay_param_fun`` sees."""
        params = [p for p in self._parameter_list
                  if p.requires_grad and p.grad is not None]
        self._step_count += 1
        if not params:
            return
        for p in params:
            if id(p) not in self._accumulators:
                self._accumulators[id(p)] = self._init_slots(p)
        grads = self._clip_tree([p.grad.to(p.dtype) for p in params],
                                [getattr(p, "mp_group", None)
                                 for p in params])
        new_p, new_s = self._update_leaves(
            [getattr(p, "name", None) for p in params], grads, params,
            [self._accumulators[id(p)] for p in params], self.get_lr(),
            self._step_count)
        for p, q, s in zip(params, new_p, new_s):
            p.copy_(q)
            self._accumulators[id(p)] = s

    def clear_grad(self, set_to_zero=False):
        for p in self._parameter_list:
            if p.grad is None:
                continue
            if set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        self.clear_grad()
        return None, None

    # -- state dict ----------------------------------------------------------
    def state_dict(self):
        """``{"_step_count": n, "{name or index}@{slot}": tensor, ...}``
        plus ``"LR_Scheduler"``, the JAX package's keys."""
        sd = {"_step_count": self._step_count}
        for i, p in enumerate(self._parameter_list):
            for k, v in (self._accumulators.get(id(p)) or {}).items():
                sd["%s@%s" % (getattr(p, "name", None) or i, k)] = v
        if isinstance(self._learning_rate, LRScheduler):
            sd["LR_Scheduler"] = self._learning_rate.state_dict()
        return sd

    def set_state_dict(self, sd):
        self._step_count = int(sd.get("_step_count", 0))
        if isinstance(self._learning_rate, LRScheduler) \
                and "LR_Scheduler" in sd:
            self._learning_rate.set_state_dict(sd["LR_Scheduler"])
        for i, p in enumerate(self._parameter_list):
            prefix = "%s@" % (getattr(p, "name", None) or i)
            slots = {k[len(prefix):]: torch.as_tensor(v, device=p.device)
                     for k, v in sd.items()
                     if isinstance(k, str) and k.startswith(prefix)}
            if slots:
                self._accumulators[id(p)] = slots

    set_dict = set_state_dict
