"""Concrete optimizers (port of ``paddle_tpu/optimizer/optimizers.py``):
SGD, Momentum, Adam and AdamW.  Each defines only the pure update:
SGD and Momentum per parameter, Adam over a list of parameters with
multi-tensor ops.  Adam's math runs in f32 whatever the storage dtype
of the parameter and of its moments.  Adagrad, Adadelta, RMSProp, Adamax and
Lamb are not ported yet (ROADMAP.md §A)."""
from __future__ import annotations

import torch

from ..core.dtype import convert_dtype
from .optimizer import Optimizer


def _wd_grad(self, g, p):
    """Coupled weight decay: g + wd * p (L2Decay / float) or
    g + wd * sign(p) (regularizer.L1Decay)."""
    if self._wd and not self._decoupled_wd:
        if getattr(self, "_wd_mode", "l2") == "l1":
            return g + self._wd * torch.sign(p)
        return g + self._wd * p
    return g


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, multi_precision=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)

    def update_one(self, g, p, slots, lr, step):
        g = _wd_grad(self, g, p)
        return p - lr * g, slots


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None, multi_precision=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def init_one(self, p):
        return {"velocity": torch.zeros_like(p, requires_grad=False)}

    def update_one(self, g, p, slots, lr, step):
        g = _wd_grad(self, g, p)
        mu = self._momentum
        v = mu * slots["velocity"] + g
        upd = g + mu * v if self._nesterov else v
        return p - lr * upd, {"velocity": v}


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, name=None,
                 multi_precision=None, amsgrad=False, moment_dtype=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._amsgrad = amsgrad
        # reduced-precision moments (e.g. bf16 storage); the math stays f32
        if moment_dtype is not None:
            self._moment_dtype = convert_dtype(moment_dtype)

    def _mdt(self):
        return self._moment_dtype or torch.float32

    def init_one(self, p):
        mdt = self._mdt()
        slots = {"moment1": torch.zeros(p.shape, dtype=mdt, device=p.device),
                 "moment2": torch.zeros(p.shape, dtype=mdt, device=p.device)}
        if self._amsgrad:
            slots["moment2_max"] = torch.zeros(p.shape, dtype=mdt,
                                               device=p.device)
        return slots

    def update_one(self, g, p, slots, lr, step):
        new_p, new_slots = self.update_many([g], [p], [slots], lr, step)
        return new_p[0], new_slots[0]

    def update_many(self, gs, ps, slots_list, lr, step):
        """The Adam update of many leaves with multi-tensor ops (a few
        launches per operation instead of one per leaf), each operation
        rounded to f32 in the JAX package's order; the moments' storage
        dtype may be lower, the math is f32."""
        gs = [_wd_grad(self, g, p).float() for g, p in zip(gs, ps)]
        ps32 = [p.float() for p in ps]
        b1, b2, mdt = self._beta1, self._beta2, self._mdt()
        # m = b1 m + (1 - b1) g ; v = b2 v + (1 - b2) g^2
        m = torch._foreach_mul([s["moment1"].float() for s in slots_list], b1)
        torch._foreach_add_(m, torch._foreach_mul(gs, 1 - b1))
        v = torch._foreach_mul([s["moment2"].float() for s in slots_list], b2)
        torch._foreach_add_(
            v, torch._foreach_mul(torch._foreach_mul(gs, gs), 1 - b2))
        mhat = torch._foreach_div(m, 1 - b1 ** step)
        new_slots = [{"moment1": a.to(mdt), "moment2": b.to(mdt)}
                     for a, b in zip(m, v)]
        if self._amsgrad:
            vmax = torch._foreach_maximum(
                [s["moment2_max"].float() for s in slots_list], v)
            for slots, a in zip(new_slots, vmax):
                slots["moment2_max"] = a.to(mdt)
            v = vmax
        vhat = torch._foreach_div(v, 1 - b2 ** step)
        if self._decoupled_wd and self._wd:
            ps32 = torch._foreach_mul(ps32, 1.0 - lr * self._wd)
        # p - lr * mhat / (sqrt(vhat) + eps), in that order
        torch._foreach_sqrt_(vhat)
        torch._foreach_add_(vhat, self._epsilon)
        torch._foreach_mul_(mhat, lr)
        torch._foreach_div_(mhat, vhat)
        new_p = torch._foreach_sub(ps32, mhat)
        return [q.to(p.dtype) for q, p in zip(new_p, ps)], new_slots


class AdamW(Adam):
    _decoupled_wd = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=None, name=None,
                 amsgrad=False, moment_dtype=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, name,
                         multi_precision, amsgrad, moment_dtype)
        self._apply_decay_param_fun = apply_decay_param_fun
        if self._wd_mode == "l1":
            # the decoupled p *= (1 - lr * wd) is L2-shaped: an L1Decay
            # coefficient goes through the coupled wd * sign(p) term
            self._decoupled_wd = False
