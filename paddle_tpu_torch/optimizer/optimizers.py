"""Concrete optimizers (port of ``paddle_tpu/optimizer/optimizers.py``):
SGD, Momentum, Adam, AdamW, Adagrad, Adadelta, RMSProp, Adamax and Lamb.
Each defines only the pure update: Adam over a list of parameters with
multi-tensor ops, the others per parameter.  Every update except SGD's
and Momentum's runs its math in f32 whatever the storage dtype of the
parameter, in the JAX package's order of operations; their slots are
f32."""
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


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 initial_accumulator_value=0.0):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def init_one(self, p):
        return {"moment": torch.full(p.shape, self._init_acc,
                                     dtype=torch.float32, device=p.device)}

    def update_one(self, g, p, slots, lr, step):
        g = _wd_grad(self, g, p).float()
        acc = slots["moment"] + g.square()
        new_p = p.float() - lr * g / (acc.sqrt() + self._epsilon)
        return new_p.to(p.dtype), {"moment": acc}


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon = epsilon
        self._rho = rho

    def init_one(self, p):
        return {"avg_squared_grad": _zeros32(p),
                "avg_squared_update": _zeros32(p)}

    def update_one(self, g, p, slots, lr, step):
        g = _wd_grad(self, g, p).float()
        rho, eps = self._rho, self._epsilon
        asg = rho * slots["avg_squared_grad"] + (1 - rho) * g.square()
        upd = g * (slots["avg_squared_update"] + eps).sqrt() \
            / (asg + eps).sqrt()
        asu = rho * slots["avg_squared_update"] + (1 - rho) * upd.square()
        new_p = p.float() - lr * upd
        return new_p.to(p.dtype), {"avg_squared_grad": asg,
                                   "avg_squared_update": asu}


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum
        self._centered = centered

    def init_one(self, p):
        s = {"mean_square": _zeros32(p), "momentum": _zeros32(p)}
        if self._centered:
            s["mean_grad"] = _zeros32(p)
        return s

    def update_one(self, g, p, slots, lr, step):
        g = _wd_grad(self, g, p).float()
        rho, eps = self._rho, self._epsilon
        ms = rho * slots["mean_square"] + (1 - rho) * g.square()
        if self._centered:
            mg = rho * slots["mean_grad"] + (1 - rho) * g
            denom = (ms - mg.square() + eps).sqrt()
            new_slots = {"mean_square": ms, "mean_grad": mg}
        else:
            denom = (ms + eps).sqrt()
            new_slots = {"mean_square": ms}
        mom = self._momentum * slots["momentum"] + lr * g / denom
        new_slots["momentum"] = mom
        return (p.float() - mom).to(p.dtype), new_slots


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def init_one(self, p):
        return {"moment": _zeros32(p), "inf_norm": _zeros32(p)}

    def update_one(self, g, p, slots, lr, step):
        g = _wd_grad(self, g, p).float()
        b1, b2 = self._beta1, self._beta2
        m = b1 * slots["moment"] + (1 - b1) * g
        u = torch.maximum(b2 * slots["inf_norm"], g.abs())
        new_p = p.float() - (lr / (1 - b1 ** step)) * m / (u + self._epsilon)
        return new_p.to(p.dtype), {"moment": m, "inf_norm": u}


class Lamb(Optimizer):
    # per-parameter trust-ratio norms: packing params into one flat buffer
    # (TrainStep flat_master) would change the math, so it stays per name
    _flat_safe = False

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._lamb_wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def init_one(self, p):
        return {"moment1": _zeros32(p), "moment2": _zeros32(p)}

    def update_one(self, g, p, slots, lr, step):
        g32, p32 = g.float(), p.float()
        b1, b2 = self._beta1, self._beta2
        m = b1 * slots["moment1"] + (1 - b1) * g32
        v = b2 * slots["moment2"] + (1 - b2) * g32.square()
        mhat = m / (1 - b1 ** step)
        vhat = v / (1 - b2 ** step)
        r = mhat / (vhat.sqrt() + self._epsilon) + self._lamb_wd * p32
        w_norm = p32.square().sum().sqrt()
        r_norm = r.square().sum().sqrt()
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        new_p = p32 - lr * trust * r
        return new_p.to(p.dtype), {"moment1": m, "moment2": v}


def _zeros32(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
