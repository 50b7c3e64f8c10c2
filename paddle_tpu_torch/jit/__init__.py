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

``state_dict`` / ``set_state_dict`` use the JAX step's layout:
``{"params", "buffers", "opt_state": {"slots", "step"}, "opt_extra"}``.
The JAX step's options ``zero_stage``, ``stack_layers``,
``flat_master=True`` and ``in_shardings`` are not ported yet and raise.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..core.device import resolve_device
from ..optimizer.lr import LRScheduler

_LOW_PRECISION = (torch.bfloat16, torch.float16)

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
        for opt_name, asked in (("zero_stage", bool(zero_stage)),
                                ("stack_layers", bool(stack_layers)),
                                ("flat_master", bool(flat_master)),
                                ("in_shardings", in_shardings is not None)):
            if asked:
                raise NotImplementedError(
                    "TrainStep(%s=...) is not ported yet (ROADMAP.md §A)"
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
        self.opt_state = optimizer.init_state(self.params)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))
        for m in model.modules():
            if hasattr(m, "generator"):
                m.generator = self.generator

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
            for n, p in self._model_params.items():
                # a parameter the loss does not reach gets a zero gradient,
                # as jax.grad gives it
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
        for n, p in self._model_params.items():
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
        return {"params": dict(self.params), "buffers": dict(self.buffers),
                "opt_state": {
                    "slots": {n: dict(s) for n, s in
                              self.opt_state["slots"].items()},
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
        names = set(self.params)
        if set(state["params"]) != names:
            raise KeyError("state params differ: missing %s, unexpected %s"
                           % (sorted(names - set(state["params"])),
                              sorted(set(state["params"]) - names)))
        self.params = {n: place_like(v, self.params[n])
                       for n, v in state["params"].items()}
        with torch.no_grad():
            for n, v in state.get("buffers", {}).items():
                self.buffers[n].copy_(torch.as_tensor(v))
        slots = {}
        for n, old in self.opt_state["slots"].items():
            new = state["opt_state"]["slots"][n]
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
