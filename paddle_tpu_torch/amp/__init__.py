"""Mixed precision (port of ``paddle_tpu/amp/__init__.py``: ``decorate``
and ``GradScaler``).

``decorate(model, level="O2", dtype="bfloat16")`` casts every float32
parameter to the AMP dtype except the LayerNorm parameters, which stay in
float32 (the reference's keep_batch_norm_fp32): those of a LayerNorm
module, and those a module holding LayerNorm parameters inline names in
its ``_amp_keep_fp32_params`` (the scan-layers GPT's stacked
``ln1_w``, ...).  The LayerNorm math then
runs its statistics in f32 and returns the activation dtype.
``GradScaler`` is dynamic loss scaling for fp16; bf16 needs none, and
``enable=False`` makes it a pass-through.  Its ``step`` fires the
``amp.found_inf`` faultpoint after the finite check (``ForceFoundInf``
there simulates an overflow) and counts ``train.amp_skipped_steps``.
"""
from __future__ import annotations

import torch

from ..core.dtype import convert_dtype
from ..nn.layer.norm import LayerNorm
from ..robustness.faultpoints import declare as _declare
from ..robustness.faultpoints import faultpoint

_declare("amp.found_inf",
         "override the GradScaler's found-inf verdict (ForceFoundInf "
         "simulates an fp16 overflow step without overflow-scale grads)")


def decorate(models, optimizers=None, level="O2", dtype="bfloat16"):
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    if level == "O2":
        dt = convert_dtype(dtype)
        for m in model_list:
            for layer in m.modules():
                if isinstance(layer, LayerNorm):
                    continue
                keep = getattr(layer, "_amp_keep_fp32_params", ())
                for name, p in layer.named_parameters(recurse=False):
                    if name not in keep and p.dtype == torch.float32:
                        p.data = p.data.to(dt)
    if optimizers is None:
        return models if single else model_list
    return (models if single else model_list), optimizers


class GradScaler:
    """Dynamic loss scaling over an eager optimizer's ``.grad``s.

    ``unscale_`` divides the gradients by the scale once per step (a
    second call before ``step`` does nothing) and notes whether any is
    non-finite; ``step`` then skips the update on a non-finite gradient
    (``last_step_skipped``) and adapts the scale: times ``decr_ratio``
    after ``decr_every_n_nan_or_inf`` bad steps, times ``incr_ratio``
    after ``incr_every_n_steps`` good ones."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._last_skipped = False
        self._already_unscaled = set()

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        if not self._enable:
            return
        if id(optimizer) in self._already_unscaled:
            return   # never divide by the scale twice (explicit + step())
        self._already_unscaled.add(id(optimizer))
        inv = 1.0 / self._scale
        finite = []
        for p in optimizer._parameter_list:
            if p.grad is not None:
                p.grad = p.grad * inv
                finite.append(torch.isfinite(p.grad).all())
        # one host read for the whole parameter list
        self._found_inf = bool(finite) and not bool(torch.stack(finite).all())

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            self._last_skipped = False
            return
        self.unscale_(optimizer)   # a no-op if the caller already unscaled
        ctx = faultpoint("amp.found_inf", found_inf=self._found_inf)
        if ctx is not None:
            self._found_inf = bool(ctx["found_inf"])
        # recorded BEFORE _update resets the flag: DivergenceSentinel reads
        # it to tell a skipped update (parameters intact) from a divergence
        self._last_skipped = self._found_inf
        if self._found_inf:
            from ..observability import registry as _metrics
            _metrics.counter("train.amp_skipped_steps").inc()
        else:
            optimizer.step()
        self._already_unscaled.discard(id(optimizer))
        self._update()

    def minimize(self, optimizer, scaled_loss):
        self.step(optimizer)

    def update(self):
        pass   # folded into step(), as in the reference eager path

    def _update(self):
        if not self._dynamic:
            self._found_inf = False
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    @property
    def last_step_skipped(self) -> bool:
        """True iff the most recent ``step()`` skipped the optimizer update
        because non-finite gradients were found."""
        return self._last_skipped

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_loss_scaling(self):
        return self._scale

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def state_dict(self):
        return {"scale": self._scale, "good_steps": self._good_steps,
                "bad_steps": self._bad_steps, "enable": self._enable}

    def load_state_dict(self, sd):
        self._scale = sd["scale"]
        self._good_steps = sd["good_steps"]
        self._bad_steps = sd["bad_steps"]

    set_state_dict = load_state_dict
