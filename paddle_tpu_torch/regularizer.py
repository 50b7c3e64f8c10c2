"""L1Decay / L2Decay (port of ``paddle_tpu/regularizer.py``, a copy).

Accepted by ``optimizer(weight_decay=...)``: L2Decay adds ``coeff * p`` to
the gradient (coupled decay, the reference's append_regularization_ops
semantics); L1Decay adds ``coeff * sign(p)``.  AdamW keeps its decoupled
decay for float/L2Decay coefficients.
"""
from __future__ import annotations

__all__ = ["L1Decay", "L2Decay"]


class WeightDecayRegularizer:
    _mode = "l2"

    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)
        self._coeff = float(coeff)  # legacy alias read by Optimizer._coeff

    def __repr__(self):
        return "%s(coeff=%g)" % (type(self).__name__, self.coeff)


class L1Decay(WeightDecayRegularizer):
    r"""loss += coeff * sum(|p|)  =>  grad += coeff * sign(p)."""
    _mode = "l1"


class L2Decay(WeightDecayRegularizer):
    r"""loss += 0.5 * coeff * sum(p^2)  =>  grad += coeff * p."""
    _mode = "l2"
