"""Hybrid-parallel optimizer wrapper (port of
``paddle_tpu/distributed/fleet/hybrid_optimizer.py``; reference:
fleet/meta_optimizers/dygraph_optimizer/hybrid_parallel_optimizer.py).

Its one non-trivial duty in the reference is the mp-aware global-norm
clip: under tensor parallelism a rank holds a slice of each distributed
parameter, so the global norm sums the shards' squares over the mp group
and counts the replicated parameters once.  The port's optimizers do that
already (``Optimizer._clip_tree`` over :func:`...nn.clip.global_norm_sq`,
fed each parameter's ``mp_group``), so the wrapper keeps the optimizer's
clip as it is and passes every call through.
"""
from __future__ import annotations

__all__ = ["HybridParallelOptimizer"]


class HybridParallelOptimizer:
    """reference: hybrid_parallel_optimizer.py — wraps the user optimizer;
    step / clear_grad / minimize / state dicts pass through, and so does
    any other attribute."""

    def __init__(self, optimizer, hcg=None, strategy=None):
        self._inner_opt = optimizer
        self._hcg = hcg
        self._strategy = strategy

    def __getattr__(self, item):
        inner = self.__dict__.get("_inner_opt")
        if inner is None:
            # copy/pickle probe attributes before __init__ runs — must be
            # AttributeError, not KeyError, for hasattr/copy fallbacks
            raise AttributeError(item)
        return getattr(inner, item)

    def step(self):
        self._inner_opt.step()

    def clear_grad(self, *a, **k):
        self._inner_opt.clear_grad(*a, **k)

    def minimize(self, loss, **kw):
        return self._inner_opt.minimize(loss, **kw)

    def state_dict(self):
        return self._inner_opt.state_dict()

    def set_state_dict(self, sd):
        return self._inner_opt.set_state_dict(sd)
