"""Activation recompute (port of ``paddle_tpu/distributed/recompute.py``).

``recompute(fn, *args)`` runs ``fn`` without keeping the activations
inside it for the backward: they are made again, by a second run of
``fn``, when the backward reaches them.  It is built on
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``; the
reentrant form gives no gradient to the block's parameters when its
input does not require one (the trap the JAX docstring warns of), so
``use_reentrant`` is accepted and ignored, as the JAX function ignores
it.

Dropout in the port draws from explicit ``torch.Generator``s, which
``jit.TrainStep`` sets on every module with a ``generator`` attribute;
``preserve_rng_state`` of ``checkpoint`` saves only PyTorch's default
generators.  So while the forward runs, each explicit generator's state
at its first draw is noted (``core.random.before_draw``, called by the
dropout itself, so ``fn`` may be a module, a bound method or any
closure); the second run starts each at that state, and the state the
forward left is put back after it: the second run draws the forward's
masks, and the next draw of the stream is the one it would be without
recompute.
"""
from __future__ import annotations

import contextlib

from torch.utils.checkpoint import checkpoint

from ..core.random import record_draws


class _Replay:
    """Context of the second run: each generator the forward drew from
    at its state before that draw, and back at its current state after."""

    def __init__(self, kept):
        self._kept = kept
        self._resume = None

    def __enter__(self):
        self._resume = [(g, g.get_state()) for g, _ in self._kept.values()]
        for g, state in self._kept.values():
            g.set_state(state)
        return self

    def __exit__(self, *exc):
        for g, state in self._resume:
            g.set_state(state)
        return False


def recompute(function, *args, use_reentrant=True, preserve_rng_state=True,
              **kwargs):
    """Run ``function(*args, **kwargs)`` with its activations recomputed
    in the backward.  ``function`` may be a module or any callable over
    tensors; its parameters get their gradients whether or not the
    inputs require one."""
    del use_reentrant     # always the non-reentrant form (module docstring)

    def contexts():
        if not preserve_rng_state:
            return contextlib.nullcontext(), contextlib.nullcontext()
        kept = {}
        return record_draws(kept), _Replay(kept)
    return checkpoint(function, *args, use_reentrant=False,
                      preserve_rng_state=preserve_rng_state,
                      context_fn=contexts, **kwargs)


def recompute_sequential(functions, x, segments=1):
    """Run the layers of ``functions`` (a Sequential or a list) on ``x``
    in ``segments`` chunks, each under :func:`recompute`."""
    layers = list(functions)
    n = len(layers)
    per = max(n // max(segments, 1), 1)
    for i in range(0, n, per):
        x = recompute(_chain(layers[i:i + per]), x)
    return x


def _chain(layers):
    """Consecutive layers as one callable."""
    def run(x):
        for layer in layers:
            x = layer(x)
        return x
    return run
