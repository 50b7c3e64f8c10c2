"""Seeding (port of ``paddle_tpu/core/random.py``).

The JAX package threads ``jax.random`` keys; the port uses explicit
``torch.Generator``s.  The two never give the same numbers from the same
seed, so tests make their inputs with numpy and hand them to both."""
from __future__ import annotations

import contextlib
import threading

import torch


def seed(s: int) -> None:
    """Seed PyTorch's default generators (CPU and every card)."""
    torch.manual_seed(int(s))


# The dropout of the port draws from explicit generators.  While the
# forward of a ``distributed.recompute`` runs, each of these draws first
# notes its generator's state in every open record, so that the second
# run in the backward can draw the same masks.
_records = threading.local()


def before_draw(generator):
    """Note ``generator``'s state in every open record that does not hold
    it yet; the port's dropout calls this before it draws a mask from an
    explicit generator."""
    for kept in getattr(_records, "open", ()):
        if id(generator) not in kept:
            kept[id(generator)] = (generator, generator.get_state())


@contextlib.contextmanager
def record_draws(kept):
    """Within the block, :func:`before_draw` notes into ``kept`` (a dict)
    the state of each generator at its first draw."""
    stack = getattr(_records, "open", None)
    if stack is None:
        stack = _records.open = []
    stack.append(kept)
    try:
        yield kept
    finally:
        stack.pop()
