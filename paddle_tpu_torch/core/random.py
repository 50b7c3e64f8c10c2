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


def get_rng_state():
    """The state of the generators the port's draws come from by default:
    PyTorch's CPU generator and, in a process that uses cards, each
    card's (JAX's ``paddle_tpu/core/random.py:74-79`` keeps one key and a
    counter).  Explicit generators a model or a step holds are not in it:
    a checkpoint saves those itself (``TrainEpochRange
    .register_train_step``)."""
    return {"cpu": torch.get_rng_state(),
            "cuda": (torch.cuda.get_rng_state_all()
                     if torch.cuda.is_initialized() else [])}


def set_rng_state(state):
    """Restore :func:`get_rng_state`'s output.  Card states are restored
    when the process has as many cards as were saved from."""
    torch.set_rng_state(torch.as_tensor(state["cpu"], dtype=torch.uint8))
    cuda = state.get("cuda") or []
    if cuda and torch.cuda.is_available() \
            and len(cuda) == torch.cuda.device_count():
        torch.cuda.set_rng_state_all(
            [torch.as_tensor(s, dtype=torch.uint8) for s in cuda])


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
