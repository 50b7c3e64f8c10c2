"""Seeding (port of ``paddle_tpu/core/random.py``).

The JAX package threads ``jax.random`` keys; the port uses explicit
``torch.Generator``s.  The two never give the same numbers from the same
seed, so tests make their inputs with numpy and hand them to both."""
from __future__ import annotations

import torch


def seed(s: int) -> None:
    """Seed PyTorch's default generators (CPU and every card)."""
    torch.manual_seed(int(s))
