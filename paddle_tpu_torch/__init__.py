"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

The package mirrors ``paddle_tpu``'s module paths and names so that a
reader finds each counterpart, and uses PyTorch idiom inside:
``nn.Module``s, plain functions on tensors, an explicit ``device`` and
explicit ``torch.Generator``s.  Every Pallas kernel on a ported path
becomes a CUDA C++ kernel for Hopper (``csrc/``), built on first use by
:mod:`.kernels._build`, with a plain PyTorch version beside it that the
CPU runs.

The package imports ``torch`` and nothing of JAX or of ``paddle_tpu``.
Entry points (``serving.DecodeEngine``, ``serving.generate``,
``serving.engine_for``) run on ``cuda`` unless the caller passes
``device="cpu"``; without a card and without an explicit CPU they raise.
"""
from __future__ import annotations

from .core.random import seed

__all__ = ["seed"]
