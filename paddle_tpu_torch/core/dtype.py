"""Dtype names (port of ``paddle_tpu/core/dtype.py``): paddle's dtype
strings resolved to ``torch.dtype``s."""
from __future__ import annotations

import torch

_ALIASES = {
    "bool": torch.bool,
    "uint8": torch.uint8,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "int": torch.int32,
    "float16": torch.float16,
    "fp16": torch.float16,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
    "float32": torch.float32,
    "fp32": torch.float32,
    "float": torch.float32,
    "float64": torch.float64,
    "double": torch.float64,
}


def convert_dtype(d) -> torch.dtype:
    """A ``torch.dtype`` for a dtype name (``"bfloat16"``, ``"fp32"``, ...)
    or a ``torch.dtype``."""
    if isinstance(d, torch.dtype):
        return d
    if isinstance(d, str):
        key = d.strip().lower()
        if key in _ALIASES:
            return _ALIASES[key]
    raise ValueError("unsupported dtype %r" % (d,))
