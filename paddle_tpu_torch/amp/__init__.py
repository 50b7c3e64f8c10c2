"""Mixed precision (port of ``paddle_tpu/amp/__init__.py`` ``decorate``).

``decorate(model, level="O2", dtype="bfloat16")`` casts every float32
parameter to the AMP dtype except the LayerNorm parameters, which stay in
float32 (the reference's keep_batch_norm_fp32).  The LayerNorm math then
runs its statistics in f32 and returns the activation dtype.
"""
from __future__ import annotations

import torch

from ..core.dtype import convert_dtype
from ..nn.layer.norm import LayerNorm


def decorate(models, optimizers=None, level="O2", dtype="bfloat16"):
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    if level == "O2":
        dt = convert_dtype(dtype)
        for m in model_list:
            for layer in m.modules():
                if isinstance(layer, LayerNorm):
                    continue
                for p in layer.parameters(recurse=False):
                    if p.dtype == torch.float32:
                        p.data = p.data.to(dt)
    if optimizers is None:
        return models if single else model_list
    return (models if single else model_list), optimizers
