"""Weight bridge: a ``paddle_tpu`` state dict, as numpy arrays, into a
``paddle_tpu_torch`` model.

The port keeps the JAX package's parameter names (``gpt.wte.weight``,
``gpt.h.{i}.attn.qkv_proj.weight`` of shape (H, 3H), ...) and its
(in, out) Linear layout, so the bridge is a plain copy by name.  Callers
make the arrays on the JAX side (``{k: np.asarray(v) for k, v in
jax_model.state_dict().items()}``); this module never imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch


def state_dict_from_numpy(arrays):
    """{name: np.ndarray} -> {name: torch.Tensor} (CPU, same dtype; bf16
    arrays arrive through their float32 widening)."""
    out = {}
    for name, a in arrays.items():
        a = np.asarray(a)
        if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
            out[name] = torch.from_numpy(
                a.astype(np.float32)).to(torch.bfloat16)
        else:
            out[name] = torch.from_numpy(np.array(a, copy=True, order="C"))
    return out


def load_paddle_tpu_state(model, arrays):
    """Copy ``arrays`` into ``model``'s parameters by name.  Every name
    and shape must match; each tensor keeps the parameter's dtype and
    device."""
    tensors = state_dict_from_numpy(arrays)
    own = model.state_dict()
    missing = sorted(set(own) - set(tensors))
    extra = sorted(set(tensors) - set(own))
    if missing or extra:
        raise KeyError("state mismatch: missing %s, unexpected %s"
                       % (missing, extra))
    with torch.no_grad():
        for name, t in tensors.items():
            dst = own[name]
            if tuple(dst.shape) != tuple(t.shape):
                raise ValueError("%s: shape %s, model has %s"
                                 % (name, tuple(t.shape), tuple(dst.shape)))
            dst.copy_(t)
    return model
