"""Weight and training-state bridge: a ``paddle_tpu`` state dict, or a
``paddle_tpu.jit.TrainStep`` state, as numpy arrays, into the port.

The port keeps the JAX package's parameter names (``gpt.wte.weight``,
``gpt.h.{i}.attn.qkv_proj.weight`` of shape (H, 3H), ...) and its
(in, out) Linear layout, so the bridge is a plain copy by name; a
tensor-parallel rank's shards of it come from
:func:`shard_paddle_tpu_state` (and go back through
:func:`unshard_paddle_tpu_state`).  Callers
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
    device.  A name the arrays lack is allowed where it names the same
    tensor as a name they hold: a tied weight, which the JAX package's
    state dict lists once (a ``PipelineLayer``'s ``SharedLayerDesc``
    head, ``run_function.<i>.shared...``) and PyTorch's under each
    name."""
    tensors = state_dict_from_numpy(arrays)
    own = model.state_dict(keep_vars=True)
    named = {}
    for name, t in own.items():
        named.setdefault(id(t), []).append(name)
    missing = sorted(k for k in set(own) - set(tensors)
                     if not any(a in tensors for a in named[id(own[k])]))
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
            dst.detach().copy_(t)
    return model


def train_state_from_numpy(state):
    """A JAX ``TrainStep.state_dict()`` whose arrays the caller turned into
    numpy, as :meth:`paddle_tpu_torch.jit.TrainStep.set_state_dict` takes
    it: f32 master ``params`` by name, ``buffers``, the optimizer
    ``slots`` per name (``moment1`` / ``moment2`` for AdamW), the
    optimizer ``step`` and the LR scheduler's state (``opt_extra``).
    Tensors come back on the CPU; the step places them."""
    opt = state["opt_state"]
    return {
        "params": state_dict_from_numpy(state["params"]),
        "buffers": state_dict_from_numpy(state.get("buffers", {})),
        "opt_state": {
            "slots": {name: state_dict_from_numpy(slots)
                      for name, slots in opt["slots"].items()},
            "step": int(np.asarray(opt["step"]))},
        "opt_extra": {k: dict(v) for k, v in
                      state.get("opt_extra", {}).items()},
    }


def shard_paddle_tpu_state(arrays, mp_rank, mp_size):
    """The shards that rank ``mp_rank`` of ``mp_size`` holds, in the port's
    Megatron layout, of the JAX package's GPT parameters ``arrays``
    ({name: np.ndarray}): each parameter cut by
    ``models.gpt.megatron_layout`` with ``distributed.parallel_base.
    shard_slice``, the rule ``parallelize`` cuts by (the q, k and v
    columns of the rank's own heads from the fused projection); the
    replicated ones whole."""
    from .distributed.parallel_base import shard_slice
    from .models.gpt import megatron_layout
    out = {}
    for name, a in arrays.items():
        spec, parts = megatron_layout(name)
        a = np.asarray(a)
        out[name] = (a if spec is None else shard_slice(
            a, spec, {"mp": int(mp_rank)}, {"mp": int(mp_size)}, parts))
    return out


def unshard_paddle_tpu_state(shards):
    """Inverse of :func:`shard_paddle_tpu_state`: ``shards`` is the list
    of every rank's dict in rank order; returns the full arrays."""
    from .distributed.parallel_base import unshard_slices
    from .models.gpt import megatron_layout
    out = {}
    for name in shards[0]:
        spec, parts = megatron_layout(name)
        parts_of = [np.asarray(s[name]) for s in shards]
        if spec is None:
            out[name] = parts_of[0]
            continue
        dim = next(d for d, a in enumerate(spec) if a is not None)
        out[name] = unshard_slices(parts_of, dim, parts)
    return out
