"""Framework-level save / load (port of ``paddle_tpu/framework/__init__.py``:
``save``, ``load``, ``save_to_memory``; reference:
python/paddle/framework/io.py).

A file is the JAX package's: a pickle of the object with every tensor
replaced by a ``_TensorPayload`` holding ``array`` (numpy), ``is_parameter``,
``name`` and ``stop_gradient``.  A dtype numpy lacks (bfloat16) is stored
as its bits, with the torch dtype's name in ``torch_dtype``.  :func:`load`
reads the JAX package's files too, without importing it: its unpickler
maps ``paddle_tpu.framework._TensorPayload`` to this module's class, and
an ``ml_dtypes`` bfloat16 array (kind ``V``) to a torch bfloat16 tensor
by its bits.  Tensors load on the CPU; a payload marked as a parameter
comes back as a ``torch.nn.Parameter`` (``requires_grad`` unless
``stop_gradient``); ``name`` stays in the file (a torch tensor's
``name`` is read-only).
"""
from __future__ import annotations

import io as _io
import os
import pickle

import numpy as np
import torch

__all__ = ["save", "load", "save_to_memory"]

#: torch dtypes numpy lacks, stored as their bits
_BITS = {torch.bfloat16: np.uint16}


class _TensorPayload:
    """Pickle-stable tensor container (arrays as numpy + dtype tag)."""

    def __init__(self, t: torch.Tensor):
        self.is_parameter = isinstance(t, torch.nn.Parameter)
        self.name = getattr(t, "name", None)
        self.stop_gradient = not t.requires_grad
        t = t.detach().cpu()
        if t.dtype in _BITS:
            self.torch_dtype = str(t.dtype).replace("torch.", "")
            self.array = t.view(torch.int16).numpy().view(
                _BITS[t.dtype]).copy()
        else:
            self.array = t.numpy().copy()


def _pack(obj):
    if isinstance(obj, torch.Tensor):
        return _TensorPayload(obj)
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = type(obj)
        return t(_pack(v) for v in obj)
    return obj


def _tensor_of(payload) -> torch.Tensor:
    arr = payload.array
    dtype = getattr(payload, "torch_dtype", None)
    if dtype is None and arr.dtype.kind == "V" and arr.dtype.itemsize == 2 \
            and "bfloat16" in str(arr.dtype):
        dtype = "bfloat16"      # an ml_dtypes array of the JAX package
    if dtype is not None:
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(getattr(torch, dtype))
    return torch.from_numpy(np.array(arr, copy=True))


def _unpack(obj):
    if isinstance(obj, _TensorPayload):
        t = _tensor_of(obj)
        if obj.is_parameter:
            t = torch.nn.Parameter(t, requires_grad=not obj.stop_gradient
                                   and t.is_floating_point())
        return t
    if isinstance(obj, dict):
        return {k: _unpack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = type(obj)
        return t(_unpack(v) for v in obj)
    return obj


class _Unpickler(pickle.Unpickler):
    """Reads the JAX package's payload class as this module's."""

    def find_class(self, module, name):
        if module == "paddle_tpu.framework" and name == "_TensorPayload":
            return _TensorPayload
        return super().find_class(module, name)


def save(obj, path, protocol=4, **configs):
    """paddle.save equivalent (reference: python/paddle/framework/io.py:568).

    Accepts nested state_dicts of tensors; path may be a file path or a
    writable file-like object.
    """
    payload = _pack(obj)
    if hasattr(path, "write"):
        pickle.dump(payload, path, protocol=protocol)
        return
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(payload, f, protocol=protocol)


def load(path, **configs):
    """paddle.load equivalent (reference: python/paddle/framework/io.py:784)."""
    if hasattr(path, "read"):
        return _unpack(_Unpickler(path).load())
    with open(path, "rb") as f:
        return _unpack(_Unpickler(f).load())


def save_to_memory(obj):
    buf = _io.BytesIO()
    save(obj, buf)
    buf.seek(0)
    return buf
