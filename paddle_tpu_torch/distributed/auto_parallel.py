"""The auto-parallel Engine (port of
``paddle_tpu/distributed/auto_parallel.py``; reference:
python/paddle/distributed/auto_parallel/engine.py:50 — Engine.prepare:79
/ fit:279 / evaluate / predict — plus interface.py ``shard_op`` and
process_mesh.py ``ProcessMesh``).

The JAX Engine annotates the parameters (``parallelize``), shards the
input batch over the data axis and drives one compiled ``TrainStep``;
GSPMD's propagation stands in for the reference's planner.  The port's
Engine drives the same parts of the port, which run one process a rank:
``parallelize`` slices the parameters over ``mp``, the training loader
yields each rank its rows of every global batch (``shard_dataloader``)
and the ``TrainStep`` takes them as they are (``local_batch=True``) and
averages over ``dp``, so each rank trains on its own rows once.
``evaluate`` and ``predict`` run each rank's rows of a global batch and
all-gather the outputs over ``dp``: the loss, the metrics and the
predictions are those of the global batch, the same on every rank, as
the JAX Engine's global arrays are.  Every rank calls every method.

``shard_op`` has no sharding constraint to apply in eager PyTorch, where
every rank holds global values: it checks each spec against the mesh (a
known axis, a dimension the axes divide) and returns what the function
returns, values and autograd unchanged — as ``with_sharding_constraint``
changes no values.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device
from . import collective as _coll
from . import mesh as _mesh
from .mesh import PartitionSpec
from .parallel_base import local_rows, parallelize, shard_dataloader

__all__ = ["Engine", "ProcessMesh", "shard_op"]


class ProcessMesh:
    """reference: auto_parallel/process_mesh.py:39 — a named mesh of
    ranks, installed as the global mesh.  ``mesh`` (an array of world
    ranks) with ``dim_names`` keeps the user's axis order and rank layout
    verbatim (:func:`.mesh.init_mesh_of_ranks`); ``shape`` with
    ``dim_names`` lays ranks 0..n-1 out row-major in that order."""

    def __init__(self, mesh=None, dim_names=None, shape=None,
                 process_ids=None):
        if mesh is not None and dim_names is not None:
            ranks = np.asarray(mesh)
        elif shape is not None and dim_names is not None:
            ranks = np.arange(int(np.prod(shape))).reshape(tuple(shape))
        else:
            raise ValueError("ProcessMesh needs (mesh|shape) + dim_names")
        if process_ids is not None:
            raise NotImplementedError(
                "ProcessMesh(process_ids=...) is not supported — pass the "
                "ids as the `mesh` array instead")
        self.dim_names = list(dim_names)
        self.shape = [int(d) for d in ranks.shape]
        self._mesh = _mesh.init_mesh_of_ranks(ranks, self.dim_names)

    @property
    def mesh(self):
        return self._mesh

    def __repr__(self):
        return "ProcessMesh(shape=%s, dim_names=%s)" % (self.shape,
                                                         self.dim_names)


def _check_spec(v, spec, mesh):
    """``spec`` (a dimension's axis name, a tuple of names or None, for
    each leading dimension of ``v``) against ``mesh``: ValueError for an
    axis the mesh lacks, a spec longer than ``v``'s rank, or a dimension
    the axes' ranks do not divide."""
    if spec is None or not isinstance(v, (torch.Tensor, np.ndarray)):
        return
    spec = tuple(spec)
    if len(spec) > v.ndim:
        raise ValueError("shard_op: spec %r for a %d-dimensional value"
                         % (spec, v.ndim))
    for d, axis in enumerate(spec):
        if axis is None:
            continue
        names = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
        unknown = [a for a in names if a not in mesh.shape]
        if unknown:
            raise ValueError("shard_op: spec %r names axes %s the mesh %r "
                             "lacks" % (spec, unknown, mesh))
        size = int(np.prod([mesh.shape[a] for a in names]))
        if int(v.shape[d]) % size:
            raise ValueError("shard_op: dimension %d of size %d does not "
                             "divide over %s (%d ranks)"
                             % (d, int(v.shape[d]), names, size))


def shard_op(op_fn, process_mesh=None, in_shard_specs=None,
             out_shard_specs=None):
    """reference: auto_parallel/interface.py ``shard_op`` — ``op_fn`` with
    its inputs and outputs checked against their specs (the module
    docstring)."""
    mesh = process_mesh.mesh if isinstance(process_mesh, ProcessMesh) else \
        (process_mesh or _mesh.ensure_mesh())

    def constrained(*args, **kwargs):
        if in_shard_specs is not None:
            for a, s in zip(args, in_shard_specs):
                _check_spec(a, s, mesh)
        out = op_fn(*args, **kwargs)
        if out_shard_specs is not None:
            outs = out if isinstance(out, tuple) else (out,)
            for o, s in zip(outs, out_shard_specs):
                _check_spec(o, s, mesh)
        return out

    return constrained


class Engine:
    """reference: auto_parallel/engine.py:50.

    Usage (mirrors the reference)::

        engine = Engine(model, loss, optimizer, metrics, strategy)
        engine.prepare(mesh_axes={"dp": 4, "mp": 2})   # or a ProcessMesh
        engine.fit(train_dataset, epochs=2, batch_size=64)
        engine.evaluate(val_dataset)
        engine.predict(test_dataset)

    ``prepare``'s other keyword arguments reach the ``TrainStep``
    (``device="cpu"``, ``seed``, ``stack_layers``, ...); the Engine runs
    where the step runs."""

    def __init__(self, model=None, loss=None, optimizer=None, metrics=None,
                 strategy=None):
        self.model = model
        self.loss = loss
        self.optimizer = optimizer
        self.metrics = metrics if isinstance(metrics, (list, tuple)) else \
            ([metrics] if metrics is not None else [])
        self.strategy = strategy
        self._step = None
        self._mesh = None
        self._device = None
        self._history = []

    # -- prepare ------------------------------------------------------------
    def prepare(self, mesh_axes=None, process_mesh=None, num_inputs=1,
                zero_stage=None, dp_axis="dp", mp_axis="mp", **kwargs):
        """Slice the parameters over the mesh and build the step.  Each
        rank of the mesh calls it."""
        if isinstance(process_mesh, ProcessMesh):
            self._mesh = process_mesh.mesh
            _mesh.set_mesh(self._mesh)
        elif mesh_axes:
            self._mesh = _mesh.init_mesh(mesh_axes)
        else:
            self._mesh = _mesh.ensure_mesh()
        self._dp_axis = dp_axis
        self._num_inputs = num_inputs
        self._device = resolve_device(kwargs.get("device"))
        parallelize(self.model, mesh=self._mesh, dp_axis=dp_axis,
                    mp_axis=mp_axis)
        self.model.to(self._device)
        if self.optimizer is not None and self.loss is not None:
            from ..jit import TrainStep
            in_spec = PartitionSpec(dp_axis) \
                if dp_axis in self._mesh.shape else None
            # the loader yields each rank its rows (_to_loader)
            self._step = TrainStep(
                self.model, self._loss_fn, self.optimizer,
                num_inputs=num_inputs, in_shardings=in_spec,
                zero_stage=zero_stage, local_batch=True, **kwargs)
        return self

    def _loss_fn(self, *args):
        if callable(self.loss):
            return self.loss(*args)
        raise ValueError("Engine needs a callable loss")

    def _dp_size(self):
        return self._mesh.shape.get(self._dp_axis, 1) if self._mesh else 1

    # -- training -----------------------------------------------------------
    def fit(self, train_data, epochs=1, batch_size=64, steps_per_epoch=None,
            log_freq=50, verbose=1):
        if self.optimizer is None or self.loss is None:
            raise ValueError(
                "Engine.fit needs both a loss and an optimizer — "
                "Engine(model, loss=..., optimizer=...) (reference: "
                "engine.py Engine.fit mode='train' requirements)")
        if self._step is None:
            self.prepare()
        loader = self._to_loader(train_data, batch_size, shuffle=True)
        if self._dp_size() > 1:
            loader = shard_dataloader(loader, mesh=self._mesh,
                                      axis=self._dp_axis)
        for epoch in range(epochs):
            losses = []
            for i, batch in enumerate(loader):
                if steps_per_epoch is not None and i >= steps_per_epoch:
                    break
                loss = self._step(*self._flatten(batch))
                losses.append(float(loss))
                if verbose and log_freq and i % log_freq == 0:
                    print(f"[AutoParallel Engine] epoch {epoch} step {i} "
                          f"loss {losses[-1]:.5f}")
            self._history.append(
                {"epoch": epoch,
                 "loss": sum(losses) / max(len(losses), 1)})
        # a collective under ZeRO stage 3: the model takes its full
        # parameters, which evaluate and predict then read
        self._step.sync_to_model()
        return self._history

    def _forward_global(self, parts):
        """The model on this rank's rows of the global batch ``parts``'
        inputs, the outputs all-gathered over ``dp``: the global batch's
        outputs (a tuple), the same on every rank."""
        ni = self._num_inputs
        inputs = [self._on_device(p) for p in parts[:ni]]
        dp = self._dp_size()
        if dp > 1:
            inputs = local_rows(inputs, self._dp_axis, self._mesh)
        out = self.model(*inputs)
        outs = out if isinstance(out, tuple) else (out,)
        if dp > 1:
            from .mp_layers import mark_vocab_parallel, vocab_parallel_group
            group = self._mesh.group(self._dp_axis)
            outs = tuple(mark_vocab_parallel(
                _coll.all_gather(o.contiguous(), group=group),
                vocab_parallel_group(o)) for o in outs)
        return outs

    @torch.no_grad()
    def evaluate(self, valid_data, batch_size=64, steps=None, verbose=0):
        loader = self._to_loader(valid_data, batch_size, shuffle=False)
        was_training = getattr(self.model, "training", True)
        self.model.eval()
        for m in self.metrics:
            m.reset()
        total, count = 0.0, 0
        try:
            for i, batch in enumerate(loader):
                if steps is not None and i >= steps:
                    break
                parts = self._flatten(batch)
                labels = [self._on_device(p)
                          for p in parts[self._num_inputs:]]
                outs = self._forward_global(parts)
                loss = self._loss_fn(*outs, *labels)
                total += float(loss)
                count += 1
                for m in self.metrics:
                    m.update(m.compute(*outs, *labels))
        finally:
            if was_training:
                self.model.train()
        result = {"loss": total / max(count, 1)}
        for m in self.metrics:
            result[m.name() if callable(getattr(m, "name", None))
                   else type(m).__name__] = m.accumulate()
        return result

    @torch.no_grad()
    def predict(self, test_data, batch_size=64, steps=None, verbose=0):
        loader = self._to_loader(test_data, batch_size, shuffle=False)
        was_training = getattr(self.model, "training", True)
        self.model.eval()
        outs = []
        try:
            for i, batch in enumerate(loader):
                if steps is not None and i >= steps:
                    break
                got = self._forward_global(self._flatten(batch))
                outs.append(got if len(got) > 1 else got[0])
        finally:
            if was_training:
                self.model.train()
        return outs

    # -- introspection ------------------------------------------------------
    def cost(self, mode="train"):
        """The mesh the step runs over (the reference's planner and cost
        model have no counterpart: the layout is the parameters' specs)."""
        if self._step is None:
            raise RuntimeError("call prepare() first")
        return {"note": "no planner: the step runs the parameters' "
                        "placements over this mesh",
                "mesh": dict(self._mesh.shape)}

    # -- helpers ------------------------------------------------------------
    def _on_device(self, x):
        if isinstance(x, torch.Tensor):
            return x.to(self._device)
        return torch.as_tensor(np.asarray(x), device=self._device)

    def _to_loader(self, data, batch_size, shuffle):
        """``data`` as an iterable of global batches: a DataLoader as it
        is, a Dataset in one of its own (whole batches only), anything
        else as it is."""
        from ..io import DataLoader, Dataset
        if isinstance(data, Dataset) and not isinstance(data, DataLoader):
            return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                              drop_last=True, device=self._device)
        return data

    @staticmethod
    def _flatten(batch):
        if isinstance(batch, (list, tuple)):
            return tuple(batch)
        return (batch,)
