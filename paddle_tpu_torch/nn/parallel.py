"""DataParallel (port of ``paddle_tpu/nn/parallel.py``; reference:
python/paddle/fluid/dygraph/parallel.py:413).

Eager multi-process data parallelism over the ``dp`` group (or the
``group`` given): the parameters and buffers of rank 0 are broadcast
when the model is wrapped, and ``apply_collective_grads`` averages the
gradients over the group between ``backward()`` and the optimizer step.
With no process group both are no-ops.
"""
from __future__ import annotations

import torch
from torch import nn

__all__ = ["DataParallel"]


class DataParallel(nn.Module):
    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        from ..distributed import collective as _coll
        self._layers = layers
        self.find_unused_parameters = find_unused_parameters
        self.group = group
        self._group = _coll._resolve(group)
        self._nprocs = 1 if self._group is None else self._group.nranks
        if self._group is not None:
            self.sync_params_buffers()

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, state_dict, *a, **k):
        return self._layers.load_state_dict(state_dict, *a, **k)

    @torch.no_grad()
    def sync_params_buffers(self):
        """Broadcast group rank 0's parameters and buffers to every rank
        (reference: parallel.py:369)."""
        if self._group is None:
            return
        from ..distributed import collective as _coll
        for t in list(self._layers.parameters()) + list(
                self._layers.buffers()):
            _coll.broadcast(t.data, src=0, group=self._group)

    def scale_loss(self, loss):
        # the gradients are averaged in apply_collective_grads, so the loss
        # is not rescaled (the reference's scale + sum, net)
        return loss

    @torch.no_grad()
    def apply_collective_grads(self):
        """Average every trainable parameter's gradient over the group
        (the EagerReducer's all-reduce, reducer.h:87).

        Keyed by parameter name over the full trainable set, with a
        has-grad flag per rank: a rank that skipped a branch contributes
        zeros, the sum divides by the group's size, and a parameter
        unused on every rank keeps no gradient — as in the JAX package.
        One all-reduce carries the flags, one a flat buffer for each
        gradient dtype."""
        if self._group is None:
            return
        from ..distributed import collective as _coll
        named = [(n, p) for n, p in self._layers.named_parameters()
                 if p.requires_grad]
        if not named:
            return
        dev = named[0][1].device
        flags = torch.tensor([float(p.grad is not None) for _, p in named],
                             dtype=torch.float32, device=dev)
        _coll.all_reduce(flags, group=self._group)
        flags = flags.tolist()
        by_dtype = {}
        for i, (_, p) in enumerate(named):
            dt = p.grad.dtype if p.grad is not None else p.dtype
            by_dtype.setdefault(dt, []).append(i)
        for dt, idx in by_dtype.items():
            flat = torch.cat([
                (named[i][1].grad if named[i][1].grad is not None
                 else torch.zeros_like(named[i][1], dtype=dt)).reshape(-1)
                for i in idx])
            _coll.all_reduce(flat, group=self._group)
            flat.div_(torch.tensor(float(self._nprocs), dtype=dt,
                                   device=flat.device))
            o = 0
            for i in idx:
                p = named[i][1]
                g = flat[o:o + p.numel()].view(p.shape)
                o += p.numel()
                if flags[i] == 0.0:
                    continue        # unused on every rank
                if p.grad is None:
                    p.grad = g.clone()
                else:
                    p.grad.copy_(g)
