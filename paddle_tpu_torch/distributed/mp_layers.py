"""Tensor (model) parallel layers (port of
``paddle_tpu/distributed/mp_layers.py``; reference:
fleet/meta_parallel/parallel_layers/mp_layers.py).

The JAX layers hold full-shape parameters with Megatron ``pspec``
annotations and let GSPMD insert the collectives.  The port's layers are
built with the same full shapes and annotations;
:func:`~.parallel_base.parallelize` then keeps each rank's shard and
gives every module the ``mp`` group (``_mp_group``), and the forward
runs the collectives Megatron writes by hand, as autograd functions:

* :func:`copy_to_mp` — identity forward, all-reduce backward (the input
  of a column-parallel matmul: each rank's dx is a partial sum);
* :func:`reduce_from_mp` — all-reduce forward, identity backward (the
  output of a row-parallel matmul);
* :func:`gather_from_mp` / :func:`scatter_to_mp` — the last dimension
  all-gathered or cut to the rank's piece, and the reverse backward.

Without an ``mp`` group (``_mp_group`` None) every layer is its dense
self.  With the ``mp_overlap`` switch on, the column layer (without
``gather_output``) and the row layer run its islands instead, as in the
JAX package.  ``shard_heads`` and ``with_sharding_constraint`` are layout notes
for GSPMD: eager PyTorch has nothing to constrain, and they return their
input.
"""
from __future__ import annotations

import contextlib
import zlib

import torch
from torch import nn

from ..nn import initializer as I
from . import collective as _coll
from .mesh import PartitionSpec

MP_AXIS = "mp"

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "ParallelCrossEntropy",
           "TensorParallel", "RNGStatesTracker", "get_rng_state_tracker",
           "shard_heads", "with_sharding_constraint", "copy_to_mp",
           "reduce_from_mp", "gather_from_mp", "scatter_to_mp",
           "vocab_parallel_embedding", "vocab_parallel_cross_entropy",
           "mark_vocab_parallel", "vocab_parallel_group"]


class _CopyToMP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return _coll.all_reduce(dy.contiguous().clone(),
                                group=ctx.group), None


class _ReduceFromMP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _coll.all_reduce(x.contiguous().clone(), group=group)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


def _gather_last(x, group):
    parts = _coll.all_gather([], x.contiguous(), group=group)
    return torch.cat(parts, dim=-1)


def _piece_last(x, group):
    n = x.shape[-1] // group.nranks
    return x[..., group.rank * n:(group.rank + 1) * n].contiguous()


class _GatherFromMP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_last(x, group)

    @staticmethod
    def backward(ctx, dy):
        return _piece_last(dy, ctx.group), None


class _ScatterToMP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _piece_last(x, group)

    @staticmethod
    def backward(ctx, dy):
        return _gather_last(dy, ctx.group), None


def copy_to_mp(x, group):
    return x if group is None else _CopyToMP.apply(x, group)


def reduce_from_mp(x, group):
    return x if group is None else _ReduceFromMP.apply(x, group)


def gather_from_mp(x, group):
    return x if group is None else _GatherFromMP.apply(x, group)


def scatter_to_mp(x, group):
    return x if group is None else _ScatterToMP.apply(x, group)


def _group_of(module):
    return getattr(module, "_mp_group", None)


def vocab_parallel_embedding(ids, weight, group):
    """Lookup in a vocab-sharded table: ids outside this rank's rows give
    zeros, and the all-reduce over ``group`` sums the one rank that holds
    each row.  Ids past the table clamp to its last row, as the dense
    ``Embedding`` does."""
    v_local = int(weight.shape[0])
    v = v_local * group.nranks
    ids = ids.clamp(0, v - 1)
    start = group.rank * v_local
    local = ids - start
    outside = (local < 0) | (local >= v_local)
    out = torch.nn.functional.embedding(local.clamp(0, v_local - 1), weight)
    out = torch.where(outside[..., None], torch.zeros((), dtype=out.dtype,
                                                      device=out.device),
                      out)
    return reduce_from_mp(out, group)


def mark_vocab_parallel(logits, group):
    """Tag ``logits`` as the rank's vocab shard over ``group``: the loss
    functionals then take the vocab-parallel softmax-CE."""
    if group is not None:
        logits._vocab_parallel = group
    return logits


def vocab_parallel_group(logits):
    return getattr(logits, "_vocab_parallel", None)


def vocab_parallel_cross_entropy(logits, label, group, ignore_index=-100):
    """Per-row softmax-CE over vocab-sharded logits, in f32, 0 where the
    label is ``ignore_index``.  Three all-reduces over ``group`` — the row
    max (MAX), the sum of exponentials and the target logit (SUM) — and
    never the (N, V) logits themselves; the max is a constant to
    autograd, as in the dense route."""
    v_local = int(logits.shape[-1])
    start = group.rank * v_local
    m = logits.detach().amax(dim=-1).float()
    _coll.all_reduce(m, op=_coll.ReduceOp.MAX, group=group)
    sumexp = torch.exp(logits.float() - m.unsqueeze(-1)).sum(dim=-1)
    lse = m + torch.log(reduce_from_mp(sumexp, group))
    local = label.long() - start
    mine = (local >= 0) & (local < v_local)
    t = torch.gather(logits, -1, local.clamp(0, v_local - 1).unsqueeze(-1))
    t = torch.where(mine, t.squeeze(-1).float(),
                    torch.zeros((), dtype=torch.float32,
                                device=logits.device))
    nll = lse - reduce_from_mp(t, group)
    return torch.where(label != ignore_index, nll, torch.zeros_like(nll))


class ColumnParallelLinear(nn.Module):
    """y = x @ W[:, shard] (+ b[shard]); ``gather_output`` all-gathers
    the shards.  reference parity: mp_layers.py:97."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.gather_output = gather_output
        self.axis = getattr(mp_group, "axis", MP_AXIS)
        self.weight = nn.Parameter(I.XavierNormal()((in_features,
                                                     out_features)))
        self.weight.pspec = PartitionSpec(None, self.axis)
        self.weight.is_distributed = True
        if has_bias:
            self.bias = nn.Parameter(torch.zeros(out_features))
            self.bias.pspec = PartitionSpec(self.axis)
            self.bias.is_distributed = True
        else:
            self.bias = None

    def forward(self, x):
        from . import mp_overlap as _mpo
        g = _group_of(self)
        if g is not None and not self.gather_output and _mpo.col_viable(
                self.in_features, self.out_features, group=g):
            # overlapped: the same local forward, dx's all-reduce as the
            # permute ring in the backward
            return _mpo.column_parallel_matmul(x, self.weight, self.bias,
                                               group=g)
        y = copy_to_mp(x, g) @ self.weight
        if self.bias is not None:
            y = y + self.bias
        return gather_from_mp(y, g) if self.gather_output else y


class RowParallelLinear(nn.Module):
    """y = sum over shards of x[shard] @ W[shard, :], then + b: the
    all-reduce in the forward.  ``input_is_parallel=False`` cuts a full
    input to the rank's piece first.  reference parity: mp_layers.py:170."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.input_is_parallel = input_is_parallel
        self.axis = getattr(mp_group, "axis", MP_AXIS)
        self.weight = nn.Parameter(I.XavierNormal()((in_features,
                                                     out_features)))
        self.weight.pspec = PartitionSpec(self.axis, None)
        self.weight.is_distributed = True
        self.bias = (nn.Parameter(torch.zeros(out_features)) if has_bias
                     else None)

    def forward(self, x):
        from . import mp_overlap as _mpo
        g = _group_of(self)
        if g is None:
            y = x @ self.weight
        else:
            if not self.input_is_parallel:
                x = scatter_to_mp(x, g)
            if _mpo.row_viable(self.in_features, group=g):
                # overlapped: the all-reduce as the reduce-scatter /
                # all-gather permute ring, a shard-local backward
                return _mpo.row_parallel_matmul(x, self.weight, self.bias,
                                                 group=g)
            y = reduce_from_mp(x @ self.weight, g)
        return y if self.bias is None else y + self.bias


class VocabParallelEmbedding(nn.Module):
    """Embedding table sharded on the vocab dim.  reference parity:
    mp_layers.py:30 (kernel c_embedding_op.cu)."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.axis = getattr(mp_group, "axis", MP_AXIS)
        self.weight = nn.Parameter(I.XavierNormal()((num_embeddings,
                                                     embedding_dim)))
        self.weight.pspec = PartitionSpec(self.axis, None)
        self.weight.is_distributed = True

    def forward(self, x):
        g = _group_of(self)
        if g is None:
            return torch.nn.functional.embedding(
                x.clamp(0, self.num_embeddings - 1), self.weight)
        return vocab_parallel_embedding(x, self.weight, g)


class ParallelCrossEntropy(nn.Module):
    """Softmax-CE over vocab-sharded logits without gathering them
    (reference: mp_layers.py:249); per row, with a trailing dim of 1 as
    the JAX layer returns it.  Dense logits without an ``mp`` group."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.axis = getattr(mp_group, "axis", MP_AXIS)
        self.ignore_index = ignore_index

    def forward(self, input, label):
        if label.dim() == input.dim():
            label = label.squeeze(-1)
        g = _group_of(self) or vocab_parallel_group(input)
        if g is None:
            from ..nn.functional.loss import softmax_with_cross_entropy_raw
            nll = softmax_with_cross_entropy_raw(
                input, label, ignore_index=self.ignore_index)
        else:
            nll = vocab_parallel_cross_entropy(input, label, g,
                                               self.ignore_index)
        return nll.unsqueeze(-1)


def with_sharding_constraint(t, spec):
    """A GSPMD layout note: the identity in eager PyTorch."""
    return t


def shard_heads(t):
    """The JAX package pins (batch, seq, heads, head_dim) activations
    head-sharded for GSPMD; a rank of the port already holds its own
    heads (the dealt q/k/v columns), so this is the identity."""
    return t


class TensorParallel(nn.Module):
    """Model wrapper for mp mode (fleet_base.py:932 dispatch target):
    applies each parameter's pspec over the global mesh."""

    def __init__(self, layers, hcg=None, strategy=None):
        super().__init__()
        from .parallel_base import parallelize
        self._layers = layers
        parallelize(layers)

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)


class RNGStatesTracker:
    """Named random streams for dropout under tensor parallelism
    (reference: parallel_layers/random.py:32).  A stream is a saved
    state of PyTorch's default generators (the CPU one and, where a card
    is initialized, the current card's), seeded by the seed and the
    name's CRC-32 (a hash that every rank computes alike);
    :meth:`rng_state` swaps it in for a block and saves where it got
    to."""

    def __init__(self):
        self.states = {}
        self.seed = 0

    @staticmethod
    def _snapshot():
        cuda = (torch.cuda.get_rng_state()
                if torch.cuda.is_available() and torch.cuda.is_initialized()
                else None)
        return torch.get_rng_state(), cuda

    @staticmethod
    def _restore(state):
        cpu, cuda = state
        torch.set_rng_state(cpu)
        if cuda is not None:
            torch.cuda.set_rng_state(cuda)

    def add(self, name, seed):
        saved = self._snapshot()
        torch.manual_seed((int(seed) + zlib.crc32(name.encode()))
                          & 0x7FFFFFFF)
        self.states[name] = self._snapshot()
        self._restore(saved)

    def rng_state(self, name="model_parallel_rng"):
        @contextlib.contextmanager
        def ctx():
            if name not in self.states:
                self.add(name, self.seed)
            saved = self._snapshot()
            self._restore(self.states[name])
            try:
                yield
            finally:
                self.states[name] = self._snapshot()
                self._restore(saved)

        return ctx()


_rng_tracker = RNGStatesTracker()


def get_rng_state_tracker():
    return _rng_tracker
