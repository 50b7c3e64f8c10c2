"""Mixture-of-Experts with expert parallelism over the ``ep`` mesh axis
(port of ``paddle_tpu/distributed/moe.py``; reference: Paddle's
``incubate/distributed/models/moe/moe_layer.py`` MoELayer, its gates and
``distributed/utils.py`` ``global_scatter`` / ``global_gather``).

Capacity-based dense dispatch (GShard): routing makes a fixed-shape
(tokens, experts, capacity) dispatch mask and combine weights, and the
exchange is ONE tiled all-to-all over the ``ep`` group's (ep, nle, C, d)
slots (:func:`..collective.all_to_all_autograd`, differentiable: its
backward is the reverse exchange).  Where no ``ep`` group resolves every
expert is local and nothing is exchanged.  The dispatch and combine
products and the experts' matmuls are ``torch.einsum`` /
``torch.matmul``, as the JAX package computes them in XLA.

Hybrid composition: :func:`moe_apply` is the functional ep x dp block
(expert bank sliced over ``ep``, tokens over ``dp``: each rank routes its
own tokens with its own capacity).  It runs as the ``block_fn`` of
:func:`.pipeline.spmd_pipeline_1f1b_hetero` on a pp x ep mesh: the ep
ranks of one stage follow one schedule, so their all-to-alls, forward
and backward, stay in lockstep.  The gradients then follow the JAX
recipe: each rank's are full-scale, so replicated leaves take the mean
over ``ep``, and the expert bank, which sums the ep identical token
copies through the all-to-all's backward, is divided by ``ep``.

``random_routing`` draws its noise from an explicit ``torch.Generator``
(the ``key`` argument), never compared with JAX's ``PRNGKey`` draws.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as TF

from ..nn import functional as F
from ..nn.functional.activation import _softplus0
from ..nn.layer.common import Linear
from . import collective as _coll
from . import mesh as _mesh

EP_AXIS = "ep"

__all__ = ["top1_routing", "top2_routing", "moe_dispatch", "moe_combine",
           "moe_apply", "NaiveGate", "SwitchGate", "GShardGate", "MoELayer",
           "ExpertFFN", "global_scatter", "global_gather"]


def _one_hot(idx, n):
    return TF.one_hot(idx.long(), n).to(torch.float32)


def _slots(onehot, pos, keep, capacity):
    """(T, E, C) f32: token t in slot ``pos[t]`` of its expert where kept."""
    pos_clip = pos.clamp(0, capacity - 1).long()
    cap_oh = _one_hot(pos_clip, capacity)
    return onehot[:, :, None] * cap_oh[:, None, :] * keep[:, None, None]


def top1_routing(logits, capacity, num_experts, key=None,
                 random_routing=False):
    """Switch-style top-1 routing with capacity limiting.

    Returns (dispatch_mask (T, E, C) bool, combine_weights (T, E, C) f32,
    aux_loss scalar).  ``key``: the ``torch.Generator`` of
    ``random_routing``'s noise (1% of the tokens go to a random
    expert)."""
    probs = torch.softmax(logits.float(), dim=-1)            # (T, E)
    expert_idx = probs.argmax(-1)                            # (T,)
    if random_routing and key is not None:
        noise = torch.rand(expert_idx.shape, generator=key,
                           device=key.device).to(expert_idx.device)
        rand_idx = torch.randint(0, num_experts, expert_idx.shape,
                                 generator=key, device=key.device
                                 ).to(expert_idx.device)
        expert_idx = torch.where(noise < 0.01, rand_idx, expert_idx)
    gate = probs.gather(-1, expert_idx[:, None])[:, 0]
    onehot = _one_hot(expert_idx, num_experts)
    # the position of each token in its expert's queue
    pos_in_expert = (torch.cumsum(onehot, 0) * onehot).sum(-1) - 1.0
    keep = (pos_in_expert < capacity).to(torch.float32)
    gate = gate * keep
    # the load-balancing loss (GShard eq. 4 / the switch loss)
    aux = (onehot.mean(0) * probs.mean(0)).sum() * num_experts
    dispatch = _slots(onehot, pos_in_expert, keep, capacity)
    combine = dispatch * gate[:, None, None]
    return dispatch.bool(), combine, aux


def top2_routing(logits, capacity, num_experts):
    """GShard top-2 routing: the second choice queues behind every token's
    first choice; the two gates renormalized over what was kept."""
    probs = torch.softmax(logits.float(), dim=-1)
    top1 = probs.argmax(-1)
    top2 = (probs * (1.0 - _one_hot(top1, num_experts))).argmax(-1)
    masks, gates = [], []
    occupancy = torch.zeros((1, num_experts), dtype=torch.float32,
                            device=probs.device)
    for idx in (top1, top2):
        onehot = _one_hot(idx, num_experts)
        pos_in = ((torch.cumsum(onehot, 0) - onehot + occupancy)
                  * onehot).sum(-1)
        keep = (pos_in < capacity).to(torch.float32)
        gates.append(probs.gather(-1, idx[:, None])[:, 0] * keep)
        masks.append(_slots(onehot, pos_in, keep, capacity))
        occupancy = occupancy + onehot.sum(0, keepdim=True)
    g1, g2 = gates
    denom = torch.clamp_min(g1 + g2, 1e-9)
    combine = (masks[0] * (g1 / denom)[:, None, None]
               + masks[1] * (g2 / denom)[:, None, None])
    dispatch = (masks[0] + masks[1]) > 0
    aux = (_one_hot(top1, num_experts).mean(0) * probs.mean(0)).sum() \
        * num_experts
    return dispatch, combine, aux


def _route(logits, capacity, num_experts, top_k):
    if top_k == 1:
        return top1_routing(logits, capacity, num_experts)
    return top2_routing(logits, capacity, num_experts)


def _ep_group(axis, num_experts, nle):
    """The ``ep`` group the slots are exchanged over, or None (all experts
    local); its size must be ``num_experts / nle``."""
    g = _coll.bound_group(axis)
    ep = num_experts // nle
    if g is not None and g.nranks != ep:
        raise ValueError("moe: %d experts of %d local a rank need an ep "
                         "group of %d ranks, the %r group has %d"
                         % (num_experts, nle, ep, g.axis, g.nranks))
    return g


def moe_dispatch(tok, logits, *, top_k, capacity, num_experts, nle, axis):
    """Token -> expert-slot dispatch.  Returns (expert_in (nle, slots, d),
    aux).  Over an ``ep`` group, ONE tiled all-to-all exchanges the
    (ep, nle, C, d) slots, so each rank holds every source rank's slots
    for ITS local experts (slots = ep * C)."""
    dispatch, _, aux = _route(logits, capacity, num_experts, top_k)
    expert_in = torch.einsum("tec,td->ecd", dispatch.to(tok.dtype), tok)
    g = _ep_group(axis, num_experts, nle)
    ep = num_experts // nle
    if g is not None:
        expert_in = expert_in.reshape(ep, nle, capacity, -1)
        expert_in = _coll.all_to_all_autograd(expert_in, g)
        expert_in = expert_in.transpose(0, 1)           # (nle, ep, C, d)
    return expert_in.reshape(nle, ep * capacity, -1), aux


def moe_combine(eo, logits, *, top_k, capacity, num_experts, nle, axis,
                dtype=None):
    """Expert outputs (nle, slots, d) -> tokens (T, d): the inverse
    all-to-all, then the weighted combine."""
    _, combine, _ = _route(logits, capacity, num_experts, top_k)
    g = _ep_group(axis, num_experts, nle)
    if g is not None:
        ep = num_experts // nle
        eo = eo.reshape(nle, ep, capacity, -1).transpose(0, 1)
        eo = _coll.all_to_all_autograd(eo.contiguous(), g)
    eo = eo.reshape(num_experts, capacity, -1)
    return torch.einsum("tec,ecd->td", combine.to(eo.dtype), eo)


def _capacity(top_k, capacity_factor, tokens, num_experts):
    return max(int(math.ceil(top_k * capacity_factor * tokens
                             / num_experts)), 4)


def _standardize(t, eps=1e-5):
    mean = t.mean(-1, keepdim=True)
    var = torch.square(t).mean(-1, keepdim=True) - torch.square(mean)
    return (t - mean) * torch.rsqrt(var + eps)


#: ``jax.nn``'s shape-keeping activations by name, with their defaults,
#: as ``moe_apply`` takes them (``getattr(jax.nn, act)`` in the JAX
#: package), through the port's ``nn.functional`` where it has the same
#: function: ``gelu`` is the tanh form there, ``softplus`` log(1 + e^x)
_ACTS = {
    "celu": F.celu, "elu": F.elu,
    "gelu": lambda t: F.gelu(t, approximate=True),
    "hard_sigmoid": F.hardsigmoid, "hard_silu": F.hardswish,
    "hard_swish": F.hardswish,
    "hard_tanh": F.hardtanh, "identity": lambda t: t,
    "leaky_relu": F.leaky_relu, "log_sigmoid": F.log_sigmoid,
    "log_softmax": F.log_softmax, "mish": F.mish, "relu": F.relu,
    "relu6": F.relu6,
    "selu": F.selu,
    "sigmoid": F.sigmoid, "silu": F.silu, "soft_sign": F.softsign,
    "softmax": F.softmax, "softplus": _softplus0,
    "sparse_plus": lambda t: torch.where(
        t <= -1.0, torch.zeros_like(t),
        torch.where(t >= 1.0, t, torch.square(t + 1.0) / 4.0)),
    "sparse_sigmoid": lambda t: 0.5 * torch.clamp(t + 1.0, 0.0, 2.0),
    "squareplus": lambda t: (t + torch.sqrt(torch.square(t) + 4.0)) / 2.0,
    "standardize": _standardize, "swish": F.silu, "tanh": F.tanh}


def moe_apply(params, x, *, top_k=1, capacity_factor=2.0, axis=EP_AXIS,
              num_experts=None, act="gelu"):
    """The functional MoE block (ep x dp; reference moe_layer.py:226 under
    the fleet hybrid topology).

    params, this rank's slices:
        gate: (d, E)          replicated
        w1:   (nle, d, h)     the rank's nle experts of the (E, d, h) bank
        b1:   (nle, h)
        w2:   (nle, h, d)
        b2:   (nle, d)
    x: (b_local, s, d), this data-parallel rank's tokens (each rank routes
    its own with its own capacity, ``max(ceil(top_k * cf * T / E), 4)``).
    ``act`` names a ``jax.nn`` activation (``gelu`` is its tanh form).
    Returns (out (b_local, s, d), aux_loss)."""
    b, s, d = x.shape
    tok = x.reshape(b * s, d)
    logits = tok @ params["gate"]
    nle = params["w1"].shape[0]
    if num_experts is None:
        g = _coll.bound_group(axis)
        num_experts = nle * (g.nranks if g is not None else 1)
    capacity = _capacity(top_k, capacity_factor, b * s, num_experts)
    kw = dict(top_k=top_k, capacity=capacity, num_experts=num_experts,
              nle=nle, axis=axis)
    expert_in, aux = moe_dispatch(tok, logits, **kw)
    h = torch.einsum("ncd,ndh->nch", expert_in, params["w1"]) \
        + params["b1"][:, None, :]
    if act not in _ACTS:
        raise ValueError("moe_apply: act=%r is none of jax.nn's "
                         "shape-keeping activations %s"
                         % (act, sorted(_ACTS)))
    h = _ACTS[act](h)
    eo = torch.einsum("nch,nhd->ncd", h, params["w2"]) \
        + params["b2"][:, None, :]
    out = moe_combine(eo, logits, **kw)
    return out.reshape(b, s, d), aux


class NaiveGate(torch.nn.Module):
    def __init__(self, d_model, num_experts, topk=2):
        super().__init__()
        self.gate = Linear(d_model, num_experts, bias_attr=False)
        self.topk = topk
        self.num_experts = num_experts

    def forward(self, x):
        return self.gate(x)


class SwitchGate(NaiveGate):
    def __init__(self, d_model, num_experts):
        super().__init__(d_model, num_experts, topk=1)


class GShardGate(NaiveGate):
    def __init__(self, d_model, num_experts):
        super().__init__(d_model, num_experts, topk=2)


class MoELayer(torch.nn.Module):
    """reference parity: moe_layer.py:226.

    ``experts``: this rank's local experts (modules such as
    :class:`ExpertFFN`).  ``num_experts`` is their count times the size of
    the ``ep`` axis of the global mesh (``group``'s axis when given); over
    an ``ep`` group the all-to-all exchanges expert slots between the
    ranks, without one every expert is local.  ``aux_loss`` holds the last
    forward's load-balancing loss times ``aux_loss_weight``."""

    def __init__(self, d_model, experts, gate="gshard", top_k=2,
                 capacity_factor=1.25, group=None, recompute_interval=0,
                 aux_loss_weight=0.01):
        super().__init__()
        self.d_model = d_model
        self.experts = (experts if isinstance(experts, torch.nn.ModuleList)
                        else torch.nn.ModuleList(list(experts)))
        self.num_local_experts = len(self.experts)
        self.axis = getattr(group, "axis", EP_AXIS)
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.aux_loss_weight = aux_loss_weight
        self.aux_loss = None
        ep = max(_mesh.axis_size(self.axis), 1)
        self.num_experts = self.num_local_experts * ep
        if isinstance(gate, str):
            cls = {"naive": NaiveGate, "switch": SwitchGate,
                   "gshard": GShardGate}[gate]
            self.gate = cls(d_model, self.num_experts)
        else:
            self.gate = gate

    def forward(self, x):
        """x: (batch, seq, d_model) -> the same shape."""
        b, s, d = x.shape
        tokens = x.reshape(b * s, d)
        logits = self.gate(tokens)                    # (T, E)
        kw = dict(top_k=self.top_k,
                  capacity=_capacity(self.top_k, self.capacity_factor,
                                     b * s, self.num_experts),
                  num_experts=self.num_experts,
                  nle=self.num_local_experts, axis=self.axis)
        expert_in, aux = moe_dispatch(tokens, logits, **kw)
        self.aux_loss = aux * self.aux_loss_weight
        expert_out = torch.stack([expert(expert_in[i]) for i, expert
                                  in enumerate(self.experts)], 0)
        return moe_combine(expert_out, logits, **kw).reshape(b, s, d)


class ExpertFFN(torch.nn.Module):
    """The standard expert: d_model -> hidden -> d_model."""

    def __init__(self, d_model, d_hidden, activation="gelu"):
        super().__init__()
        self.fc1 = Linear(d_model, d_hidden)
        self.fc2 = Linear(d_hidden, d_model)
        self.act = activation

    def forward(self, x):
        return self.fc2(getattr(F, self.act)(self.fc1(x)))


def global_scatter(x, local_count=None, global_count=None, group=None):
    """API parity (reference distributed/utils.py:57): the dense dispatch
    is folded into :class:`MoELayer`; here a tiled all-to-all of dim 0
    over the ``ep`` group (``group``'s axis), the identity without one.
    The counts are accepted and unused: the slots are fixed-shape."""
    g = _coll.bound_group(EP_AXIS if group is None else group)
    return x if g is None else _coll.all_to_all_autograd(x, g)


def global_gather(x, local_count=None, global_count=None, group=None):
    """The inverse of :func:`global_scatter`: the same exchange."""
    return global_scatter(x, local_count, global_count, group)


def build_moe_pp_parity_demo(seed=33, E=2, d=8, h=16, n_stages=2, bps=1,
                             m=4, mb=4, s=4):
    """The tiny MoE-under-pp parity fixture of the JAX package (the same
    ``np.random.RandomState(seed)`` draws, as f32 CPU tensors).

    Returns (params, x, labels, embed_fn, block_fn, head_loss_fn, dims)
    with dims = (n_stages, bps, m); ``params["blocks"]`` leaves are
    (n_stages, bps, ...), the experts' dim E after them.  block_fn routes
    through :func:`moe_apply` over the ``ep`` axis."""
    rng = np.random.RandomState(seed)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))
    params = {
        "embed": {"we": t(rng.randn(d, d) * 0.3)},
        "blocks": {
            "gate": t(rng.randn(n_stages, bps, d, E) * 0.5),
            "w1": t(rng.randn(n_stages, bps, E, d, h) * 0.2),
            "b1": t(np.zeros((n_stages, bps, E, h))),
            "w2": t(rng.randn(n_stages, bps, E, h, d) * 0.2),
            "b2": t(np.zeros((n_stages, bps, E, d))),
        },
        "head": {"wh": t(rng.randn(d, d) * 0.3)},
    }
    x = t(rng.randn(m, mb, s, d))
    labels = t(rng.randn(m, mb, s, d))

    def embed_fn(ep_, xb):
        return xb @ ep_["we"]

    def block_fn(bp, hb):
        moe_p = {k: bp[k] for k in ("gate", "w1", "b1", "w2", "b2")}
        out, _aux = moe_apply(moe_p, hb, top_k=1, capacity_factor=2.0,
                              axis=EP_AXIS)
        return hb + out

    def head_loss_fn(hp, ep_, hb, lbl):
        return torch.mean((hb @ hp["wh"] - lbl) ** 2)

    return params, x, labels, embed_fn, block_fn, head_loss_fn, \
        (n_stages, bps, m)


def moe_pp_sequential_loss(params, x, labels, embed_fn, block_fn,
                           head_loss_fn, dims, dp_axis="dp"):
    """The non-pipelined reference of the parity fixture: the
    microbatch-mean loss of the sequential model, averaged over the data
    axis where it has a group.  The average's backward is the identity,
    as the JAX reference's ``pmean`` is under ``check_vma=False``: each
    rank's gradients stay full-scale."""
    n_stages, bps, m = dims
    total = 0.0
    for i in range(m):
        hb = embed_fn(params["embed"], x[i])
        for st in range(n_stages):
            for bi in range(bps):
                bp = {k: v[st, bi] for k, v in params["blocks"].items()}
                hb = block_fn(bp, hb)
        total = total + head_loss_fn(params["head"], params["embed"], hb,
                                     labels[i])
    loss = total / m
    g = _coll.bound_group(dp_axis)
    if g is None:
        return loss
    mean = loss.detach().clone()
    _coll.all_reduce(mean, op=_coll.ReduceOp.AVG, group=g)
    return loss + (mean - loss.detach())
