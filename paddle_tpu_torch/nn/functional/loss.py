"""Loss functionals (port of ``paddle_tpu/nn/functional/loss.py``):
``cross_entropy``, ``softmax_with_cross_entropy(_raw)`` and ``nll_loss``.

Hard-label cross entropy takes one of three routes, in the JAX order:

* ``FLAGS_use_pallas_ce``: the fused softmax-CE kernels E2 / E3
  (:func:`..kernels.ce_cuda.softmax_ce`);
* ``FLAGS_use_pallas_lse``: the one-pass logsumexp kernel E1
  (:func:`..kernels.ce_cuda.logsumexp`), the label gather plain;
* the default, the JAX package's XLA route in plain PyTorch: f32 softmax
  statistics over the (possibly bf16) logits, ``nll = lse - x[y]`` with
  the row max held out of the gradient.

A kernel route is taken when its flag is on, the logits lie on a card
(the JAX gate's "running on a TPU") and the JAX package's own shape
predicate holds; otherwise the plain route runs.  The JAX gate also asks
for a single device (a Mosaic kernel has no GSPMD partitioning rule):
here, logits that are a rank's vocab shard under an ``mp`` group of more
than one rank (the tensor-parallel GPT's, tagged by
``distributed.mp_layers.mark_vocab_parallel``) take the vocab-parallel
softmax-CE (``mp_layers.vocab_parallel_cross_entropy``) whatever the
flags, never E1-E3.  Every route zeroes the loss where the label is
``ignore_index``.
"""
from __future__ import annotations

import torch

from ...kernels import ce_cuda
from ...observability import costs as _costs
from ...utils.flags import fast_get


def _pallas_ce_gate(flag_name, logits):
    """Eligibility of the kernel routes: flag on, logits on a card.
    Returns (n, v, lead) or None."""
    if not fast_get(flag_name) or not logits.is_cuda:
        return None
    lead = tuple(logits.shape[:-1])
    n = 1
    for dim in lead:
        n *= dim
    return n, logits.shape[-1], lead


def _fused_ce_or_none(logits, lbl, ignore_index):
    """The fused softmax-CE route (``FLAGS_use_pallas_ce``); None takes
    the plain route."""
    gate = _pallas_ce_gate("use_pallas_ce", logits)
    if gate is None:
        return None
    n, v, lead = gate
    if not ce_cuda.supported(n, v):
        return None
    idx = lbl.to(torch.int32).clamp(0, v - 1).reshape(n, 1)
    nll = ce_cuda.softmax_ce(logits.reshape(n, v), idx).reshape(lead)
    return torch.where(lbl != ignore_index, nll, torch.zeros_like(nll))


def _streamed_lse_or_none(logits, axis):
    """The one-pass logsumexp over the class axis
    (``FLAGS_use_pallas_lse``); None takes the plain route (not a card,
    an unsupported shape or dtype, or the class axis is not last)."""
    if axis not in (-1, logits.dim() - 1):
        return None
    if logits.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        return None
    gate = _pallas_ce_gate("use_pallas_lse", logits)
    if gate is None:
        return None
    n, v, lead = gate
    if not ce_cuda.lse_supported(n, v, logits.element_size()):
        return None
    return ce_cuda.logsumexp(logits.reshape(n, v)).reshape(lead)


def _reduce(out, reduction, weight_sum=None):
    if reduction == "mean":
        if weight_sum is not None:
            return out.sum() / torch.clamp(weight_sum, min=1e-12)
        return out.mean()
    if reduction == "sum":
        return out.sum()
    return out


def _hard(label, logits, axis):
    """Hard labels without their class axis."""
    if label.dim() == logits.dim() and label.shape[axis] == 1:
        return label.squeeze(axis)
    return label


def softmax_with_cross_entropy_raw(logits, label, soft_label=False,
                                   ignore_index=-100, axis=-1):
    """Per-row loss: ``-sum(label * log_softmax)`` for soft labels, else
    ``logsumexp(logits) - logits[label]`` (0 where the label is
    ``ignore_index``), in f32."""
    if _costs.counting_active():
        # kernels E1-E3's work, whichever route runs (observability.costs)
        fwd, bwd = _costs.cross_entropy_flops(logits.numel())
        return _costs.counted(
            lambda x, y: _softmax_ce(x, y, soft_label, ignore_index, axis),
            (logits, label), fwd, bwd)
    return _softmax_ce(logits, label, soft_label, ignore_index, axis)


def _softmax_ce(logits, label, soft_label, ignore_index, axis):
    if soft_label:
        logp = torch.log_softmax(logits.float(), dim=axis)
        return -(label * logp).sum(axis)
    lbl = _hard(label, logits, axis)
    if axis in (-1, logits.dim() - 1):
        from ...distributed import mp_layers
        group = mp_layers.vocab_parallel_group(logits)
        if group is not None:
            return mp_layers.vocab_parallel_cross_entropy(
                logits, lbl, group, ignore_index)
        out = _fused_ce_or_none(logits, lbl, ignore_index)
        if out is not None:
            return out
    lse = _streamed_lse_or_none(logits, axis)
    if lse is None:
        # two streaming reductions over the logits; the max is a constant
        # to autograd, as in the JAX package (the lse gradient is the
        # softmax)
        m = logits.detach().amax(dim=axis).float()
        lse = m + torch.log(torch.exp(logits.float() - m.unsqueeze(axis))
                            .sum(dim=axis))
    idx = lbl.long().clamp(0, logits.shape[axis] - 1)
    t = torch.gather(logits, axis, idx.unsqueeze(axis)).float()
    nll = lse - t.squeeze(axis)
    return torch.where(lbl != ignore_index, nll, torch.zeros_like(nll))


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    logits = input
    nclass = logits.shape[axis]
    from ...distributed.mp_layers import vocab_parallel_group
    if vocab_parallel_group(logits) is not None and (
            soft_label or label_smoothing > 0.0 or not use_softmax
            or weight is not None):
        raise NotImplementedError(
            "cross_entropy over vocab-sharded logits takes hard labels "
            "without weights or smoothing")
    if label_smoothing > 0.0:
        if not soft_label:
            lbl = _hard(label, logits, axis)
            classes = torch.arange(nclass, device=lbl.device)
            # all zeros for an out-of-range label, as jax.nn.one_hot
            onehot = (lbl.unsqueeze(-1) == classes).to(logits.dtype)
            label = onehot.movedim(-1, axis)
            soft_label = True
        label = label * (1 - label_smoothing) + label_smoothing / nclass
    if not use_softmax:
        # input is already a probability distribution
        logp = torch.log(torch.clamp(input, min=1e-30))
        if soft_label:
            return _reduce(-(label * logp).sum(axis), reduction)
        lbl = _hard(label, input, axis)
        out = -torch.gather(logp, axis, lbl.long().unsqueeze(axis))
        return _reduce(out.squeeze(axis), reduction)
    out = softmax_with_cross_entropy_raw(logits, label, soft_label,
                                         ignore_index, axis)
    if weight is not None and not soft_label:
        lbl = _hard(label, logits, axis)
        w = weight[lbl.long().clamp(0, nclass - 1)]
        w = torch.where(lbl != ignore_index, w, torch.zeros_like(w))
        return _reduce(out * w, reduction, weight_sum=w.sum())
    if reduction == "mean" and not soft_label:
        lbl = _hard(label, logits, axis)
        valid = (lbl != ignore_index).to(out.dtype)
        return out.sum() / torch.clamp(valid.sum(), min=1.0)
    return _reduce(out, reduction)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, axis=-1,
                               return_softmax=False):
    """The per-row loss of :func:`softmax_with_cross_entropy_raw` with the
    class axis kept (size 1); with ``return_softmax`` also the softmax of
    the logits along ``axis``."""
    loss = softmax_with_cross_entropy_raw(logits, label, soft_label,
                                          ignore_index, axis).unsqueeze(axis)
    if return_softmax:
        return loss, torch.softmax(logits, dim=axis)
    return loss


def nll_loss(input, label, weight=None, ignore_index=-100,
             reduction="mean"):
    """Negative log-likelihood of log-probabilities ``input`` (N, C, ...)
    at class ``label`` (N, ...), 0 where the label is ``ignore_index``
    (labels are clipped into [0, C) for the gather); ``weight`` (C,)
    scales each row by its class's weight."""
    idx = label.long().clamp(0, input.shape[1] - 1)
    nll = -torch.gather(input, 1, idx.unsqueeze(1)).squeeze(1)
    mask = label != ignore_index
    if weight is not None:
        w = weight[idx]
        w = torch.where(mask, w, torch.zeros_like(w))
        nll = nll * w
        if reduction == "mean":
            return nll.sum() / torch.clamp(w.sum(), min=1e-12)
    nll = torch.where(mask, nll, torch.zeros_like(nll))
    if reduction == "mean":
        return nll.sum() / torch.clamp(mask.to(nll.dtype).sum(), min=1.0)
    return _reduce(nll, reduction)
