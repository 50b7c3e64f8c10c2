"""Loss functionals (port of ``paddle_tpu/nn/functional/loss.py``):
``cross_entropy`` and ``softmax_with_cross_entropy_raw``.

The default route is the JAX package's XLA route, in plain PyTorch: f32
softmax statistics over the (possibly bf16) logits, ``nll = lse - x[y]``
with the row max held out of the gradient, zero at ``ignore_index``, and
``mean`` over the valid rows.  The JAX package computes it outside any
Pallas kernel by default.  Its kernel routes, ``FLAGS_use_pallas_ce``
(fused softmax-CE) and ``FLAGS_use_pallas_lse`` (one-pass logsumexp),
take effect only on the accelerator; their kernels are not ported yet,
so with either flag on a card's logits raise ``NotImplementedError``
(ROADMAP.md §B) rather than take the plain route.
"""
from __future__ import annotations

import torch

from ...utils.flags import fast_get

_UNPORTED = {
    "use_pallas_ce": "the fused softmax-CE kernels (ce_pallas.py _fwd_kernel"
                     " / _bwd_kernel)",
    "use_pallas_lse": "the one-pass logsumexp kernel (ce_pallas.py "
                      "_lse_kernel)",
}


def _refuse_unported_routes(logits):
    if not logits.is_cuda:
        return
    for flag, what in _UNPORTED.items():
        if fast_get(flag):
            raise NotImplementedError(
                "FLAGS_%s routes cross entropy through %s, which is not "
                "ported yet (ROADMAP.md §B); turn the flag off" % (flag, what))


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
    if soft_label:
        logp = torch.log_softmax(logits.float(), dim=axis)
        return -(label * logp).sum(axis)
    lbl = _hard(label, logits, axis)
    if axis in (-1, logits.dim() - 1):
        _refuse_unported_routes(logits)
    # two streaming reductions over the logits; the max is a constant to
    # autograd, as in the JAX package (the lse gradient is the softmax)
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
