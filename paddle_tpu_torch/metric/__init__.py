"""Metrics (port of ``paddle_tpu/metric``; reference surface:
python/paddle/metric/metrics.py — Accuracy / Precision / Recall / Auc with
``update`` / ``accumulate`` / ``reset``).

The counting runs on the host in numpy, as in the JAX package: a metric
takes torch tensors (any device and dtype), numpy arrays or lists, and
:meth:`Accuracy.compute` and :func:`accuracy` return CPU tensors."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _np(x):
    """Host numpy of ``x`` (a tensor is detached and, below f32, cast to
    f32 first: numpy has no bfloat16)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.is_floating_point() and x.element_size() < 4:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


class Metric:
    def __init__(self):
        pass

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        return self.__class__.__name__.lower()

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        super().__init__()
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def compute(self, pred, label, *args):
        """A (..., maxk) f32 tensor: 1 where the k-th ranked class is the
        label."""
        pred_np, label_np = _np(pred), _np(label)
        if label_np.ndim == pred_np.ndim and label_np.shape[-1] == 1:
            label_np = label_np[..., 0]
        topk_idx = np.argsort(-pred_np, axis=-1)[..., :self.maxk]
        correct = topk_idx == label_np[..., None]
        return torch.from_numpy(correct.astype(np.float32))

    def update(self, correct, *args):
        c = _np(correct)
        n = c.shape[0] if c.ndim else 1
        accs = []
        for i, k in enumerate(self.topk):
            num = float(c[..., :k].sum())
            self.total[i] += num
            self.count[i] += n
            accs.append(num / max(n, 1))
        return accs[0] if len(accs) == 1 else accs

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        return self._name


def _positives(preds, labels):
    """(predicted positive, label) as flat int64 arrays: a prediction
    above 0.5 is positive."""
    pred_pos = (_np(preds) > 0.5).astype(np.int64).reshape(-1)
    return pred_pos, _np(labels).reshape(-1)


class Precision(Metric):
    def __init__(self, name=None):
        super().__init__()
        self._name = name or "precision"
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        pred_pos, lab = _positives(preds, labels)
        self.tp += int(((pred_pos == 1) & (lab == 1)).sum())
        self.fp += int(((pred_pos == 1) & (lab == 0)).sum())

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name=None):
        super().__init__()
        self._name = name or "recall"
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        pred_pos, lab = _positives(preds, labels)
        self.tp += int(((pred_pos == 1) & (lab == 1)).sum())
        self.fn += int(((pred_pos == 0) & (lab == 1)).sum())

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    """ROC AUC over ``num_thresholds + 1`` buckets of the positive
    class's score (column 1 of a (N, 2) prediction), trapezoidal."""

    def __init__(self, curve="ROC", num_thresholds=4095, name=None):
        super().__init__()
        self.num_thresholds = num_thresholds
        self._name = name or "auc"
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        p = _np(preds)
        lab = _np(labels).reshape(-1)
        if p.ndim == 2 and p.shape[1] == 2:
            p = p[:, 1]
        p = p.reshape(-1)
        idx = np.clip((p * self.num_thresholds).astype(np.int64), 0,
                      self.num_thresholds)
        pos = lab.astype(bool)
        np.add.at(self._stat_pos, idx[pos], 1)
        np.add.at(self._stat_neg, idx[~pos], 1)

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        # trapezoidal over thresholds, descending
        tpr = np.cumsum(self._stat_pos[::-1]) / tot_pos
        fpr = np.cumsum(self._stat_neg[::-1]) / tot_neg
        trapezoid = getattr(np, "trapezoid", None) or np.trapz
        return float(trapezoid(tpr, fpr))

    def name(self):
        return self._name


def accuracy(input, label, k=1):
    """Functional accuracy (reference: paddle.metric.accuracy): the share
    of rows whose label is among the top ``k`` classes, a 0-d f32 CPU
    tensor."""
    pred, lab = _np(input), _np(label)
    if lab.ndim == 2 and lab.shape[1] == 1:
        lab = lab[:, 0]
    topk = np.argsort(-pred, axis=-1)[:, :k]
    correct = (topk == lab[:, None]).any(axis=1)
    return torch.tensor(float(correct.mean()), dtype=torch.float32)
