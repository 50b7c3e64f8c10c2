"""High-level API (port of ``paddle_tpu/hapi/__init__.py``; reference
surface: python/paddle/hapi/model.py — Model.prepare/fit/evaluate/predict
at model.py:907,1486,1557; callbacks).

``fit`` drives the port's :class:`..jit.TrainStep` over the port's
:class:`..io.DataLoader`, batch by batch, with the JAX fit's telemetry:
the ``train.fit_batch`` liveness beacon around each batch (the step and
the loss fetch, a real device sync), ``train.batch_seconds``,
``train.loss``, ``train.samples`` and ``train.tokens``, an HBM-ledger
sample at each batch end (``observability.hbm``), and ``stop_training``
honoured after every batch.  ``prepare(device=...)`` says where the step
and the loaders' batches live (the card unless ``"cpu"``).  :func:`flops`
counts one forward through :mod:`..observability.costs`.
"""
from __future__ import annotations

import os
import time
from typing import List

import numpy as np
import torch

from ..core.device import resolve_device
from ..io import DataLoader, Dataset
from ..jit import TrainStep
from ..observability import hbm as _hbm
from ..observability import liveness as _liveness
from ..observability import registry as _metrics

# liveness beacon over one fit batch (train_batch INCLUDES the loss
# fetch — a real device sync, so a wedged device step stalls here even
# when the launches themselves returned)
_liveness.declare_beacon(
    "train.fit_batch", "one hapi fit batch: compiled step dispatch + "
    "the loss fetch device sync", deadline=600.0)

__all__ = ["Model", "Callback", "ProgBarLogger", "ModelCheckpoint",
           "EarlyStopping", "LRScheduler", "summary", "flops"]


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params or {}

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass


class ProgBarLogger(Callback):
    def __init__(self, log_freq=10, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self._epoch = epoch
        self._t0 = time.time()

    def on_train_batch_end(self, step, logs=None):
        if self.verbose and step % self.log_freq == 0:
            items = ", ".join(f"{k}: {v:.4f}" if isinstance(v, float) else
                              f"{k}: {v}" for k, v in (logs or {}).items())
            print(f"Epoch {self._epoch} step {step}: {items}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.time() - self._t0
            items = ", ".join(f"{k}: {v:.4f}" if isinstance(v, float) else
                              f"{k}: {v}" for k, v in (logs or {}).items())
            print(f"Epoch {epoch} done in {dt:.1f}s: {items}")


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and epoch % self.save_freq == 0:
            self.model.save(f"{self.save_dir}/epoch_{epoch}")


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="min", patience=0, min_delta=0,
                 baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.mode = mode
        self.patience = patience
        self.min_delta = min_delta
        self.best = baseline
        self.wait = 0
        self.stop_training = False

    def on_eval_end(self, logs=None):
        cur = (logs or {}).get(self.monitor)
        if cur is None:
            return
        cur = float(cur[0] if isinstance(cur, (list, tuple)) else cur)
        better = (self.best is None
                  or (self.mode == "min" and cur < self.best - self.min_delta)
                  or (self.mode == "max" and cur > self.best + self.min_delta))
        if better:
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stop_training = True
                self.model.stop_training = True


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


class Model:
    """reference parity: python/paddle/hapi/model.py:907."""

    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self.stop_training = False
        self._optimizer = None
        self._loss = None
        self._metrics: List = []
        self._train_step = None
        self._device = None

    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None, device=None):
        """``device``: where the step runs and batches land (the card
        unless ``"cpu"``)."""
        self._optimizer = optimizer
        self._loss = loss
        if metrics is None:
            self._metrics = []
        else:
            self._metrics = metrics if isinstance(metrics, (list, tuple)) \
                else [metrics]
        self._device = resolve_device(device)
        self.network.to(self._device)

    @property
    def device(self):
        return self._device if self._device is not None \
            else resolve_device(None)

    def _on_device(self, xs):
        return [x.to(self.device) if isinstance(x, torch.Tensor)
                else torch.as_tensor(np.asarray(x), device=self.device)
                for x in xs]

    def train_batch(self, inputs, labels=None, update=True):
        """One step (reference: model.py:1045)."""
        inputs = _as_list(inputs)
        labels = labels if labels is None else _as_list(labels)
        if self._train_step is None:
            self._train_step = TrainStep(self.network, self._loss,
                                         self._optimizer,
                                         num_inputs=len(inputs),
                                         device=self.device)
        loss = self._train_step(*inputs, *(labels or []))
        return [float(loss)], []

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None):
        inputs = self._on_device(_as_list(inputs))
        labels = labels if labels is None else self._on_device(
            _as_list(labels))
        self.network.eval()
        if self._train_step is not None:
            self._train_step.sync_to_model()
        outs = self.network(*inputs)
        outs_t = outs if isinstance(outs, (list, tuple)) else [outs]
        loss = None
        if self._loss is not None and labels:
            loss = self._loss(*(list(outs_t) + list(labels)))
        metric_res = []
        for m in self._metrics:
            c = m.compute(*(list(outs_t) + list(labels or [])))
            metric_res.append(m.update(c))
        self.network.train()
        if loss is not None:
            return [float(loss)], metric_res
        return metric_res

    @torch.no_grad()
    def predict_batch(self, inputs):
        inputs = self._on_device(_as_list(inputs))
        self.network.eval()
        if self._train_step is not None:
            self._train_step.sync_to_model()
        out = self.network(*inputs)
        self.network.train()
        return out

    def _loader(self, data, batch_size, **kw):
        if isinstance(data, Dataset):
            return DataLoader(data, batch_size=batch_size,
                              device=self.device, **kw)
        return data

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None):
        """reference parity: model.py:1557."""
        train_loader = self._loader(train_data, batch_size, shuffle=shuffle,
                                    drop_last=drop_last,
                                    num_workers=num_workers)
        eval_loader = None
        if eval_data is not None:
            eval_loader = self._loader(eval_data, batch_size)
        cbs = list(callbacks or [])
        if verbose:
            cbs.append(ProgBarLogger(log_freq, verbose))
        if save_dir:
            cbs.append(ModelCheckpoint(save_freq, save_dir))
        for cb in cbs:
            cb.set_model(self)
            cb.set_params({"epochs": epochs, "verbose": verbose})
        for cb in cbs:
            cb.on_train_begin()
        # fit-loop telemetry: per-batch wall time here includes the loss
        # fetch in train_batch — a real device sync — so unlike
        # train.step_seconds (dispatch only) this is end-to-end
        m_batch = _metrics.histogram("train.batch_seconds")
        m_loss = _metrics.gauge("train.loss")
        m_samples = _metrics.counter("train.samples")
        m_tokens = _metrics.counter("train.tokens")
        b_batch = _liveness.beacon("train.fit_batch")
        it_count = 0
        for epoch in range(epochs):
            for cb in cbs:
                cb.on_epoch_begin(epoch)
            logs = {}
            for step, batch in enumerate(train_loader):
                ins, lbls = self._split_batch(batch)
                t0 = time.perf_counter()
                with b_batch:
                    losses, _ = self.train_batch(ins, lbls)
                m_batch.observe(time.perf_counter() - t0)
                m_loss.set(losses[0])
                shape = getattr(ins[0], "shape", None)
                if shape:
                    m_samples.inc(int(shape[0]))
                    if len(shape) >= 2:
                        m_tokens.inc(int(shape[0]) * int(shape[1]))
                logs = {"loss": losses[0]}
                # HBM-ledger sample at the batch boundary (the loss fetch
                # above was a real device sync); one global None check
                # while disarmed
                _hbm.maybe_sample("train.batch")
                for cb in cbs:
                    cb.on_train_batch_end(step, logs)
                it_count += 1
                # stop_training is honoured PER BATCH: a callback tripping
                # mid-epoch (DivergenceMonitor with its ring exhausted)
                # must not keep training a contaminated state
                if self.stop_training or (num_iters and
                                          it_count >= num_iters):
                    break
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                eval_logs = self.evaluate(eval_loader, verbose=0)
                logs.update(eval_logs)
                for cb in cbs:
                    cb.on_eval_end(eval_logs)
            for cb in cbs:
                cb.on_epoch_end(epoch, logs)
            if self.stop_training or (num_iters and it_count >= num_iters):
                break
        for cb in cbs:
            cb.on_train_end()
        if self._train_step is not None:
            self._train_step.sync_to_model()

    @staticmethod
    def _split_batch(batch):
        if isinstance(batch, (list, tuple)):
            if len(batch) >= 2:
                return [batch[0]], list(batch[1:])
            return [batch[0]], []
        return [batch], []

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None):
        loader = self._loader(eval_data, batch_size,
                              num_workers=num_workers)
        for m in self._metrics:
            m.reset()
        losses = []
        for batch in loader:
            ins, lbls = self._split_batch(batch)
            res = self.eval_batch(ins, lbls)
            if isinstance(res, tuple) and len(res) == 2 and res[0]:
                losses.append(res[0][0])
        logs = {}
        if losses:
            logs["eval_loss"] = float(np.mean(losses))
        for m in self._metrics:
            logs["eval_" + m.name()] = m.accumulate()
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, callbacks=None, verbose=1):
        loader = self._loader(test_data, batch_size,
                              num_workers=num_workers)
        outs = []
        for batch in loader:
            ins, _ = self._split_batch(batch)
            outs.append(self.predict_batch(ins))
        return outs

    def save(self, path, training=True):
        from .. import framework
        if self._train_step is not None:
            self._train_step.sync_to_model()
        framework.save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            framework.save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        from .. import framework
        sd = framework.load(path + ".pdparams")
        with torch.no_grad():
            own = self.network.state_dict()
            for k, v in sd.items():
                if k in own:
                    own[k].copy_(torch.as_tensor(v).to(own[k].dtype))
                elif not skip_mismatch:
                    raise KeyError("%s: not a parameter or buffer of the "
                                   "network" % k)
        if (not reset_optimizer and self._optimizer is not None
                and os.path.exists(path + ".pdopt")):
            self._optimizer.set_state_dict(framework.load(path + ".pdopt"))
        self._train_step = None

    def parameters(self):
        return self.network.parameters()

    def summary(self, input_size=None, dtype=None):
        return summary(self.network, input_size, dtype)


def summary(net, input_size=None, dtypes=None):
    """Parameter-count summary (reference: hapi/model_summary.py)."""
    total = 0
    trainable = 0
    lines = [f"{'Layer':45s} {'Param #':>12s}"]
    for name, p in net.named_parameters():
        n = int(p.numel())
        total += n
        if p.requires_grad:
            trainable += n
        lines.append(f"{name[:45]:45s} {n:12d}")
    lines.append(f"Total params: {total:,}")
    lines.append(f"Trainable params: {trainable:,}")
    print("\n".join(lines))
    return {"total_params": total, "trainable_params": trainable}


def flops(net, input_size=None, inputs=None, dtypes=None, custom_ops=None,
          print_detail=False):
    """Model FLOPs of one forward (reference: hapi/dynamic_flops.py
    paddle.flops): the forward in eval mode under
    :func:`..observability.costs.counting` — the aten ops the flop counter
    has formulas for plus the declared work of the kernel-routed
    functions (attention, LayerNorm, cross entropy), the same on every
    route.  ``custom_ops`` hooks are not supported, as in the JAX
    package.

    ``dtypes``: one dtype string or a list matching input_size (default
    float32) — integer-input models (Embedding-first) need e.g. "int32".
    Inputs are zeros on the network's device.
    """
    from ..core.dtype import convert_dtype
    from ..observability import costs as _costs

    if custom_ops is not None:
        raise NotImplementedError(
            "flops(custom_ops=...) is not supported: the count is the flop "
            "counter's plus the kernels' declared work; use the profiler "
            "for a custom op")
    try:
        device = next(net.parameters()).device
    except StopIteration:
        device = torch.device("cpu")
    if inputs is None:
        if input_size is None:
            raise ValueError("flops needs input_size=[shape, ...] or inputs")
        shapes = input_size if isinstance(input_size[0], (list, tuple)) \
            else [input_size]
        if dtypes is None:
            dts = ["float32"] * len(shapes)
        elif isinstance(dtypes, str):
            dts = [dtypes] * len(shapes)
        else:
            dts = list(dtypes)
            if len(dts) != len(shapes):
                raise ValueError(
                    f"dtypes has {len(dts)} entries for {len(shapes)} "
                    "input shapes")
        inputs = [torch.zeros(tuple(int(d) for d in s),
                              dtype=convert_dtype(dt), device=device)
                  for s, dt in zip(shapes, dts)]
    was_training = getattr(net, "training", True)
    net.eval()
    try:
        with torch.no_grad(), _costs.counting() as count:
            net(*inputs)
    finally:
        if was_training:
            net.train()
    total = int(count.total)
    if print_detail:
        print(f"FLOPs (counted + declared kernel work): {total:,}")
    return total
