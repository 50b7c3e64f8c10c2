"""paddle.callbacks — training callbacks namespace (port of
``paddle_tpu/callbacks.py``; reference: python/paddle/callbacks.py
re-exporting hapi/callbacks.py).

Callback/ProgBarLogger/ModelCheckpoint/LRScheduler/EarlyStopping live in
paddle_tpu_torch.hapi; ReduceLROnPlateau and VisualDL are defined here
(reference hapi/callbacks.py:1010 ReduceLROnPlateau, :743 VisualDL —
VisualDL's writer is replaced by a JSONL scalar log, visualdl itself being
a non-goal dependency)."""
from __future__ import annotations

import json
import os

from .hapi import (Callback, EarlyStopping, LRScheduler, ModelCheckpoint,
                   ProgBarLogger)

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "VisualDL",
           "LRScheduler", "EarlyStopping", "ReduceLROnPlateau",
           "DivergenceMonitor"]


class DivergenceMonitor(Callback):
    """Watch the training loss through a
    :class:`paddle_tpu_torch.robustness.sentinel.DivergenceSentinel` and roll the model's
    TrainStep back to the last good snapshot when it diverges
    (NaN/Inf or a ``spike_factor``× spike over the rolling median).

    hapi integration notes: the sentinel binds lazily to
    ``model._train_step`` (built on the first train batch), and a rewind
    restores parameters/optimizer/LR/RNG and dropout-generator state but does NOT replay data
    batches — fit() continues with the next batch, which is the right
    trade for a callback (loops that need bit-identical replay drive the
    sentinel directly, see ROBUSTNESS.md).  After ``max_rewinds`` rewinds
    the monitor stops training (``model.stop_training``): a run that keeps
    diverging needs a human, not an infinite rollback loop.
    """

    def __init__(self, monitor="loss", max_rewinds=3, **sentinel_kwargs):
        super().__init__()
        self.monitor = monitor
        self.max_rewinds = max_rewinds
        self._sentinel_kwargs = dict(sentinel_kwargs)
        self._sentinel_kwargs.setdefault("snapshot_every", 10)
        self._sentinel = None
        self._step = 0
        self.rewinds = 0

    def _current(self, logs):
        v = (logs or {}).get(self.monitor)
        if isinstance(v, (list, tuple)):
            v = v[0] if v else None
        return None if v is None else float(v)

    def on_train_batch_end(self, step, logs=None):
        from .robustness.sentinel import DivergenceSentinel

        train_step = getattr(self.model, "_train_step", None)
        value = self._current(logs)
        if train_step is None or value is None or \
                getattr(self.model, "stop_training", False):
            return
        if self._sentinel is None or self._sentinel.train_step \
                is not train_step:
            self._sentinel = DivergenceSentinel(train_step,
                                                **self._sentinel_kwargs)
        self._step += 1
        import sys

        from .robustness.sentinel import DivergenceError
        try:
            rewound = self._sentinel.observe(self._step, value) is not None
        except DivergenceError as e:
            # ring exhausted (e.g. divergence before the first snapshot):
            # a callback must stop training, not crash fit()
            sys.stderr.write("DivergenceMonitor: %s — stopping training\n"
                             % e)
            self.model.stop_training = True
            return
        if rewound:
            self.rewinds += 1
            if self.rewinds >= self.max_rewinds:
                sys.stderr.write(
                    "DivergenceMonitor: %d rewind(s) exhausted — stopping "
                    "training\n" % self.rewinds)
                self.model.stop_training = True


class ReduceLROnPlateau(Callback):
    """Reduce optimizer LR when a monitored metric stops improving
    (reference hapi/callbacks.py ReduceLROnPlateau semantics: factor,
    patience, min_delta, cooldown, min_lr)."""

    def __init__(self, monitor="loss", factor=0.1, patience=10, verbose=1,
                 mode="auto", min_delta=1e-4, cooldown=0, min_lr=0.0):
        self.monitor = monitor
        self.factor = float(factor)
        if self.factor >= 1.0:
            raise ValueError("ReduceLROnPlateau does not support a factor "
                             ">= 1.0")
        self.patience = patience
        self.verbose = verbose
        self.min_delta = abs(min_delta)
        self.cooldown = cooldown
        self.min_lr = min_lr
        if mode not in ("auto", "min", "max"):
            mode = "auto"
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode
        self.cooldown_counter = 0
        self.wait = 0
        self.best = float("inf") if self.mode == "min" else -float("inf")

    def _better(self, current):
        if self.mode == "min":
            return current < self.best - self.min_delta
        return current > self.best + self.min_delta

    def _current(self, logs):
        v = (logs or {}).get(self.monitor)
        if isinstance(v, (list, tuple)):
            v = v[0]
        return None if v is None else float(v)

    def on_eval_end(self, logs=None):
        current = self._current(logs)
        if current is None:
            return
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.wait = 0
        if self._better(current):
            self.best = current
            self.wait = 0
        elif self.cooldown_counter <= 0:
            self.wait += 1
            if self.wait >= self.patience:
                opt = getattr(self.model, "_optimizer", None)
                if opt is not None:
                    old = float(opt.get_lr())
                    new = max(old * self.factor, self.min_lr)
                    if old - new > 1e-12:
                        try:
                            opt.set_lr(new)
                        except RuntimeError:
                            return  # LRScheduler-driven: scheduler owns lr
                        if self.verbose:
                            print("ReduceLROnPlateau: reducing learning "
                                  "rate to %g." % new)
                self.cooldown_counter = self.cooldown
                self.wait = 0


class VisualDL(Callback):
    """Scalar-logging callback (reference hapi/callbacks.py VisualDL).
    The visualdl writer is a non-goal dependency; scalars are appended to
    ``<log_dir>/scalars.jsonl`` (one {"tag", "step", "value"} per line),
    which covers the callback's train/eval scalar contract."""

    def __init__(self, log_dir="./log"):
        self.log_dir = log_dir
        self.epochs = 0
        self.steps = 0
        self._path = None

    def _write(self, tag, step, value):
        if self._path is None:
            os.makedirs(self.log_dir, exist_ok=True)
            self._path = os.path.join(self.log_dir, "scalars.jsonl")
        try:
            value = float(value)
        except (TypeError, ValueError):
            return
        with open(self._path, "a") as f:
            f.write(json.dumps({"tag": tag, "step": int(step),
                                "value": value}) + "\n")

    def on_train_batch_end(self, step, logs=None):
        self.steps += 1
        for k, v in (logs or {}).items():
            if isinstance(v, (list, tuple)):
                v = v[0] if v else None
            if v is not None:
                self._write("train/%s" % k, self.steps, v)

    def on_eval_end(self, logs=None):
        self.epochs += 1
        for k, v in (logs or {}).items():
            if k in ("batch_size", "steps"):
                continue
            if isinstance(v, (list, tuple)):
                v = v[0] if v else None
            if v is not None:
                self._write("eval/%s" % k, self.epochs, v)
