"""Divergence detection and rollback (port of
``paddle_tpu/robustness/sentinel.py``): catch NaN/Inf and loss spikes,
rewind the training state to the last good host-side snapshot instead of
letting a poisoned update walk the run off a cliff.

A diverged step is *worse* than a crashed one: the optimizer state is
already contaminated when the loss curve shows it, and periodic
checkpoints happily persist the contamination.  The sentinel keeps a
bounded ring of host-RAM snapshots taken only after steps whose loss
passed inspection, and on a trip restores the newest one — falling back
to older snapshots on repeated trips until the ring runs dry, which
raises a typed :class:`DivergenceError`.

A snapshot holds what a bit-for-bit replay needs: a host copy of
``TrainStep.state_dict()`` (masters, optimizer slots and step, the LR
scheduler), the GradScaler's state, the default generators
(``core.random.get_rng_state``) and the states of the step's explicit
dropout generators (``incubate.checkpoint.step_generators``, the set
``TrainEpochRange.register_train_step`` saves: the JAX package's keys
live in its step state, the port's masks come from these generators, so
a replay at dropout > 0 needs them).  A rewind goes through
``set_state_dict``, counts ``train.divergence_rollbacks`` and writes a
flight record; with the ring empty it writes a ``"divergence"`` crash
dump and raises.

Composition with the fp16 skip path: when a ``GradScaler`` already
*skipped* the update that produced a non-finite loss, the parameters were
never touched — the sentinel counts those but only rewinds after
``scaler_grace`` consecutive skipped-and-bad steps, letting dynamic loss
scaling do its job first.

``last_snapshot_bytes`` / ``last_snapshot_seconds`` and
``last_rewind_seconds`` say what the latest snapshot held on the host and
what it and the latest rewind took on the host clock.
"""
from __future__ import annotations

import math
import time
import warnings
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

__all__ = ["DivergenceError", "DivergenceWarning", "DivergenceSentinel"]


class DivergenceError(RuntimeError):
    """Loss diverged and no usable snapshot remains to rewind to."""


class DivergenceWarning(UserWarning):
    """Emitted (loudly) on every rewind, naming the step rewound to."""


def _generators(train_step):
    """The explicit generators of a step with a model (none for a step
    that has no ``model``: a stub holding only its state)."""
    if getattr(train_step, "model", None) is None:
        return []
    from ..incubate.checkpoint import step_generators
    return step_generators(train_step)


class DivergenceSentinel:
    """Watch the loss stream of a ``jit.TrainStep``-style trainer; rewind
    on divergence.

    ``train_step`` needs only ``state_dict()``/``set_state_dict()`` (the
    incubate.checkpoint contract, which ``jit.TrainStep`` implements).

    Trip conditions, checked by :meth:`observe`:

    * non-finite loss (NaN/Inf), or
    * ``loss > spike_factor * median(recent window)`` once at least
      ``min_history`` finite losses are recorded.

    ``observe(step, loss)`` returns ``None`` for a healthy step, or the
    snapshot step that was restored — the caller re-runs from the batch
    AFTER that step (data order and RNG state rewind with the snapshot, so
    the replayed trajectory is bit-identical to a never-diverged run).
    """

    def __init__(self, train_step, scaler=None, *, window: int = 32,
                 spike_factor: float = 10.0, min_history: int = 5,
                 snapshot_every: int = 10, max_snapshots: int = 3,
                 scaler_grace: int = 3):
        if max_snapshots < 1:
            raise ValueError("max_snapshots must be >= 1")
        self.train_step = train_step
        self.scaler = scaler
        self.window = int(window)
        self.spike_factor = float(spike_factor)
        self.min_history = int(min_history)
        self.snapshot_every = int(snapshot_every)
        self.scaler_grace = int(scaler_grace)
        self._losses: Deque[Tuple[int, float]] = deque(maxlen=self.window)
        self._ring: Deque[Dict[str, Any]] = deque(maxlen=int(max_snapshots))
        self._skip_streak = 0
        self.rewinds: List[Tuple[int, int, float]] = []  # (bad_step, to, loss)
        self.last_snapshot_bytes = 0
        self.last_snapshot_seconds = None
        self.last_rewind_seconds = None

    # -- snapshots ----------------------------------------------------------
    def snapshot(self, step: int):
        """Host-side copy of everything a bit-identical replay needs.
        ``_to_host`` (the checkpoint fetch) copies device tensors into host
        RAM, so later in-place updates of the device state cannot corrupt
        the ring retroactively."""
        from ..core.random import get_rng_state
        from ..incubate.checkpoint import _host_tree_bytes, _to_host

        t0 = time.perf_counter()
        snap = {"step": int(step),
                "train": _to_host(self.train_step.state_dict()),
                "rng": get_rng_state(),
                "generators": [g.get_state()
                               for g in _generators(self.train_step)]}
        if self.scaler is not None and hasattr(self.scaler, "state_dict"):
            snap["scaler"] = dict(self.scaler.state_dict())
        self._ring.append(snap)
        self.last_snapshot_seconds = time.perf_counter() - t0
        self.last_snapshot_bytes = _host_tree_bytes(snap["train"])

    @property
    def snapshots_available(self) -> int:
        return len(self._ring)

    # -- observation --------------------------------------------------------
    def _baseline(self) -> Optional[float]:
        if len(self._losses) < self.min_history:
            return None
        vals = sorted(v for _s, v in self._losses)
        mid = len(vals) // 2
        return vals[mid] if len(vals) % 2 else 0.5 * (vals[mid - 1]
                                                      + vals[mid])

    def _is_bad(self, loss: float) -> bool:
        if not math.isfinite(loss):
            return True
        base = self._baseline()
        return base is not None and abs(loss) > self.spike_factor * \
            max(abs(base), 1e-12)

    def observe(self, step: int, loss) -> Optional[int]:
        """Inspect ``loss`` for step ``step``.  Healthy: record it,
        snapshot on schedule, return ``None``.  Diverged: rewind and return
        the restored snapshot's step."""
        lv = float(loss)
        if self._is_bad(lv):
            skipped = self.scaler is not None and getattr(
                self.scaler, "last_step_skipped", False)
            if skipped:
                # the fp16 gate already refused this update — params are
                # intact; give loss scaling `scaler_grace` steps to adapt
                self._skip_streak += 1
                if self._skip_streak < self.scaler_grace:
                    return None
            return self.rewind(bad_step=step, bad_loss=lv)
        self._skip_streak = 0
        self._losses.append((int(step), lv))
        if self.snapshot_every > 0 and step % self.snapshot_every == 0:
            self.snapshot(step)
        return None

    # -- rollback -----------------------------------------------------------
    def rewind(self, bad_step: Optional[int] = None,
               bad_loss: float = float("nan")) -> int:
        """Restore the newest snapshot (consuming it — a re-trip falls back
        to the next-older one).  Returns the restored snapshot's step."""
        from ..core.random import set_rng_state
        from ..incubate.checkpoint import _from_host
        from ..observability import flight as _flight
        from ..observability import registry as _metrics

        if not self._ring:
            _flight.crash_dump({
                "kind": "divergence", "step": bad_step,
                "loss": repr(bad_loss), "rewinds": len(self.rewinds)})
            raise DivergenceError(
                "loss diverged at step %s (loss=%r) and the snapshot ring "
                "is exhausted — no known-good state to rewind to; restore "
                "from the last on-disk checkpoint instead"
                % (bad_step, bad_loss))
        t0 = time.perf_counter()
        snap = self._ring.pop()
        self.train_step.set_state_dict(_from_host(snap["train"]))
        set_rng_state(snap["rng"])
        gens = _generators(self.train_step)
        if len(gens) != len(snap["generators"]):
            raise ValueError("snapshot holds %d generator states, the step "
                             "has %d generators"
                             % (len(snap["generators"]), len(gens)))
        for g, state in zip(gens, snap["generators"]):
            g.set_state(state)
        if self.scaler is not None and "scaler" in snap and hasattr(
                self.scaler, "load_state_dict"):
            self.scaler.load_state_dict(dict(snap["scaler"]))
            if hasattr(self.scaler, "_last_skipped"):
                self.scaler._last_skipped = False
        # drop loss history recorded after the restored step: it belongs
        # to the abandoned timeline and would skew the spike baseline
        while self._losses and self._losses[-1][0] > snap["step"]:
            self._losses.pop()
        self._skip_streak = 0
        self.rewinds.append((int(bad_step) if bad_step is not None else -1,
                             snap["step"], bad_loss))
        self.last_rewind_seconds = time.perf_counter() - t0
        _metrics.counter("train.divergence_rollbacks").inc()
        _flight.record("divergence_rollback", bad_step=bad_step,
                       to_step=snap["step"], loss=repr(bad_loss))
        warnings.warn(
            "divergence at step %s (loss=%r): rewound training state to "
            "step %d (%d snapshot(s) left)"
            % (bad_step, bad_loss, snap["step"], len(self._ring)),
            DivergenceWarning, stacklevel=3)
        return snap["step"]
