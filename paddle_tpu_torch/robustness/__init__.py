"""paddle_tpu_torch.robustness — fault injection and preemption handling
(port of ``paddle_tpu.robustness``), stdlib only:

* :mod:`.faultpoints` — deterministic fault injection: named sites in
  the serving, checkpoint and training paths (``serve.step``,
  ``train.grads``, ``amp.found_inf``, ...; no-op when disabled), driven
  by a seeded :class:`FaultPlan` under ``chaos(plan)`` so every recovery
  path is testable.
* :mod:`.sentinel` — :class:`DivergenceSentinel`: host-RAM snapshots of
  a ``TrainStep`` (with its scaler, the default generators and its
  dropout generators), rewound on a NaN/Inf or spiking loss
  (``callbacks.DivergenceMonitor`` is its hapi hook).
* :mod:`.preemption` — :class:`PreemptionGuard` (SIGTERM/SIGUSR1 →
  boundary-checked flag; the serving front end drains on it) and
  :data:`PREEMPTED_RC`.
* :mod:`.retry` — jittered exponential backoff with a deadline and a
  typed terminal :class:`RetryError` (the TCPStore client's policy).
"""
from . import faultpoints  # noqa: F401
from . import preemption  # noqa: F401
from . import retry  # noqa: F401
from . import sentinel  # noqa: F401
from .faultpoints import FaultPlan, chaos, declare, faultpoint  # noqa: F401
from .preemption import PREEMPTED_RC, PreemptionGuard  # noqa: F401
from .retry import RetryError, retry_call, retrying  # noqa: F401
from .sentinel import (DivergenceError, DivergenceSentinel,  # noqa: F401
                       DivergenceWarning)

__all__ = [
    "faultpoints", "preemption", "retry", "sentinel",
    "FaultPlan", "chaos", "declare", "faultpoint",
    "PREEMPTED_RC", "PreemptionGuard",
    "RetryError", "retry_call", "retrying",
    "DivergenceError", "DivergenceSentinel", "DivergenceWarning",
]
