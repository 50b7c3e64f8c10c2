"""paddle_tpu_torch.robustness — fault injection and preemption handling
(port of ``paddle_tpu.robustness``), stdlib only:

* :mod:`.faultpoints` — deterministic fault injection: named sites in
  the serving path (``serve.step``, ``serve.stream``; no-op when
  disabled), driven by a seeded :class:`FaultPlan` under ``chaos(plan)``
  so every recovery path is testable.
* :mod:`.preemption` — :class:`PreemptionGuard` (SIGTERM/SIGUSR1 →
  boundary-checked flag; the serving front end drains on it) and
  :data:`PREEMPTED_RC`.
* :mod:`.retry` — jittered exponential backoff with a deadline and a
  typed terminal :class:`RetryError` (the TCPStore client's policy).

Not ported yet (ROADMAP.md §A6): the divergence sentinel, whose caller
(the training loop's guard) is not ported either.
"""
from . import faultpoints  # noqa: F401
from . import preemption  # noqa: F401
from . import retry  # noqa: F401
from .faultpoints import FaultPlan, chaos, declare, faultpoint  # noqa: F401
from .preemption import PREEMPTED_RC, PreemptionGuard  # noqa: F401
from .retry import RetryError, retry_call, retrying  # noqa: F401

__all__ = [
    "faultpoints", "preemption", "retry",
    "FaultPlan", "chaos", "declare", "faultpoint",
    "PREEMPTED_RC", "PreemptionGuard",
    "RetryError", "retry_call", "retrying",
]
