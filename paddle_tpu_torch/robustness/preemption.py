"""Preemption-safe shutdown (port of
``paddle_tpu/robustness/preemption.py``): catch the platform's eviction
signal and turn it into a cooperative flag that the serving front end
polls at its iteration boundary, so it stops admitting and finishes what
it holds before the process leaves.

Spot and preemptible machines deliver SIGTERM with a short grace window
before the hard kill.  The default behavior — interpreter death
mid-request — drops every open stream.  The guard turns the signal into
a flag; :data:`PREEMPTED_RC` lets a supervisor tell "evicted, restart
me" from "crashed, back off".

Env: ``PADDLE_TPU_PREEMPTION_SIGNAL`` — comma-separated signal names or
numbers to treat as preemption notice (default ``SIGTERM``; add
``SIGUSR1`` for schedulers that use a softer pre-notice).
"""
from __future__ import annotations

import os
import signal
import sys
import threading
import weakref
from typing import List, Optional

__all__ = ["PREEMPTED_RC", "PreemptionGuard", "simulate"]

#: Exit code of a worker that drained and left on preemption notice.
#: 75 = BSD EX_TEMPFAIL ("temporary failure, retry"): restart-eligible,
#: never counted as a crash.
PREEMPTED_RC = 75

#: every constructed guard, so chaos `Preempt` can flip them without a
#: real signal (signal delivery is unsafe under pytest / non-main threads)
_guards: "weakref.WeakSet[PreemptionGuard]" = weakref.WeakSet()


def _signals_from_env() -> List[signal.Signals]:
    spec = os.environ.get("PADDLE_TPU_PREEMPTION_SIGNAL", "SIGTERM")
    out = []
    for tok in (t.strip() for t in spec.split(",")):
        if not tok:
            continue
        if tok.isdigit():
            out.append(signal.Signals(int(tok)))
        elif hasattr(signal, tok):
            out.append(getattr(signal, tok))
        else:
            raise ValueError(
                "PADDLE_TPU_PREEMPTION_SIGNAL: unknown signal %r" % tok)
    if not out:
        raise ValueError("PADDLE_TPU_PREEMPTION_SIGNAL is set but empty")
    return out


class PreemptionGuard:
    """Flag-flipping signal handler for cooperative preemption handling
    (the serving front end's ``guard=``).

    ``install=True`` (default) registers the handler immediately — only
    valid on the main thread, as CPython requires.  ``install=False``
    builds a passive guard whose flag is flipped by :func:`simulate` (the
    chaos path) or :meth:`set` — useful in tests and worker threads.

    The previous handler for each signal is saved and restored by
    :meth:`uninstall` (also run on context-manager exit); it is NOT
    chained at signal time — the whole point is to *replace* the default
    die-now behavior with a boundary-checked flag.
    """

    def __init__(self, signals=None, install: bool = True):
        self._flag = threading.Event()
        self._pending_flight: Optional[str] = None  # deferred dump source
        self._pending_lock = threading.Lock()       # exactly-once claim
        self.signals = list(signals) if signals is not None \
            else _signals_from_env()
        self._old = {}
        self._installed = False
        _guards.add(self)
        if install:
            self.install()

    # -- handler lifecycle --------------------------------------------------
    def install(self) -> "PreemptionGuard":
        if not self._installed:
            for sig in self.signals:
                self._old[sig] = signal.signal(sig, self._on_signal)
            self._installed = True
        return self

    def uninstall(self):
        if self._installed:
            for sig, old in self._old.items():
                try:
                    signal.signal(sig, old)
                except (ValueError, OSError):  # non-main thread / torn down
                    pass
            self._old.clear()
            self._installed = False

    def _on_signal(self, signum, frame):
        # signal-handler frame: flip the flag and DEFER the flight dump.
        # The handler interrupts the main thread mid-bytecode — it may
        # be inside the flight ring's / a metric's non-reentrant lock,
        # and a synchronous dump here could deadlock (or do heavy IO at
        # the worst moment).  The dump fires at the first `preempted`
        # poll, which is exactly the drain boundary this guard exists
        # to reach.
        self._flag.set()
        self._pending_flight = "signal:%s" % signal.Signals(signum).name
        sys.stderr.write(
            "[preemption] received %s — draining at the next iteration "
            "boundary (rc=%d)\n"
            % (signal.Signals(signum).name, PREEMPTED_RC))
        sys.stderr.flush()

    def _fire(self, source: str):
        """Flip the flag; the FIRST fire per armed window also triggers a
        flight-recorder dump (the black box's 'we are being evicted'
        snapshot — no-op unless the recorder is armed).  Only called
        from normal (non-signal) frames: `set()`/chaos `simulate()`, or
        the deferred-signal path in :meth:`preempted`."""
        first = not self._flag.is_set()
        self._flag.set()
        if first:
            self._dump_flight(source)

    def _dump_flight(self, source: str):
        from ..observability import flight as _flight
        _flight.record("preemption", source=source)
        _flight.crash_dump({"kind": "preemption", "source": source})

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False

    # -- flag ---------------------------------------------------------------
    @property
    def preempted(self) -> bool:
        p = self._flag.is_set()
        if p and self._pending_flight is not None:
            # first safe-context poll after a real signal: emit the
            # deferred flight dump here (normal frame, no interrupted
            # locks beneath us).  The claim is locked so two concurrent
            # pollers produce exactly one dump.
            with self._pending_lock:
                src, self._pending_flight = self._pending_flight, None
            if src is not None:
                self._dump_flight(src)
        return p

    def set(self):
        """Flip the flag programmatically (chaos / external schedulers)."""
        self._fire("set")

    def clear(self):
        self._flag.clear()
        self._pending_flight = None

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._flag.wait(timeout)


def simulate() -> int:
    """Flip every live guard's flag, as the real signal handler would.
    Returns how many guards were flipped.  This is what the chaos
    ``Preempt`` action calls — deterministic, thread-safe, no kernel
    signal delivery involved."""
    flipped = 0
    for g in list(_guards):
        g.set()
        flipped += 1
    return flipped
