"""Deterministic fault injection (port of
``paddle_tpu/robustness/faultpoints.py``).

Modules mark their failure-prone operations with *faultpoints* — named
sites like ``faultpoint("serve.stream", rid=...)`` placed immediately
before (or after) the real IO/compute they shadow.  With no
:class:`FaultPlan` active the call is one module-attribute load and a
``None`` check — cheap enough to stay in the serving paths permanently.

Under ``chaos(plan)`` a seeded :class:`FaultPlan` fires scheduled
:class:`FaultAction`\\ s at exact site-hit indices, so every recovery
path (a client disconnect, a dying scheduler thread, a drain, a stall)
is testable with *deterministic* failures: the same plan against the
same code fires the same faults at the same operations, every run — and
at the same indices as the JAX package's plan of the same seed.

Faults raise REAL exception types (``ConnectionResetError``) tagged
``(injected)`` — the hardened code must handle them exactly as it would
the genuine article — or stall, flip a preemption guard, or end the
process.

Sites are declared with :func:`declare` at import time of the
instrumented module; :data:`SITES` is the live injection-site registry.
``TornFile`` and ``BitFlip`` corrupt the staging file of a host-tier
fetch (``serve.kv_tier``), a host-staged handoff (``serve.handoff``) or
a checkpoint's shard (``checkpoint.shard_file``,
``checkpoint.restore_read``); ``DiskFull`` raises ENOSPC where a
checkpoint's shard is written (``checkpoint.shard_write``).  The JAX
package's training actions (``NaNBatch``, ``ForceFoundInf``) wait for
their sites (ROADMAP.md §A6).
"""
from __future__ import annotations

import contextlib
import errno as _errno
import os
import random
import threading
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "FaultPlan", "FaultAction", "chaos", "faultpoint", "declare",
    "active_plan", "SITES",
    "Raise", "DiskFull", "SocketReset", "TornFile", "BitFlip", "Preempt",
    "HardExit", "Hang",
    "CrashScopeExit", "crash_scope",
]

#: name -> one-line description of what failure the site simulates.
SITES: Dict[str, str] = {}

#: the installed plan; read unlocked on the (hot) disabled path.
_ACTIVE: Optional["FaultPlan"] = None


def declare(name: str, doc: str = "") -> str:
    """Register an injection site (idempotent).  Called at import time by
    the instrumented module so the registry mirrors the instrumentation."""
    SITES[name] = doc or SITES.get(name, "")
    return name


def faultpoint(name: str, **ctx) -> Optional[Dict[str, Any]]:
    """The per-site hook.  Disabled: one global read + None check.  Enabled:
    routes through the active plan, which may raise an injected fault or
    mutate ``ctx``; the (possibly mutated) ctx is returned so instrumented
    code can read back in-place corruptions (e.g. a poisoned batch)."""
    plan = _ACTIVE
    if plan is None:
        return None
    return plan._hit(name, ctx)


def active_plan() -> Optional["FaultPlan"]:
    return _ACTIVE


@contextlib.contextmanager
def chaos(plan: "FaultPlan"):
    """Install ``plan`` as the process-wide fault plan for the scope.

    Module-global (not thread-local) on purpose: faults must also fire on
    background threads the production code owns (the front end's
    scheduler and event-loop threads), which a thread-local plan would
    never reach."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("nested chaos() scopes are not supported")
    _ACTIVE = plan
    try:
        yield plan
    finally:
        _ACTIVE = None


# --------------------------------------------------------------------------
# actions
# --------------------------------------------------------------------------

class FaultAction:
    """One injected failure.  ``fire`` either raises or mutates ``ctx``."""

    def fire(self, ctx: Dict[str, Any], plan: "FaultPlan"):  # pragma: no cover
        raise NotImplementedError

    def __repr__(self):
        return type(self).__name__


class Raise(FaultAction):
    """Raise ``exc`` (an instance, or a zero-arg factory/type)."""

    def __init__(self, exc):
        self._exc = exc

    def fire(self, ctx, plan):
        exc = self._exc() if callable(self._exc) else self._exc
        raise exc


class DiskFull(Raise):
    """ENOSPC at the site: a full disk (or quota) under a checkpoint
    write."""

    def __init__(self):
        super().__init__(lambda: OSError(
            _errno.ENOSPC, "No space left on device (injected)"))


class SocketReset(Raise):
    """Transient peer reset — what a client that went away looks like
    to a socket write."""

    def __init__(self):
        super().__init__(
            lambda: ConnectionResetError(
                _errno.ECONNRESET, "Connection reset by peer (injected)"))


class TornFile(FaultAction):
    """Truncate ``ctx['path']`` to ``frac`` of its size: a write that the
    OS acknowledged but never fully reached the disk."""

    def __init__(self, frac: float = 0.5):
        self.frac = float(frac)

    def fire(self, ctx, plan):
        path = ctx["path"]
        size = os.path.getsize(path)
        os.truncate(path, max(0, int(size * self.frac)))


class BitFlip(FaultAction):
    """Flip one bit of ``ctx['path']`` at a plan-seeded offset (bit rot, a
    partial page flush).  Deterministic given the plan seed: the offset
    and the bit are the JAX package's for the same plan."""

    def fire(self, ctx, plan):
        path = ctx["path"]
        size = os.path.getsize(path)
        if size == 0:
            return
        off = plan.rng.randrange(size)
        with open(path, "r+b") as f:
            f.seek(off)
            byte = f.read(1)
            f.seek(off)
            f.write(bytes([byte[0] ^ (1 << plan.rng.randrange(8))]))


class Preempt(FaultAction):
    """Simulated SIGTERM: flips every live PreemptionGuard's flag exactly
    as the real signal handler would (no actual signal delivery, so it is
    safe inside pytest workers and background threads)."""

    def fire(self, ctx, plan):
        from . import preemption
        preemption.simulate()


class CrashScopeExit(BaseException):
    """A :class:`HardExit` that fired inside a :func:`crash_scope`.

    ``BaseException`` on purpose: the scope models a *process death*, so
    no ``except Exception`` recovery handler between the faultpoint and
    the scope boundary may swallow it — only the harness that opened the
    scope (a thread standing in for a process, a test worker) catches it and
    dies the way the real process would."""

    def __init__(self, rc: int = 137):
        super().__init__("simulated process crash (rc=%d)" % rc)
        self.rc = rc


_CRASH_SCOPE = threading.local()


@contextlib.contextmanager
def crash_scope():
    """Contain :class:`HardExit` to the current thread.

    In-process fault drills that model one *process* per thread need a
    crash to kill that thread's work, not the test runner: inside this
    scope a fired ``HardExit`` raises :class:`CrashScopeExit` instead of
    calling ``os._exit``.  Subprocess chaos scripts keep the real thing
    by simply not opening a scope.  Thread-local and re-entrant."""
    prev = getattr(_CRASH_SCOPE, "active", False)
    _CRASH_SCOPE.active = True
    try:
        yield
    finally:
        _CRASH_SCOPE.active = prev


class HardExit(FaultAction):
    """``os._exit(rc)`` — a crash with no cleanup, for subprocess chaos
    scripts that die mid-write.  Inside a :func:`crash_scope` the same
    injection degrades to raising :class:`CrashScopeExit` so an
    in-process thread can die like the process it stands in
    for without taking the host process down."""

    def __init__(self, rc: int = 137):
        self.rc = rc

    def fire(self, ctx, plan):
        if getattr(_CRASH_SCOPE, "active", False):
            raise CrashScopeExit(self.rc)
        os._exit(self.rc)


class Hang(FaultAction):
    """Sleep ``seconds`` at the site, then let the operation proceed —
    the injected *stall* (a wedged device call, a deadlocked peer)
    rather than an injected crash.  Nothing raises and
    nothing is corrupted: the only signal is the missing progress,
    which is exactly what the liveness watchdog
    (:mod:`..observability.liveness`) exists to detect.
    Composes with every plan schedule like any other action."""

    def __init__(self, seconds: float = 1.0):
        self.seconds = float(seconds)

    def fire(self, ctx, plan):
        import time
        time.sleep(self.seconds)

    def __repr__(self):
        return "Hang(%gs)" % self.seconds


# --------------------------------------------------------------------------
# plan
# --------------------------------------------------------------------------

class _Rule:
    __slots__ = ("site", "action", "at", "every", "first_n", "prob",
                 "times", "fired_count")

    def __init__(self, site, action, at, every, first_n, prob, times):
        self.site = site
        self.action = action
        self.at = at
        self.every = every
        self.first_n = first_n
        self.prob = prob
        self.times = times
        self.fired_count = 0

    def should_fire(self, index: int, rng: random.Random) -> bool:
        if self.times is not None and self.fired_count >= self.times:
            return False
        if self.at is not None:
            return index == self.at
        if self.every is not None:
            return index % self.every == 0
        if self.first_n is not None:
            return index < self.first_n
        if self.prob is not None:
            return rng.random() < self.prob
        return index == 0  # default: fire on the first hit only

    def describe(self):
        sched = ("at=%r" % self.at if self.at is not None else
                 "every=%r" % self.every if self.every is not None else
                 "first_n=%r" % self.first_n if self.first_n is not None else
                 "prob=%r" % self.prob if self.prob is not None else "at=0")
        return "%s[%s -> %r]" % (self.site, sched, self.action)


class FaultPlan:
    """A seeded, scheduled set of fault rules.

    ``inject(site, action, at=k)`` fires ``action`` on the site's k-th hit
    (0-based, counted per plan); ``every=n`` / ``first_n=n`` / ``prob=p``
    (plan-RNG, so seeded-deterministic) / ``times=m`` (cap total firings)
    compose the schedule.  ``plan.fired`` logs every firing as
    ``(site, hit_index, action_name)`` for post-hoc assertions, and
    ``assert_all_fired()`` fails a test whose scheduled faults never ran
    (a chaos test that silently injected nothing proves nothing).
    """

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self.rng = random.Random(self.seed)
        self._rules: List[_Rule] = []
        self._counts: Dict[str, int] = {}
        self._lock = threading.Lock()
        self.fired: List[Tuple[str, int, str]] = []

    def inject(self, site: str, action: FaultAction, *, at: Optional[int] = None,
               every: Optional[int] = None, first_n: Optional[int] = None,
               prob: Optional[float] = None,
               times: Optional[int] = None) -> "FaultPlan":
        if site not in SITES:
            raise ValueError(
                "unknown faultpoint site %r — declared sites: %s (declare() "
                "test-local sites before injecting into them)"
                % (site, sorted(SITES)))
        if isinstance(action, type):
            action = action()
        if not isinstance(action, FaultAction):
            raise TypeError("action must be a FaultAction, got %r"
                            % (type(action).__name__,))
        self._rules.append(_Rule(site, action, at, every, first_n, prob,
                                 times))
        return self

    # -- runtime -----------------------------------------------------------
    def _hit(self, site: str, ctx: Dict[str, Any]) -> Dict[str, Any]:
        with self._lock:
            index = self._counts.get(site, 0)
            self._counts[site] = index + 1
            due = [r for r in self._rules
                   if r.site == site and r.should_fire(index, self.rng)]
            for r in due:
                r.fired_count += 1
                self.fired.append((site, index, repr(r.action)))
        # fire OUTSIDE the lock: an action may block, exit, or re-enter
        # another faultpoint via the recovery path it triggers
        if due:
            from ..observability import flight as _flight
            from ..observability import registry as _metrics
            _metrics.counter("robustness.faultpoint_fires",
                             ("site",)).labels(site=site).inc(len(due))
            for r in due:
                _flight.record("faultpoint", site=site, index=index,
                               action=repr(r.action))
        for r in due:
            try:
                r.action.fire(ctx, self)
            except BaseException as e:
                # a faultpoint-raised crash is a flight-dump trigger: the
                # ring already holds the firing event recorded above
                _flight.crash_dump({
                    "kind": "faultpoint", "site": site, "index": index,
                    "action": repr(r.action), "error": repr(e)})
                raise
        return ctx

    # -- assertions --------------------------------------------------------
    def hits(self, site: str) -> int:
        """How many times the site was reached (fired or not)."""
        return self._counts.get(site, 0)

    def fired_at(self, site: str) -> List[int]:
        return [i for s, i, _a in self.fired if s == site]

    def assert_all_fired(self):
        unfired = [r.describe() for r in self._rules if r.fired_count == 0]
        if unfired:
            raise AssertionError(
                "scheduled faults never fired (instrumented site not "
                "reached?): %s" % ", ".join(unfired))
