"""The liveness watchdog (port of
``paddle_tpu/observability/liveness.py``): stall detection for a process
that is alive but no longer making progress.

The rest of the observability stack fires on *crashes* — faultpoint
raises, a preemption notice, a dying thread.  A server's worst failures
are *hangs*: a wedged device call, a deadlocked front-end thread.  Those
produce no signal until an external timeout kills the job, and the
postmortem then holds nothing, because the process never "failed".

Instrumented code plants named progress **beacons** at its hot
boundaries (the serving scheduler step, the front end's scheduler and
event-loop threads) and a monitor thread watches them:

* A :class:`Beacon` is a monotonic progress counter + a
  ``perf_counter_ns`` stamp + an *inflight* depth.  Instrumented code
  either wraps one bounded operation in ``with beacon:`` (enter stamps
  and raises inflight; exit stamps, counts, lowers it) or, for
  long-running loops, calls :meth:`Beacon.begin` once and
  :meth:`Beacon.pulse` per iteration.  A beacon is only *watched* while
  ``inflight > 0`` — an idle subsystem never false-positives.
* The :class:`LivenessMonitor` thread checks every beacon against its
  deadline (global ``PADDLE_TPU_LIVENESS_DEADLINE``, per-beacon
  ``PADDLE_TPU_LIVENESS_DEADLINE_<NAME>`` with dots spelled as
  underscores, or the default declared with the beacon).  On a stall it
  dumps **all-thread stacks** (via :func:`faulthandler.dump_traceback`)
  to stderr AND into a flight dump with a ``"stall"`` trigger naming
  the stalled beacon, increments the catalog'd
  ``liveness.stalls{beacon=}`` counter, and — when
  ``PADDLE_TPU_LIVENESS_EXIT_RC`` is set — hard-exits with that rc so a
  supervisor respawns the worker (a hung worker becomes a restartable
  crash instead of a silent wedge).
* A fired stall re-arms only after the beacon makes progress (any new
  stamp), so a 10-minute hang produces one dump, not one per poll.

Disabled by default: with no monitor installed :func:`beacon` hands out
the module-level :data:`NOOP_BEACON` singleton **by identity** —
instrumented hot loops that fetched their handle once pay one empty
method call and allocate nothing.  Arm with ``PADDLE_TPU_LIVENESS=1`` or
:func:`enable` BEFORE constructing what is to be watched.

Beacons are *declared* (:func:`declare_beacon`) at import time of the
instrumented module, faultpoint-site style: :data:`BEACONS` mirrors the
instrumentation, ``liveness.stalls``'s label space stays bounded, and a
typo'd beacon name fails at fetch time instead of silently never being
watched.  The env knobs are the JAX package's names.
"""
from __future__ import annotations

import faulthandler
import os
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional

from . import registry as _registry

__all__ = [
    "Beacon", "NoopBeacon", "NOOP_BEACON", "LivenessMonitor",
    "BEACONS", "declare_beacon", "beacon", "enable", "disable",
    "active", "state", "deadline_for", "all_thread_stacks",
    "DEADLINE_DEFAULT",
]

#: global default deadline (seconds) when neither the env nor the
#: declaration specifies one.  Generous: the first pass through a step
#: may build kernels and capture graphs.
DEADLINE_DEFAULT = 300.0

#: name -> {"doc", "deadline"}: every declared beacon (the instrumented
#: module declares at import time, so this registry mirrors the
#: instrumentation — OBSERVABILITY.md documents it, the liveness suite
#: asserts against it).
BEACONS: Dict[str, dict] = {}

_ACTIVE: Optional["LivenessMonitor"] = None
_LOCK = threading.Lock()

#: beacons of the most recently stopped monitor — a disable()/enable()
#: cycle must not orphan handles components cached at construction (the
#: same carry-over enable() does for a live replacement)
_CARRIED_BEACONS: Dict[str, "Beacon"] = {}


def declare_beacon(name: str, doc: str = "",
                   deadline: Optional[float] = None) -> str:
    """Register a beacon name (idempotent), with an optional default
    deadline.  Called at import time by the instrumented module."""
    prev = BEACONS.get(name, {})
    BEACONS[name] = {
        "doc": doc or prev.get("doc", ""),
        "deadline": deadline if deadline is not None
        else prev.get("deadline"),
    }
    return name


def all_thread_stacks() -> str:
    """Every thread's current stack, one faulthandler-formatted block
    per thread.  faulthandler needs a real fd, so this round-trips
    through an anonymous temp file; never raises (a postmortem helper
    must not mask the fault being reported)."""
    try:
        with tempfile.TemporaryFile(mode="w+") as f:
            faulthandler.dump_traceback(file=f, all_threads=True)
            f.seek(0)
            return f.read()
    except Exception as e:  # pragma: no cover - faulthandler/IO failure
        return "<all_thread_stacks failed: %r>" % (e,)


# ---------------------------------------------------------------------------
# beacons
# ---------------------------------------------------------------------------

class Beacon:
    """One named progress marker.  ``with beacon:`` brackets a bounded
    operation (watched while inside); :meth:`pulse` marks progress from
    inside a long-running guarded loop; :meth:`begin`/:meth:`done` are
    the explicit spelling for loops without a ``with``-shaped scope
    (the frontend loop-thread heartbeat).

    A beacon is shared by every caller of its name, so the stall clock
    is tracked **per inflight entry** (one stamp per outstanding
    begin, keyed per thread): a wedged op cannot be masked by sibling
    ops on the same beacon completing or pulsing — the watchdog watches
    the OLDEST outstanding entry, and only its own thread's
    :meth:`pulse` refreshes it."""

    __slots__ = ("name", "count", "last_ns", "_lock", "_entries",
                 "_next_id", "_tls")

    def __init__(self, name: str):
        self.name = name
        self.count = 0                     # completed ops / pulses
        self.last_ns = time.perf_counter_ns()
        self._lock = threading.Lock()
        self._entries: Dict[int, int] = {}   # entry id -> stamp_ns
        self._next_id = 0
        self._tls = threading.local()        # per-thread entry-id stack

    def _stack(self):
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    # -- progress marks ----------------------------------------------------

    def pulse(self):
        """Mark progress (and re-stamp this thread's innermost
        outstanding entry, if any) without changing inflight."""
        now = time.perf_counter_ns()
        st = self._stack()
        with self._lock:
            self.count += 1
            self.last_ns = now
            if st and st[-1] in self._entries:
                self._entries[st[-1]] = now

    def begin(self):
        now = time.perf_counter_ns()
        with self._lock:
            eid = self._next_id
            self._next_id += 1
            self._entries[eid] = now
            self.last_ns = now
        self._stack().append(eid)
        return self

    def done(self):
        st = self._stack()
        eid = st.pop() if st else None
        with self._lock:
            if eid is not None:
                self._entries.pop(eid, None)
            self.count += 1
            self.last_ns = time.perf_counter_ns()

    def __enter__(self):
        return self.begin()

    def __exit__(self, *exc):
        # an op that RAISED still completed (the failure surfaces through
        # its own channel) — only a hang is a stall
        self.done()
        return False

    # -- readout -----------------------------------------------------------

    @property
    def inflight(self) -> int:
        with self._lock:
            return len(self._entries)

    def oldest_ns(self) -> Optional[int]:
        """Stamp of the oldest outstanding entry (None when idle) — the
        stall clock: refreshed only by that entry's own progress."""
        with self._lock:
            return min(self._entries.values()) if self._entries else None

    def age_s(self, now_ns: Optional[int] = None) -> float:
        """Seconds since the oldest outstanding entry's stamp (watched),
        or since the last completion (idle)."""
        now_ns = time.perf_counter_ns() if now_ns is None else now_ns
        oldest = self.oldest_ns()
        ref = oldest if oldest is not None else self.last_ns
        return max(now_ns - ref, 0) * 1e-9


class NoopBeacon:
    """The disabled-path beacon: every method is a constant no-op (the
    registry's NOOP_* discipline — assertable by identity)."""

    __slots__ = ()
    name = "<noop>"
    count = 0
    inflight = 0

    def pulse(self):
        pass

    def begin(self):
        return self

    def done(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def oldest_ns(self):
        return None

    def age_s(self, now_ns=None):
        return 0.0


#: the singleton a disabled liveness stack hands out — instrumented code
#: asserts the fast path by identity.
NOOP_BEACON = NoopBeacon()


# ---------------------------------------------------------------------------
# the monitor
# ---------------------------------------------------------------------------

def _env_float(name: str) -> Optional[float]:
    """Degrade-loudly env parse: a typo'd observability knob must never
    crash `import paddle_tpu_torch`, kill a monitor poll, or blank /healthz —
    it warns on stderr once per read and falls through to the next
    resolution tier (the PADDLE_TPU_FLIGHT_SIGNAL discipline)."""
    v = os.environ.get(name)
    if v in (None, ""):
        return None
    try:
        return float(v)
    except ValueError:
        sys.stderr.write("[liveness] %s ignored: %r is not a float\n"
                         % (name, v))
        return None


def _env_name(beacon_name: str) -> str:
    return ("PADDLE_TPU_LIVENESS_DEADLINE_"
            + beacon_name.upper().replace(".", "_"))


def _resolve_deadline(name: str, fallback: float) -> float:
    """THE deadline resolution chain (one copy): per-beacon env >
    declared default > ``fallback`` (the caller's global default)."""
    env = _env_float(_env_name(name))
    if env is not None:
        return env
    declared = BEACONS.get(name, {}).get("deadline")
    if declared is not None:
        return float(declared)
    return fallback


class LivenessMonitor:
    """Watches every fetched beacon from a daemon thread.

    ``deadline``/``poll``/``exit_rc`` override the env knobs
    (``PADDLE_TPU_LIVENESS_DEADLINE`` / ``_POLL`` / ``_EXIT_RC``);
    tests pass ``start=False`` to :func:`enable` and drive
    :meth:`check_now` deterministically."""

    def __init__(self, deadline: Optional[float] = None,
                 poll: Optional[float] = None,
                 exit_rc: Optional[int] = None):
        d = deadline if deadline is not None else _env_float(
            "PADDLE_TPU_LIVENESS_DEADLINE")
        self.default_deadline = float(d) if d is not None \
            else DEADLINE_DEFAULT
        p = poll if poll is not None else _env_float(
            "PADDLE_TPU_LIVENESS_POLL")
        self.poll = float(p) if p is not None \
            else max(min(self.default_deadline / 4.0, 5.0), 0.01)
        if exit_rc is None:
            rc = os.environ.get("PADDLE_TPU_LIVENESS_EXIT_RC")
            if rc not in (None, ""):
                try:
                    exit_rc = int(rc)
                except ValueError:
                    sys.stderr.write(
                        "[liveness] PADDLE_TPU_LIVENESS_EXIT_RC ignored:"
                        " %r is not an int\n" % (rc,))
        self.exit_rc = exit_rc
        self._beacons: Dict[str, Beacon] = {}
        self._lock = threading.Lock()
        # beacon -> last_ns observed when its stall fired: re-arm only
        # after the beacon re-stamps (one dump per hang, not per poll)
        self._fired_stamp: Dict[str, int] = {}
        self.stall_log: List[dict] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._m_stalls = _registry.counter("liveness.stalls", ("beacon",))

    # -- beacon fetch ------------------------------------------------------

    def beacon(self, name: str) -> Beacon:
        if name not in BEACONS:
            raise ValueError(
                "unknown liveness beacon %r — declared beacons: %s "
                "(declare_beacon() test-local names before fetching "
                "them)" % (name, sorted(BEACONS)))
        with self._lock:
            b = self._beacons.get(name)
            if b is None:
                b = Beacon(name)
                self._beacons[name] = b
        return b

    def deadline_for(self, name: str) -> float:
        # per-beacon env re-read live; the GLOBAL default was seeded at
        # construction (enable() replaces the monitor to change it)
        return _resolve_deadline(name, self.default_deadline)

    # -- stall detection ---------------------------------------------------

    def state(self) -> Dict[str, dict]:
        """Per-beacon liveness view (the /healthz
        payload): count, inflight, age, deadline, stalled — computed on
        read, so a probe sees the stall as soon as the age crosses the
        deadline even between monitor polls."""
        now_ns = time.perf_counter_ns()
        with self._lock:
            beacons = dict(self._beacons)
        out = {}
        for name, b in sorted(beacons.items()):
            deadline = self.deadline_for(name)
            age = b.age_s(now_ns)
            out[name] = {
                "count": b.count,
                "inflight": b.inflight,
                "age_s": round(age, 6),
                "deadline_s": deadline,
                "stalled": bool(b.inflight > 0 and age > deadline),
            }
        return out

    def check_now(self, now_ns: Optional[int] = None) -> List[dict]:
        """One monitor pass; returns the stalls fired (tests drive this
        directly with ``enable(start=False)``)."""
        now_ns = time.perf_counter_ns() if now_ns is None else now_ns
        with self._lock:
            beacons = list(self._beacons.values())
        fired = []
        for b in beacons:
            # the stall clock is the OLDEST outstanding entry's own
            # stamp: sibling ops completing/pulsing on the shared
            # beacon cannot mask a wedged one
            stamp = b.oldest_ns()
            if stamp is None:              # idle: unwatched
                continue
            deadline = self.deadline_for(b.name)
            age = max(now_ns - stamp, 0) * 1e-9
            if age <= deadline:
                continue
            with self._lock:
                # check_now runs on the monitor thread AND directly on
                # callers' threads (tests, manual probes): the fired-
                # stamp dedup must be atomic or one hang reports twice
                if self._fired_stamp.get(b.name) == stamp:
                    continue               # already reported this hang
                self._fired_stamp[b.name] = stamp
            fired.append(self._fire_stall(b, age, deadline))
        return fired

    def _fire_stall(self, b: Beacon, age: float, deadline: float) -> dict:
        """The postmortem: all-thread stacks + flight dump + counter
        (+ optional hard exit).  Never raises — a broken postmortem
        must not take down a process that might still recover."""
        from . import flight as _flight
        stacks = all_thread_stacks()
        info = {
            "kind": "stall", "beacon": b.name,
            "age_s": round(age, 3), "deadline_s": deadline,
            "count": b.count, "inflight": b.inflight,
        }
        try:
            sys.stderr.write(
                "[liveness] STALL: beacon %r made no progress for %.1fs "
                "(deadline %.1fs, %d completed, %d inflight) — all-thread "
                "stacks follow\n%s" % (b.name, age, deadline, b.count,
                                       b.inflight, stacks))
            sys.stderr.flush()
        except Exception:
            pass
        try:
            self._m_stalls.labels(beacon=b.name).inc()
        except Exception:
            pass
        try:
            fields = {k: v for k, v in info.items() if k != "kind"}
            _flight.record("stall", **fields)
            path = _flight.crash_dump(dict(info, stacks=stacks))
            info["dump"] = path
        except Exception:
            info["dump"] = None
        self.stall_log.append(info)
        if self.exit_rc is not None:
            sys.stderr.write(
                "[liveness] hard-exiting rc=%d so a supervisor can "
                "respawn this worker (PADDLE_TPU_LIVENESS_EXIT_RC)\n"
                % self.exit_rc)
            sys.stderr.flush()
            os._exit(self.exit_rc)
        return info

    # -- thread lifecycle --------------------------------------------------

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="liveness-monitor", daemon=True)
            self._thread.start()
        return self

    def stop(self, timeout: float = 2.0):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
        self._thread = None

    def _run(self):
        while not self._stop.wait(self.poll):
            try:
                self.check_now()
            except Exception as e:  # pragma: no cover - defensive
                sys.stderr.write("[liveness] monitor pass failed: %r\n"
                                 % (e,))


# ---------------------------------------------------------------------------
# module-level API (what the instrumented subsystems call)
# ---------------------------------------------------------------------------

def enable(deadline: Optional[float] = None, poll: Optional[float] = None,
           exit_rc: Optional[int] = None,
           start: bool = True) -> LivenessMonitor:
    """Install (or replace) the process-wide monitor.  Beacons fetched
    while disabled are the shared no-op singleton forever (the
    registry's zero-cost contract) — arm liveness BEFORE constructing
    the components to watch (the env knob arms at import).  Replacing
    a LIVE monitor (e.g. to change the exit rc) — or re-enabling after
    a disable() — carries the previous beacon map over: components
    cached their handles at construction, and a fresh empty map would
    silently orphan every one of them."""
    global _ACTIVE
    with _LOCK:
        mon = LivenessMonitor(deadline=deadline, poll=poll,
                              exit_rc=exit_rc)
        carried = dict(_CARRIED_BEACONS)
        if _ACTIVE is not None:
            _ACTIVE.stop()
            with _ACTIVE._lock:
                carried.update(_ACTIVE._beacons)
        _CARRIED_BEACONS.clear()
        with mon._lock:
            mon._beacons.update(carried)
        _ACTIVE = mon
        if start:
            _ACTIVE.start()
        return _ACTIVE


def disable():
    global _ACTIVE
    with _LOCK:
        if _ACTIVE is not None:
            _ACTIVE.stop()
            # stash the beacon map: a later enable() must keep watching
            # the handles components already hold
            with _ACTIVE._lock:
                _CARRIED_BEACONS.update(_ACTIVE._beacons)
        _ACTIVE = None


def active() -> Optional[LivenessMonitor]:
    return _ACTIVE


def beacon(name: str):
    """The per-site handle fetch.  Disabled: one module-global ``None``
    check, then the shared :data:`NOOP_BEACON` by identity."""
    m = _ACTIVE
    if m is None:
        return NOOP_BEACON
    return m.beacon(name)


def state() -> Dict[str, dict]:
    m = _ACTIVE
    if m is None:
        return {}
    return m.state()


def deadline_for(name: str) -> float:
    m = _ACTIVE
    if m is not None:
        return m.deadline_for(name)
    # no monitor: same chain, global default read live from the env
    d = _env_float("PADDLE_TPU_LIVENESS_DEADLINE")
    return _resolve_deadline(name, d if d is not None
                             else DEADLINE_DEFAULT)


# env opt-in: PADDLE_TPU_LIVENESS=1 arms the monitor at import time (the
# flight recorder's env-knob discipline)
if os.environ.get("PADDLE_TPU_LIVENESS", "0") not in ("0", "", "false",
                                                      "off"):
    enable()
