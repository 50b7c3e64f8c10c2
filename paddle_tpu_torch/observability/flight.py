"""The black-box flight recorder (port of
``paddle_tpu/observability/flight.py``): a bounded ring of recent
span/engine events plus a state snapshot, dumped to a timestamped file
when the process hits a terminal fault.

Aggregate metrics say *that* a run died; the flight recorder says what
the last N things it did were.  While active it keeps:

* a **fixed-size ring** of recent events — finished tracing spans (fed
  by :mod:`.tracing` when both are enabled), faultpoint fires,
  preemption notices, liveness stalls — cheap host-side dict appends,
  drop-oldest;
* a registry of live :class:`~paddle_tpu_torch.serving.engine.DecodeEngine`
  objects (weakrefs — recording never pins an engine) whose state
  summary (slot table, page-pool occupancy, graph captures) is collected
  at dump time.  An engine's summary reads host state only, so a dump
  taken after a CUDA error never touches the device;
* optionally, the **pre-reset cumulative metrics snapshot**: a caller of
  ``Registry.reset()`` runs ``note_registry_reset()`` immediately BEFORE
  the reset, and every later dump carries the cumulative view as
  ``metrics_pre_reset``.

Dump triggers: a faultpoint action that raises
(:mod:`..robustness.faultpoints`), a preemption-guard fire
(:mod:`..robustness.preemption`), a liveness stall
(:mod:`.liveness`), and two further classes:

* **Uncaught worker-thread exceptions** — :func:`threading.excepthook` is
  chained at import: the dying thread's name, exception, and all-thread
  stacks land in a ``"thread_exception"`` dump before the previous hook
  (CPython's stderr print) runs.  One ``None`` check when the recorder
  is off.  A thread that catches its own death (the serving front
  end's scheduler thread) calls :func:`thread_exception_dump` itself.
* **Manual postmortem on signal** — ``PADDLE_TPU_FLIGHT_SIGNAL=SIGQUIT``
  (any signal name/number list) installs a handler that dumps
  all-thread stacks to stderr *from the handler frame* (faulthandler's
  C implementation: safe even when every Python lock is held) and then
  fires the ring dump from a fresh thread (kind ``"signal"``).

Each dump is one JSON file ``flight-<stamp>-<pid>-<seq>.json`` in
``PADDLE_TPU_FLIGHT_DIR`` (default: cwd) holding the trigger, the ring,
the current metrics snapshot (catalog-valid by construction — it is the
default registry's own), the pre-reset snapshot when noted, and every
live engine's state summary.  The JAX package's dumps also carry
compile-watchdog counts and an HBM-ledger snapshot; the port's engines
report their graph captures in their own summaries, and the HBM ledger
waits for its module (ROADMAP.md §A6).

Disabled by default (``PADDLE_TPU_FLIGHT=0``): ``record()`` is one
module-global ``None`` check and dump triggers no-op, so tests and
production opt in via the env var or :func:`enable`.  Dumping never
raises: a broken flight dump must not mask the fault that triggered it.
"""
from __future__ import annotations

import faulthandler
import json
import os
import signal as _signal
import sys
import threading
import time
import weakref
from collections import deque
from typing import Any, Dict, List, Optional

from . import registry as _registry

__all__ = [
    "FlightRecorder", "enable", "disable", "active", "record",
    "register_engine", "note_registry_reset", "crash_dump",
    "last_dump_path", "RING_DEFAULT", "install_signal_handler",
    "thread_exception_dump",
]

#: default ring capacity (events); override with PADDLE_TPU_FLIGHT_RING
RING_DEFAULT = 256

#: live engines whose state summaries land in dumps; module-level (not
#: per-recorder) so engines built before enable() are still covered
_ENGINES: "weakref.WeakSet" = weakref.WeakSet()

_ACTIVE: Optional["FlightRecorder"] = None
_LOCK = threading.Lock()
_SEQ = 0


class FlightRecorder:
    def __init__(self, dir: Optional[str] = None,
                 capacity: Optional[int] = None):
        self.dir = dir or os.environ.get("PADDLE_TPU_FLIGHT_DIR") or "."
        cap = capacity if capacity is not None else int(os.environ.get(
            "PADDLE_TPU_FLIGHT_RING", RING_DEFAULT))
        self.ring: deque = deque(maxlen=max(int(cap), 1))
        # reentrant: dump() records the trigger then re-reads the ring,
        # and crash paths can re-enter record() from under a dump
        self._lock = threading.RLock()
        self._pre_reset_metrics: Optional[dict] = None
        self.dumps: List[str] = []

    # -- recording ---------------------------------------------------------

    def record(self, kind: str, **fields):
        ev = {"kind": str(kind), "wall_ts": time.time(),
              "perf_ns": time.perf_counter_ns()}
        ev.update(fields)
        with self._lock:
            self.ring.append(ev)
        return ev

    def note_registry_reset(self, snapshot: Optional[dict] = None):
        """Preserve the cumulative metrics view a ``Registry.reset()`` is
        about to zero (call IMMEDIATELY BEFORE the reset — the ordering
        contract OBSERVABILITY.md documents)."""
        self._pre_reset_metrics = (snapshot if snapshot is not None
                                   else _registry.default_registry()
                                   .snapshot())
        self.record("registry_reset")

    # -- dumping -----------------------------------------------------------

    def _engine_states(self) -> List[dict]:
        out = []
        for e in list(_ENGINES):
            try:
                out.append(e.flight_state())
            except Exception as exc:    # a torn engine must not kill dumps
                out.append({"error": repr(exc)})
        return out

    def dump(self, trigger: Dict[str, Any],
             path: Optional[str] = None) -> str:
        """Write one flight-dump file; returns its path.  The trigger is
        recorded and the ring copied in ONE critical section, so the
        triggering event is always the dump's newest ring entry — a
        concurrent thread's record() can neither displace nor evict it."""
        try:
            metrics = _registry.default_registry().snapshot()
        except Exception:
            metrics = {}
        with self._lock:    # RLock: record() below re-enters it
            self.record("trigger", detail=dict(trigger))
            ring = list(self.ring)
            pre = self._pre_reset_metrics
        doc = {
            "format": "paddle_tpu_torch-flight-v1",
            "wall_ts": time.time(),
            "perf_ns": time.perf_counter_ns(),
            "pid": os.getpid(),
            "trigger": dict(trigger),
            "ring": ring,
            "ring_capacity": self.ring.maxlen,
            "metrics": metrics,
            "metrics_pre_reset": pre,
            "engines": self._engine_states(),
        }
        if path is None:
            global _SEQ
            with _LOCK:
                _SEQ += 1
                seq = _SEQ
            os.makedirs(self.dir, exist_ok=True)
            path = os.path.join(
                self.dir, "flight-%s-%d-%d.json"
                % (time.strftime("%Y%m%dT%H%M%S"), os.getpid(), seq))
        with open(path, "w") as f:
            json.dump(doc, f, sort_keys=True)
            f.write("\n")
        self.dumps.append(path)
        return path


# ---------------------------------------------------------------------------
# module-level API (what the instrumented subsystems call)
# ---------------------------------------------------------------------------

def enable(dir: Optional[str] = None,
           capacity: Optional[int] = None) -> FlightRecorder:
    """Install (or replace) the process-wide recorder."""
    global _ACTIVE
    with _LOCK:
        _ACTIVE = FlightRecorder(dir=dir, capacity=capacity)
        return _ACTIVE


def disable():
    global _ACTIVE
    with _LOCK:
        _ACTIVE = None


def active() -> Optional[FlightRecorder]:
    return _ACTIVE


def record(kind: str, **fields):
    """Ring append when a recorder is active; one global ``None`` check
    otherwise (cheap enough for the instrumented fault paths)."""
    r = _ACTIVE
    if r is None:
        return None
    return r.record(kind, **fields)


def register_engine(engine):
    """Track a serving engine (weakref) for dump-time state summaries.
    Always cheap; engines register unconditionally at construction."""
    _ENGINES.add(engine)


def note_registry_reset(snapshot: Optional[dict] = None):
    r = _ACTIVE
    if r is None:
        return None
    return r.note_registry_reset(snapshot)


def crash_dump(trigger: Dict[str, Any]) -> Optional[str]:
    """Dump on a terminal fault; never raises (a failed dump must not
    mask the fault being reported).  Returns the path or None."""
    r = _ACTIVE
    if r is None:
        return None
    try:
        path = r.dump(trigger)
        sys.stderr.write("[flight] dumped %s (trigger: %s)\n"
                         % (path, trigger.get("kind")))
        return path
    except Exception as e:
        sys.stderr.write("[flight] dump FAILED: %r\n" % (e,))
        return None


def last_dump_path() -> Optional[str]:
    r = _ACTIVE
    if r is None or not r.dumps:
        return None
    return r.dumps[-1]


# ---------------------------------------------------------------------------
# uncaught worker-thread exceptions
# ---------------------------------------------------------------------------

def _all_thread_stacks() -> str:
    from .liveness import all_thread_stacks
    return all_thread_stacks()


_PREV_THREAD_EXCEPTHOOK = None


def thread_exception_dump(thread_name: str, exc: BaseException,
                          tb=None) -> Optional[str]:
    """One ``"thread_exception"`` flight dump for a dying worker thread
    (the excepthook below and any component that catches its own
    thread's death — the serving frontend — share this, so the dump
    shape cannot drift).  One ``None`` check when the recorder is
    disarmed: the stack collection is never paid for nothing.  Never
    raises."""
    if _ACTIVE is None:
        return None
    try:
        import traceback as _tb
        tb_text = "".join(_tb.format_exception(
            type(exc), exc, exc.__traceback__ if tb is None else tb))
        record("thread_exception", thread=thread_name, error=repr(exc))
        # "traceback" is the dying thread's unwound frames; "stacks" is
        # every OTHER thread at death time (a hook runs on the dying
        # thread, whose live frames are the hook's own)
        return crash_dump({"kind": "thread_exception",
                           "thread": thread_name, "error": repr(exc),
                           "traceback": tb_text,
                           "stacks": _all_thread_stacks()})
    except Exception:
        return None   # never mask the thread's own traceback print


def _thread_excepthook(args):
    """Chained :func:`threading.excepthook`: a worker thread dying on an
    uncaught exception gets a black-box record BEFORE the interpreter's
    default stderr print — today that death is otherwise invisible to
    every postmortem (the typed triggers only cover faults the hardened
    code anticipated).  SystemExit is a normal thread exit, not a
    fault."""
    if args.exc_type is not SystemExit and args.exc_value is not None:
        name = args.thread.name if args.thread is not None else "?"
        thread_exception_dump(name, args.exc_value,
                              tb=args.exc_traceback)
    _PREV_THREAD_EXCEPTHOOK(args)


def _install_thread_excepthook():
    global _PREV_THREAD_EXCEPTHOOK
    if _PREV_THREAD_EXCEPTHOOK is None:
        _PREV_THREAD_EXCEPTHOOK = threading.excepthook
        threading.excepthook = _thread_excepthook


_install_thread_excepthook()


# ---------------------------------------------------------------------------
# manual postmortem trigger: PADDLE_TPU_FLIGHT_SIGNAL
# ---------------------------------------------------------------------------

def _on_flight_signal(signum, frame):
    # the Python half of the postmortem: the all-thread stderr stacks
    # already fired from faulthandler's C-LEVEL handler (registered
    # with chain=True below — it runs even while the main thread is
    # wedged inside native code, the motivating hang; THIS handler only
    # runs at the next bytecode boundary).  Here we add the ring dump,
    # on a FRESH thread: it needs Python locks and file IO, and if the
    # process is wedged on a lock the C stacks still landed, which is
    # the postmortem that matters.
    name = _signal.Signals(signum).name
    try:
        sys.stderr.write("[flight] %s received — all-thread stacks "
                         "dumped; writing the flight ring\n" % name)
        sys.stderr.flush()
    except Exception:
        pass

    def _dump():
        stacks = _all_thread_stacks()
        record("signal", signal=name)
        crash_dump({"kind": "signal", "signal": name, "stacks": stacks})

    threading.Thread(target=_dump, name="flight-signal-dump",
                     daemon=True).start()


def install_signal_handler(spec: Optional[str] = None) -> List[str]:
    """Install the manual-postmortem handler for every signal named in
    ``spec`` (or ``$PADDLE_TPU_FLIGHT_SIGNAL``): comma-separated names
    or numbers, e.g. ``SIGQUIT``.  Two layers per signal: a
    ``faulthandler.register(..., chain=True)`` C-level handler (the
    all-thread stack dump — fires even when the main thread is blocked
    inside a native call, where a Python-level handler can never run)
    chained onto a Python handler that adds the flight ring dump when
    the interpreter next reaches a bytecode boundary.  Returns the
    names installed; no-op (empty list) when unset or not on the main
    thread."""
    spec = spec if spec is not None else os.environ.get(
        "PADDLE_TPU_FLIGHT_SIGNAL", "")
    installed = []
    for tok in (t.strip() for t in spec.split(",")):
        if not tok:
            continue
        if tok.isdigit():
            sig = _signal.Signals(int(tok))
        elif hasattr(_signal, tok):
            sig = getattr(_signal, tok)
        else:
            raise ValueError(
                "PADDLE_TPU_FLIGHT_SIGNAL: unknown signal %r" % tok)
        try:
            # Python handler FIRST, then the C handler chains to it:
            # stacks dump immediately in C, the ring dump follows when
            # (if) the main thread returns to Python
            _signal.signal(sig, _on_flight_signal)
            faulthandler.register(sig, all_threads=True, chain=True)
        except (ValueError, OSError, RuntimeError, AttributeError):
            # not the main thread, an uncatchable signal (SIGKILL), or
            # a platform without register(): skip, never crash
            continue
        installed.append(sig.name)
    return installed


# import-time install degrades LOUDLY, never fatally: a typo'd value in
# an optional postmortem knob must not make `import paddle_tpu_torch` itself
# crash every job that never wanted the handler
try:
    install_signal_handler()
except (ValueError, OSError) as _e:
    sys.stderr.write("[flight] PADDLE_TPU_FLIGHT_SIGNAL ignored: %s\n"
                     % (_e,))


# env opt-in: PADDLE_TPU_FLIGHT=1 arms the recorder at import time (the
# registry's env-knob discipline; PADDLE_TPU_FLIGHT_DIR/_RING configure it)
if os.environ.get("PADDLE_TPU_FLIGHT", "0") not in ("0", "", "false",
                                                    "off"):
    enable()
