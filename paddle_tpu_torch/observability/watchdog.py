"""The recompile watchdog (port of ``paddle_tpu/observability/watchdog.py``)
— turn silent re-"compiles" into a loud runtime signal.

The JAX package instruments its compile-once jit entries by watching
each jit's program-cache size.  The port compiles nothing: what it builds
once and then reuses is a CUDA-graph capture of a serving step
(:mod:`..serving.graphs`) or a compiled 1F1B pipeline step, and a second
build of either is the same bug class (something that should be static
is churning underneath the caller).  So a :class:`WatchedEntry` here is
told of each build by its owner (:meth:`WatchedEntry.compiled`), under
the JAX package's entry names:

* ``serving.decode`` — a capture of the engine's "decode" step
  (``DecodeEngine._step_graph``), budget 1 per routing;
* ``serving.spec_verify`` — a capture of its "spec" (verify) step,
  budget 1 per routing;
* ``serving.prefill_chunk`` — a capture of its paged prefill "chunk",
  budget 1 per routing;
* ``pipeline.1f1b_step`` — a build of ``_CompiledPipelineStep``
  (``PipelineParallel.train_batch``), budget 1;
* ``jit.train_step`` — a ``jit.TrainStep`` runs eagerly and builds
  nothing; it registers a count of 1 at its first call, what the JAX
  step's steady state shows, and never more.

A routing is what the engine keys a captured step on besides its kind
(the LayerNorm route and the decode attention's autotune pick): JAX
retraces nothing when a global flag flips, while the port captures one
graph for each routing it serves, so each new routing raises the entry's
budget by one, and a second capture of a routing already seen (a graph
dropped and captured again) is the over-budget event.  The JAX engine's
other entries (``serving.prefill``, ``serving.cow_copy``,
``serving.kv_export``, ``serving.kv_import``) run eagerly in the port and
have nothing to count.

Every build increments ``compile.count{entry=<name>}`` in the default
metrics registry and writes a ``"recompile"`` flight record; a build past
the budget emits ONE structured :class:`RecompileWarning` — or raises
:class:`RecompileError` under ``PADDLE_TPU_STRICT_COMPILE=1``, after a
``"recompile"`` crash dump.
"""
from __future__ import annotations

import json
import os
import threading
import warnings
import weakref
from typing import Dict, Optional

from . import registry as _registry

__all__ = ["RecompileWarning", "RecompileError", "WatchedEntry", "watch",
           "compile_counts", "strict_mode"]


class RecompileWarning(UserWarning):
    """A supposedly build-once entry built again at runtime."""


class RecompileError(RuntimeError):
    """Strict-mode (PADDLE_TPU_STRICT_COMPILE=1) recompile failure: a
    CI/bench kill switch, not a recoverable signal."""


def strict_mode() -> bool:
    return os.environ.get("PADDLE_TPU_STRICT_COMPILE", "0") not in (
        "0", "", "false", "off")


#: process-wide table of watched entries: name -> [weakref, ...] (several
#: engines may watch the same logical entry name; counts sum).  Weak on
#: purpose: an entry belongs to its engine or step, which a strong global
#: table would pin for the life of the process.
_ENTRIES: Dict[str, list] = {}
_ENTRIES_LOCK = threading.Lock()


class WatchedEntry:
    """One build-once entry and its budget; its owner reports each build
    (:meth:`compiled`)."""

    def __init__(self, name: str, expected: Optional[int] = None):
        self._name = name
        self._expected = expected
        self._count = 0
        self._routings: set = set()
        self._counter = _registry.counter("compile.count", ("entry",))
        self._lock = threading.Lock()
        with _ENTRIES_LOCK:
            refs = _ENTRIES.setdefault(name, [])
            refs[:] = [r for r in refs if r() is not None]
            refs.append(weakref.ref(self))

    @property
    def entry_name(self) -> str:
        return self._name

    @property
    def compile_count(self) -> int:
        """Builds this entry has reported."""
        return self._count

    @property
    def budget(self) -> Optional[int]:
        """``expected`` times the routings seen (at least one), or None."""
        if self._expected is None:
            return None
        return self._expected * max(len(self._routings), 1)

    def compiled(self, routing=None):
        """Report a build (of ``routing``, a hashable key; None for an entry
        with one routing), meter it and check the budget."""
        with self._lock:
            if routing is not None:
                self._routings.add(routing)
            self._count += 1
            count, budget = self._count, self.budget
        self._counter.labels(entry=self._name).inc()
        from . import flight as _flight
        _flight.record("recompile", entry=self._name, compile_count=count,
                       expected=budget)
        if budget is not None and count > budget:
            payload = json.dumps({
                "event": "recompile", "entry": self._name,
                "compile_count": count, "expected": budget},
                sort_keys=True)
            if strict_mode():
                # black-box dump BEFORE the raise: the strict error is
                # fatal by design, so this is the post-mortem's one shot
                _flight.crash_dump({
                    "kind": "recompile", "entry": self._name,
                    "compile_count": count, "expected": budget})
                raise RecompileError(
                    "compile-once violation: %s — the entry %r has been "
                    "built %d times (budget %d); something that should be "
                    "static is varying across calls"
                    % (payload, self._name, count, budget))
            warnings.warn(
                "RECOMPILE %s — entry %r built %d time(s) against a budget "
                "of %d (set PADDLE_TPU_STRICT_COMPILE=1 to make this fatal)"
                % (payload, self._name, count, budget),
                RecompileWarning, stacklevel=3)


def watch(name: str, expected: Optional[int] = None) -> WatchedEntry:
    """A watched entry.  ``expected`` is the build budget a routing (1 for
    build-once entries, None to meter without a budget)."""
    return WatchedEntry(name, expected)


def compile_counts() -> Dict[str, int]:
    """{entry name: builds} summed over every live watched entry of the
    process (the JAX package's bench lines carry the same dict)."""
    with _ENTRIES_LOCK:
        items = [(name, [e for e in (r() for r in refs) if e is not None])
                 for name, refs in sorted(_ENTRIES.items())]
    return {name: sum(e.compile_count for e in entries)
            for name, entries in items if entries}
