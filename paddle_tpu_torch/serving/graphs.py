"""One captured step per geometry: the port's counterpart of the JAX
engine's ``jax.jit(decode_fn)`` / ``jax.jit(verify_fn)``
(``paddle_tpu/serving/engine.py``), which compile each serving step once
and dispatch it asynchronously.

PyTorch runs the model eagerly, one launch at a time from the host; a
batched decode step of GPT-2 345M is some thousand launches, and the
card sits idle while the host issues them.  :func:`capture` records one
call of a step function as a CUDA graph, and :meth:`CapturedStep.replay`
then launches every kernel of the step at once.  The engine keys each
graph on everything the capture fixes (``DecodeEngine._step_graph``):
the engine's geometry, the routing flags and autotune picks read while
the function ran, and the identity and storage of every parameter.

A step function captured here must:

* read its inputs from, and write its integer outputs to, tensors that
  live as long as the graph (a replay reads and writes the addresses the
  capture saw); a parameter updated in place is read live, a parameter
  replaced by another tensor is not;
* make no host sync and no host-to-device copy from pageable memory
  (``tensor.item()``, ``torch.tensor(x, device=...)``): both are errors
  inside a capture;
* draw no random numbers: the engine draws a step's uniforms from its
  generator into a static buffer before each replay, so the graph holds
  no generator state and a replay is one graph launch.

All captured steps of the process share ONE graph memory pool, a
``torch.cuda.MemPool`` held for the process (:func:`_shared_pool`), so
no graph's memory is ever handed back to CUDA.  Sharing is safe
because every step replays on one stream and the engine copies a step's
outputs out of the pool before any other replay is queued: a block one
graph uses as scratch may be another graph's scratch, never a live
output.  Several engines replay from several threads (the replicas of a
:class:`~.router.Router`, the two engines of a disaggregated pair), so
the engine queues a replay and the copies of its outputs under
:data:`REPLAY_LOCK`, one process lock: a replay by another engine can
never be queued between them.  One allocation outlives the capture that
made it: cuBLAS's cached workspace for the capture stream (32 MiB),
taken from the pool of the capture that first runs a matmul while that
cache is empty.  It stays allocated while cached, so no capture is
handed it, and the graphs that use it replay one at a time as well.
With a private pool a graph (torch 2.11, CUDA 12.8, H100), dropping the
graph whose pool held that workspace and capturing others made a later
replay inside a ``torch.profiler`` trace segfault on the host;
``tools/torch_graph_pool_probe.py`` reproduces it, and the same
sequence on the shared pool runs and replays bit for bit.

**Threads.**  :func:`capture` uses ``torch.cuda.graph``'s default,
global capture mode, in which a CUDA call from any other thread during
the capture (a synchronize, a counter read, a memory statistic) can fail
or invalidate it.  So a capture runs while no other thread touches the
card: the HTTP front end (:mod:`.frontend`) captures the engine's step on
the caller's thread in ``start()``, before its scheduler thread exists,
and from then on only the scheduler thread calls the engine, which
replays.  The capture mode is left as it is.  Where several threads
drive engines (the router's replica threads), the owner captures every
engine's graphs first, then :func:`seal`-s capturing: a capture asked
for while the seal holds (a replaced parameter, a new autotune pick on a
replica thread) raises :class:`CaptureSealed`, and never captures under
another thread.

**Garbage collection.**  A dead reference cycle that holds CUDA objects
(a dropped engine's graph, a pinned buffer, an event) frees them when
Python's collector runs, and a collection that runs inside a capture
destroys a graph while the stream captures, which CUDA refuses and
which invalidates the capture.  So :func:`capture` collects first and
keeps the automatic collector off until the capture ends.

There is no eager retreat: a failed capture or replay raises.
"""
from __future__ import annotations

import gc
import threading

import torch

__all__ = ["CapturedStep", "CaptureSealed", "REPLAY_LOCK", "capture",
           "seal", "unseal"]

_POOL = []          # the process's one graph pool, made lazily

#: held while an engine queues a replay and copies its outputs out of
#: the shared pool (module docstring)
REPLAY_LOCK = threading.Lock()

_SEALS = set()      # owners that forbid captures while they run threads
_SEAL_LOCK = threading.Lock()


class CaptureSealed(RuntimeError):
    """A capture was asked for while several threads may touch the card."""


def seal(owner):
    """Forbid captures until :func:`unseal` (``owner``: any hashable
    token, e.g. the router).  Seals nest by owner."""
    with _SEAL_LOCK:
        _SEALS.add(owner)


def unseal(owner):
    with _SEAL_LOCK:
        _SEALS.discard(owner)


def _shared_pool():
    """The id of a ``torch.cuda.MemPool`` held for the process: a bare
    ``graph_pool_handle()`` is released once the last graph on it is
    dropped, and the next capture on that handle then fails an internal
    assert of the caching allocator."""
    if not _POOL:
        _POOL.append(torch.cuda.MemPool())
    return _POOL[0].id


class CapturedStep:
    """A step function captured once.  ``outputs`` is what the function
    returned during the capture: tensors in the shared graph pool,
    overwritten by every replay (and by other steps' replays: copy them
    out before the next replay).  ``pool_bytes`` is the device memory
    the capture added to the pool (the growth of
    ``torch.cuda.memory_reserved()``)."""

    def __init__(self, graph, outputs, pool_bytes):
        self.graph = graph
        self.outputs = outputs
        self.pool_bytes = int(pool_bytes)
        self.replays = 0
        self.kind = None            # the engine's step kind, set by it

    def replay(self):
        """Launch the captured step on the current stream; returns
        :attr:`outputs`."""
        self.graph.replay()
        self.replays += 1
        return self.outputs


def capture(fn) -> CapturedStep:
    """Warm ``fn`` up on a side stream, then capture one call of it.

    The warm-up runs ``fn`` for real, so the caller sets its inputs to a
    state whose writes are harmless first (the engine marks every lane
    inactive).  Raises :class:`CaptureSealed` while a seal holds.
    """
    with _SEAL_LOCK:
        if _SEALS:
            raise CaptureSealed(
                "a CUDA graph capture was asked for while other threads "
                "drive engines on the card (sealed by %d owner(s)): capture "
                "every step before the threads start (capture_steps)"
                % len(_SEALS))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        # two eager calls: lazy library and workspace set-up, autotune
        # picks and allocator growth happen here, never in the capture
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    # no collection inside the capture (module docstring)
    gc.collect()
    collecting = gc.isenabled()
    gc.disable()
    try:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=_shared_pool()):
            outputs = fn()
    finally:
        if collecting:
            gc.enable()
    torch.cuda.synchronize()
    return CapturedStep(graph, outputs,
                        torch.cuda.memory_reserved() - reserved)
