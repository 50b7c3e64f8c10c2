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
because every step replays on one stream, one at a time, and the engine
copies a step's outputs out of the pool before it queues the next
replay: a block one graph uses as scratch may be another graph's
scratch, never a live output.  One allocation outlives the capture that
made it: cuBLAS's cached workspace for the capture stream (32 MiB),
taken from the pool of the capture that first runs a matmul while that
cache is empty.  It stays allocated while cached, so no capture is
handed it, and the graphs that use it replay one at a time as well.
With a private pool a graph (torch 2.11, CUDA 12.8, H100), dropping the
graph whose pool held that workspace and capturing others made a later
replay inside a ``torch.profiler`` trace segfault on the host;
``tools/torch_graph_pool_probe.py`` reproduces it, and the same
sequence on the shared pool runs and replays bit for bit.

There is no eager retreat: a failed capture or replay raises.
"""
from __future__ import annotations

import torch

__all__ = ["CapturedStep", "capture"]

_POOL = []          # the process's one graph pool, made lazily


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
    inactive).
    """
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        # two eager calls: lazy library and workspace set-up, autotune
        # picks and allocator growth happen here, never in the capture
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=_shared_pool()):
        outputs = fn()
    torch.cuda.synchronize()
    return CapturedStep(graph, outputs,
                        torch.cuda.memory_reserved() - reserved)
