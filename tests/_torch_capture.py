"""A CPU stand-in for ``serving.graphs.capture``, shared by the tests
that rehearse captured steps without a card: a replay runs the step again
and copies its output into the first call's buffer, as a graph's replay
rewrites its static output.  Imports no JAX."""
from paddle_tpu_torch.serving.graphs import CapturedStep


class _StandInGraph:
    def __init__(self, fn):
        self.fn, self.out = fn, fn()

    def replay(self):
        self.out.copy_(self.fn())


def stand_in_capture(fn):
    """``graphs.capture``'s stand-in: patch it over
    ``paddle_tpu_torch.serving.engine.capture`` and set the engine's
    ``_capture``."""
    g = _StandInGraph(fn)
    return CapturedStep(g, g.out, 0)
