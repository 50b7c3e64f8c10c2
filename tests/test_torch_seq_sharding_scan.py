"""The GPT's sequence sharding over ``sep`` in the scan-layers layout
(``GPTConfig(scan_layers=True)``: the stacked blocks, each with the ring
inside its attention) against the JAX package's one-device
``TrainStep``, on one four-rank gloo world: the scan runs of
``test_torch_seq_sharding.RUNS`` ({"sep": 2}, {"dp": 2, "sep": 2} with
``in_shardings`` ``P("dp", "sep")`` and ``P("dp")``, AdamW and SGD, with
recompute), five steps' losses to 1e-5 of JAX's and the first step's
gradients JAX's (``hold_run``)."""
import pytest

import _torch_dist
from test_torch_seq_sharding import RUNS, hold_run


@pytest.fixture(scope="module")
def world():
    w = _torch_dist.World(4)
    yield w
    w.close()


@pytest.mark.parametrize("name", sorted(n for n in RUNS if RUNS[n][2]))
def test_scan_layers_sequence_sharded_steps_track_jax(world, name):
    hold_run(world, name)

