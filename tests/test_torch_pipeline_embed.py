"""The row-sharded embedding-grad accumulator of the port's 1F1B pipeline
(``distributed/pipeline.py``: ``_Schedule`` with ``embed_shard``,
``_CompiledPipelineStep``; the JAX package's ``embed_grad_shard``), on
one four-rank gloo world, with ``_EMBED_SHARD_MIN_ELEMS`` lowered so
that the tiny embedding's leaves accumulate sharded (as
tests/test_pipeline_fleet.py lowers JAX's):

* the accumulator of each stage is the (rows / 2, ...) slice of the
  token and position tables over ``sdp`` on pp2 x sdp2, over ``dp`` on
  pp2 x dp2, and whole at the default threshold;
* pp2 x sdp2 (ZeRO stages 1 and 2) gives pp2 x dp2's losses and trained
  parameters bit for bit, both sharded;
* sharded against today's whole accumulator: 1e-6 relative (each
  microbatch is reduced before the microbatches are summed);
* ``spmd_pipeline_1f1b_hetero`` sharded over ``dp`` against the JAX
  package's, its threshold lowered alike: 1e-5."""
import numpy as np
import pytest

from paddle_tpu.distributed import pipeline as jpipe

import _torch_dist

TOL = 1e-6

DP = {"pp": 2, "dp": 2}
SDP = {"pp": 2, "sdp": 2}


@pytest.fixture(scope="module")
def world():
    w = _torch_dist.World(4)
    yield w
    w.close()


def _ids():
    return np.random.default_rng(3).integers(0, 512, (8, 16)).astype(
        np.int64)


_RUNS = {}


def _run(world, axes, stage=1, embed_min=1):
    key = (tuple(sorted(axes.items())), stage, embed_min)
    if key not in _RUNS:
        _RUNS[key] = world.run("_torch_pipe:job_pp_zero", ids=_ids(),
                               axes=axes, stage=stage, embed_min=embed_min)
    return _RUNS[key]


@pytest.mark.parametrize("axes", [DP, SDP], ids=["dp", "sdp"])
def test_the_accumulator_is_the_row_slice(world, axes):
    """Sharded: the tables' accumulators hold half their rows on every
    stage (wte (512, 64) -> (256, 64), wpe (128, 64) -> (64, 64)); at the
    default threshold they are whole."""
    for o in _run(world, axes):
        assert o["embed_acc"] == {"embed/wte.weight": (256, 64),
                                  "embed/wpe.weight": (64, 64)}, \
            o["embed_acc"]
    for o in _run(world, axes, embed_min=None):
        assert o["embed_acc"] == {"embed/wte.weight": (512, 64),
                                  "embed/wpe.weight": (128, 64)}


@pytest.mark.parametrize("stage", [1, 2])
def test_sdp_is_dp_bit_for_bit(world, stage):
    """pp2 x sdp2 at ``stage`` and pp2 x dp2, both with the accumulator
    row-sharded: the same losses and trained parameters, bit for bit."""
    ref, got = _run(world, DP), _run(world, SDP, stage)
    for a, b in zip(ref, got):
        assert a["losses"] == b["losses"]
        for k, v in a["params"].items():
            np.testing.assert_array_equal(b["params"][k], v, err_msg=k)


@pytest.mark.parametrize("axes", [DP, SDP], ids=["dp", "sdp"])
def test_sharded_tracks_the_whole_accumulator(world, axes):
    """Row-sharded against the whole accumulator (the default threshold):
    losses and trained parameters within 1e-6 relative."""
    whole = _run(world, axes, 2, embed_min=None)
    got = _run(world, axes, 2)
    for a, b in zip(whole, got):
        np.testing.assert_allclose(b["losses"], a["losses"], rtol=TOL)
        for k, v in a["params"].items():
            np.testing.assert_allclose(b["params"][k], v, rtol=TOL,
                                       atol=TOL, err_msg=k)


def test_sharded_accumulator_tracks_jax(world, monkeypatch):
    """``spmd_pipeline_1f1b_hetero`` on tests/test_pipeline_fleet.py's
    embed / block / head functions at pp2 x dp2 with
    ``embed_grad_shard=("dp", 2)`` and both packages' thresholds lowered
    to 1 (the JAX package's ``test_embed_grad_shard_exact_parity``): the
    port's loss and every gradient within 1e-5 of JAX's."""
    import jax
    import jax.numpy as jnp
    from _jax_compat import shard_map
    from jax.sharding import Mesh, PartitionSpec as JP

    from test_torch_pipeline import _hetero_inputs
    monkeypatch.setattr(jpipe, "_EMBED_SHARD_MIN_ELEMS", 1)
    params, x, labels = _hetero_inputs()
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("pp", "dp"))
    pspec = {"embed": {"we": JP()}, "blocks": {"w": JP("pp")},
             "head": {"wh": JP()}}
    pipe = jax.jit(shard_map(
        lambda p, x_, l_: jpipe.spmd_pipeline_1f1b_hetero(
            lambda ep, xb: xb @ ep["we"],
            lambda bp, h: jnp.tanh(h @ bp["w"]) + h,
            lambda hp, ep, h, lbl: jnp.mean((h @ hp["wh"] - lbl) ** 2),
            p, x_, l_, 2, 1, 4, batch_axes=("dp",),
            embed_grad_shard=("dp", 2)),
        mesh=mesh, in_specs=(pspec, JP(None, "dp"), JP(None, "dp")),
        out_specs=(JP(), pspec), check_vma=False))
    jloss, jgrads = pipe(params, x, labels)
    jgrads = jax.tree_util.tree_map(np.asarray, jgrads)
    for stage, loss, grads in world.run("_torch_pipe:job_hetero",
                                        params=params, x=x, labels=labels,
                                        pp=2, embed_min=1):
        np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
        for part, key in (("embed", "we"), ("head", "wh")):
            np.testing.assert_allclose(grads[part][key], jgrads[part][key],
                                       rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(grads["blocks"]["w"][0],
                                   jgrads["blocks"]["w"][stage], rtol=1e-5,
                                   atol=1e-6)
