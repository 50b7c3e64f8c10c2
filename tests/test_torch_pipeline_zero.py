"""ZeRO inside the port's 1F1B pipeline (``distributed/pipeline.py``
``_CompiledPipelineStep`` with an ``sdp`` axis of two ranks) on one
four-rank gloo world:

* the tiny GPT pipeline (4 blocks, pp2 x sdp2, through the fleet with
  ``sharding_configs.stage`` 1, 2 and 3) against the same program on
  pp2 x dp2, which deals each data index the same rows: the losses and
  the trained parameters to 1e-6 (f32: the same sums of two, the update
  elementwise on slices), with a global-norm clip (its squares summed
  over 'pp' and 'sdp') too; a rank keeps about half the slot elements;
  stage 3 is the JAX program's stage 2 (the same losses);
* the gradients reach the optimizer as slices, reduce-scattered over
  'sdp' at stages 2 and 3, cut from the all-reduced mean at stage 1;
* tests/test_pipeline_fleet.py's ZeRO-2 x pipeline run against JAX's
  ``train_batch`` on the 8 host devices (pp2 x dp2 x sdp2 there: the
  same mean over the data-parallel ranks), that test's limits;
* chip_smoke.py's pp2_sdp2_gloo at a narrow width through its hold, and
  the hold refusing a loss one ulp past its bar, a rank whose slots are
  whole, a stage 2 that did not reduce-scatter, a rank whose
  embedding-grad accumulator is whole."""
import copy

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.distributed import pipeline as jpipe
from test_pipeline_fleet import Criterion as JCriterion
from test_pipeline_fleet import _data as jax_data
from test_pipeline_fleet import _descs as jax_descs

import _torch_dist
import _torch_pipe
import chip_smoke

TOL = 1e-6


@pytest.fixture(scope="module")
def world():
    w = _torch_dist.World(4)
    yield w
    w.close()


def _ids():
    return np.random.default_rng(3).integers(0, 512, (8, 16)).astype(
        np.int64)


_RUNS = {}


def _run(world, axes, stage=1, clip=None, opt="adamw"):
    key = (tuple(sorted(axes.items())), stage, clip, opt)
    if key not in _RUNS:
        _RUNS[key] = world.run("_torch_pipe:job_pp_zero", ids=_ids(),
                               axes=axes, stage=stage, clip=clip, opt=opt)
    return _RUNS[key]


DP = {"pp": 2, "dp": 2}
SDP = {"pp": 2, "sdp": 2}


@pytest.mark.parametrize("stage,clip,opt", [(1, None, "adamw"),
                                            (2, None, "adamw"),
                                            (1, 0.05, "sgd"),
                                            (2, 0.05, "adamw")])
def test_zero_pipeline_tracks_the_dp_pipeline(world, stage, clip, opt):
    """pp2 x sdp2 at ``stage`` against pp2 x dp2: every rank's losses and
    the trained parameters to 1e-6 (under SGD, whose step is the gradient
    itself, and with a global-norm clip); each rank of sdp holds about
    half the slot elements of a dp rank of its stage."""
    ref = _run(world, DP, clip=clip, opt=opt)
    got = _run(world, SDP, stage, clip, opt)
    by_stage = {o["stage"]: o for o in ref}
    for o in got:
        np.testing.assert_allclose(o["losses"], ref[0]["losses"], rtol=TOL)
        for k, v in ref[0]["params"].items():
            np.testing.assert_allclose(o["params"][k], v, rtol=TOL,
                                       atol=TOL, err_msg=k)
        whole = by_stage[o["stage"]]["slot_elements"]
        if opt == "sgd":               # no slots
            assert whole == o["slot_elements"] == 0
            continue
        assert 0.45 <= o["slot_elements"] / whole <= 0.55
    losses = ref[0]["losses"]
    assert losses[-1] < losses[0]


def test_stage_3_is_stage_2(world):
    """The JAX program reads ``zero_stage >= 2`` as stage 2 inside the
    pipeline: slots and grads cut, the stage's parameters whole; the
    port's stage 3 gives stage 2's losses and parameters bit for bit."""
    two, three = _run(world, SDP, 2), _run(world, SDP, 3)
    for a, b in zip(two, three):
        assert a["losses"] == b["losses"]
        for k, v in a["params"].items():
            np.testing.assert_array_equal(b["params"][k], v)
        assert a["slot_elements"] == b["slot_elements"]


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_grads_reach_the_optimizer_as_slices(world, stage):
    """Every large gradient the optimizer takes is the rank's half of its
    master along one dimension; stages 2 and 3 reduce-scatter them over
    'sdp' (a reduce-scatter a sliced master and step), stage 1 cuts them
    from the all-reduced mean (none)."""
    for o in _run(world, SDP, stage):
        sliced = 0
        for k, shape in o["first_grads"].items():
            full = o["full"][k]
            if shape != full:
                diff = [i for i, (a, b) in enumerate(zip(shape, full))
                        if a != b]
                assert len(diff) == 1 and 2 * shape[diff[0]] == \
                    full[diff[0]], (k, shape, full)
                sliced += 1
            else:
                # whole only under the JAX rule's 4096 elements (stacked
                # over the two stages' two blocks for a block master)
                n = int(np.prod(full)) * (4 if k.startswith("blocks/")
                                          else 1)
                assert n < 4096, (k, full)
        assert sliced > 0
        rs = o["collectives_per_step"].get("reduce_scatter", 0)
        assert (rs == sliced) if stage >= 2 else rs == 0, (stage, rs)


def test_zero_pipeline_matches_jax_train_batch(world):
    """tests/test_pipeline_fleet.py's ``test_fleet_pp_with_zero2``
    (slow-marked there) against the port: its tied-embedding model, Adam
    at 0.05, 3 batches of 16 in 4 microbatches, ZeRO stage 2; JAX's
    fleet at pp2 x sdp2 on 8 host devices (dp2 fills the rest), the
    port's at pp2 x sdp2 on four ranks.  Losses and trained parameters
    within that test's limits (rtol 2e-4, atol 1e-5)."""
    with paddle.set_grad_enabled(True):
        strategy = jfleet.DistributedStrategy()
        strategy.hybrid_configs = {"pp_degree": 2, "sharding_degree": 2}
        strategy.pipeline_configs = {"accumulate_steps": 4}
        strategy.sharding_configs = {"stage": 2}
        jfleet.init(is_collective=True, strategy=strategy)
        try:
            assert dict(zip(jmesh.get_mesh().axis_names,
                            jmesh.get_mesh().devices.shape)) == {
                "dp": 2, "pp": 2, "sdp": 2}
            paddle.seed(11)
            pl = jpipe.PipelineLayer(jax_descs(), num_stages=2,
                                     loss_fn=JCriterion())
            weights = {k: np.asarray(v.numpy())
                       for k, v in pl.state_dict().items()}
            model = jfleet.distributed_model(pl)
            opt = paddle.optimizer.Adam(parameters=model.parameters(),
                                        learning_rate=0.05)
            data = jax_data(3, batch=16)
            jlosses = [float(model.train_batch((x, y), opt).numpy())
                       for x, y in data]
            model.sync_to_layers()
            jparams = {k: np.asarray(v.numpy())
                       for k, v in pl.named_parameters()}
        finally:
            jmesh.init_mesh({"dp": 1})
    np_data = [(np.asarray(x.numpy()), np.asarray(y.numpy()))
               for x, y in data]
    for losses, params in world.run("_torch_pipe:job_fleet_zero",
                                    weights=weights, data=np_data, stage=2):
        np.testing.assert_allclose(losses, jlosses, rtol=2e-4, atol=1e-5)
        for k, v in jparams.items():
            np.testing.assert_allclose(params[k], v, rtol=2e-4, atol=1e-5,
                                       err_msg=k)


def test_pp2_sdp2_gloo_rehearsed_on_a_gloo_world(world):
    """chip_smoke.py's pp2_sdp2_rank on each rank at a narrow width (the
    flash route through its plain versions, counted), then
    ``pp2_sdp2_hold``: stages 1 and 2 within PP_SDP_LOSS_REL of the dp
    run, half the slot bytes, stage 2 reduce-scattering, the launches.
    A loss one ulp past the bar, a rank whose slots stayed whole, and a
    stage 2 that all-reduced instead are refused."""
    outs = world.run("_torch_pipe:job_pp2_sdp2_rank")
    spec = _torch_pipe.pp_sdp_spec()
    line = chip_smoke.pp2_sdp2_hold(outs, spec)
    assert line["sdp_stage2"]["max_loss_rel"] <= chip_smoke.PP_SDP_LOSS_REL
    assert all(0.45 <= x <= 0.55 for x in line["sdp_stage1"]["slot_share"])
    # the row-sharded accumulator: the token table's half rows a rank
    whole = line["embed_acc_whole_bytes"]
    for name, per_rank in line["embed_acc_bytes"].items():
        assert all(0.45 * whole <= b <= 0.55 * whole for b in per_rank), \
            (name, per_rank, whole)
    bad = copy.deepcopy(outs)
    bad[3]["sdp_stage2"]["embed_acc"] = dict(
        bad[3]["sdp_stage2"]["embed_shapes"])
    with pytest.raises(AssertionError, match="accumulators"):
        chip_smoke.pp2_sdp2_hold(bad, spec)
    bad = copy.deepcopy(outs)
    ref = bad[1]["dp"]["losses"][1]
    edge = ref * (1 + chip_smoke.PP_SDP_LOSS_REL)
    bad[1]["sdp_stage2"]["losses"][1] = float(np.nextafter(edge, np.inf))
    with pytest.raises(AssertionError, match="sdp_stage2: losses"):
        chip_smoke.pp2_sdp2_hold(bad, spec)
    bad = copy.deepcopy(outs)
    bad[2]["sdp_stage1"]["slot_bytes"] = bad[2]["dp"]["slot_bytes"]
    with pytest.raises(AssertionError, match="slot bytes"):
        chip_smoke.pp2_sdp2_hold(bad, spec)
    bad = copy.deepcopy(outs)
    bad[0]["sdp_stage2"]["collectives_per_step"].pop("reduce_scatter")
    with pytest.raises(AssertionError, match="reduce-scatters"):
        chip_smoke.pp2_sdp2_hold(bad, spec)
