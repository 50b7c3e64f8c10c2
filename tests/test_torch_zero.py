"""ZeRO in the port (``paddle_tpu_torch.distributed.sharding``,
``TrainStep(zero_stage=1|2|3)``) on a two-rank gloo world over the mesh
{"sdp": 2}, in the JAX package's parity setting (tests/test_zero.py: the
64-128-64 MLP, AdamW at lr 0.01, mse): stages 1, 2 and 3 against the JAX
step on a two-device ``sdp`` mesh and against the port unsharded, to
1e-5 over three steps; each rank's slot shapes half the full ones on the
dim ``_stage_spec_for`` picks (JAX's pick); stage 2 reduce-scatters
where stage 1 all-reduces; ``state_dict`` in full shapes, and a stage-3
checkpoint resuming a stage-1 step; a global-norm clip over the slices;
the JAX step's ``ValueError``s; and ``group_sharded_parallel`` at its
three levels."""
import numpy as np
import pytest
import torch

import jax

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.distributed.sharding import _stage_spec_for as j_spec
from paddle_tpu.jit import TrainStep as JTrainStep

import _torch_dist


@pytest.fixture(scope="module")
def world():
    w = _torch_dist.World(2)
    yield w
    w.close()


def _data():
    rng = np.random.RandomState(0)
    return (rng.randn(16, 64).astype(np.float32),
            rng.randn(16, 64).astype(np.float32))


def _jax_runs(x, y, steps=3):
    """The JAX step unsharded and at stages 1-3 on a two-device sdp mesh:
    losses and the final per-name masters."""
    def build():
        paddle.seed(3)
        return jnn.Sequential(jnn.Linear(64, 128), jnn.GELU(),
                              jnn.Linear(128, 64))
    weights = {k: np.asarray(v.numpy()) for k, v in
               build().state_dict().items()}
    out = {}
    prev = jmesh.get_mesh()
    try:
        for stage in (None, 1, 2, 3):
            if stage is not None:
                jmesh.init_mesh({"sdp": 2}, devices=jax.devices()[:2])
            m = build()
            opt = paddle.optimizer.AdamW(parameters=m.parameters(),
                                         learning_rate=0.01)
            step = JTrainStep(m, paddle.nn.functional.mse_loss, opt,
                              zero_stage=stage)
            xs, ys = paddle.to_tensor(x), paddle.to_tensor(y)
            losses = [float(step(xs, ys).numpy()) for _ in range(steps)]
            params = {k: np.asarray(v) for k, v in
                      step.state_dict()["params"].items()}
            out[stage] = (losses, params)
        specs = {}
        jmesh.init_mesh({"sdp": 2}, devices=jax.devices()[:2])
        for shape in ((128, 64), (64, 128), (64,), (4096,), (3, 4096),
                      (96, 96)):
            specs[shape] = tuple(j_spec(np.zeros(shape, np.float32), "sdp"))
    finally:
        jmesh.set_mesh(prev)
    return weights, out, specs


@pytest.fixture(scope="module")
def runs(world):
    x, y = _data()
    weights, jax_out, jax_specs = _jax_runs(x, y)
    out = world.run("job_zero", weights=weights, x=x, y=y)
    return jax_out, jax_specs, out


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_stage_matches_jax_and_unsharded(runs, stage):
    """Three steps at ``zero_stage``: losses and final masters (full, from
    ``state_dict``) within 1e-5 of the unsharded port and of the JAX step
    at the same stage, the same on both ranks; the model's parameters
    after ``sync_to_model`` are the masters."""
    jax_out, _specs, out = runs
    for r in range(2):
        got = out[r][stage]
        plain = out[r]["plain"]
        for losses in (plain["losses"], jax_out[stage][0],
                       jax_out[None][0]):
            np.testing.assert_allclose(got["losses"], losses, rtol=1e-5,
                                       atol=1e-5)
        for n, want in plain["state"]["params"].items():
            assert got["state"]["params"][n].shape == want.shape
            np.testing.assert_allclose(got["state"]["params"][n], want,
                                       rtol=1e-5, atol=1e-5, err_msg=n)
            np.testing.assert_allclose(got["state"]["params"][n],
                                       jax_out[stage][1][n], rtol=1e-5,
                                       atol=1e-5, err_msg=n)
            np.testing.assert_allclose(got["model"][n], want, rtol=1e-5,
                                       atol=1e-5, err_msg=n)
        for n, slots in plain["state"]["slots"].items():
            for k, v in slots.items():
                np.testing.assert_allclose(got["state"]["slots"][n][k], v,
                                           rtol=1e-5, atol=1e-6,
                                           err_msg=n + "." + k)
    assert out[0][stage]["losses"] == out[1][stage]["losses"]


def test_slot_shapes_are_half_on_the_picked_dim(runs):
    """``_stage_spec_for`` picks JAX's dim for every shape; each rank's
    AdamW slots are half the full ones on that dim (the weights of 8192
    elements) and whole below 4096 elements (the biases); stage 3's
    masters rest as the same slices, stages 1-2 keep them whole."""
    _jax, jax_specs, out = runs
    for shape, spec in out[0]["specs"].items():
        assert spec == jax_specs[shape], shape
    for r in range(2):
        for stage in (1, 2, 3):
            shapes = out[r][stage]["slot_shapes"]
            assert shapes["0.weight"] == {"moment1": (64, 64),
                                          "moment2": (64, 64)}
            assert shapes["2.weight"] == {"moment1": (64, 64),
                                          "moment2": (64, 64)}
            assert shapes["0.bias"]["moment1"] == (128,)
            assert shapes["2.bias"]["moment1"] == (64,)
            masters = out[r][stage]["master_shapes"]
            half = (64, 64) if stage == 3 else None
            assert masters["0.weight"] == (half or (64, 128))
            assert masters["2.weight"] == (half or (128, 64))


def test_stage2_reduce_scatters_where_stage1_all_reduces(runs):
    """With the batch sharded over ``sdp``: stage 1 averages every
    gradient with one all-reduce (one bucket a dtype), stage 2
    reduce-scatters the two sliced weights' and all-reduces only the
    biases' bucket; both all-gather the two updated masters, and both
    average the loss.  Losses still within 1e-5 of the
    unsharded step's (the batch's rows weigh alike), and with the batch
    replicated stage 2 issues no all-reduce at all."""
    *_rest, out = runs
    for r in range(2):
        s1 = out[r][("sdp", 1)]["issued"]
        s2 = out[r][("sdp", 2)]["issued"]
        assert s1.get("reduce_scatter", 0) == 0 and s2["reduce_scatter"] == 2
        assert s2["all_gather"] == s1["all_gather"] == 2
        assert s1["all_reduce"] == s2["all_reduce"] == 2
        for stage in (1, 2):
            np.testing.assert_allclose(out[r][("sdp", stage)]["losses"],
                                       out[r]["plain"]["losses"], rtol=1e-5,
                                       atol=1e-5)
        assert out[r][2]["issued"] == {"reduce_scatter": 2, "all_gather": 2}


def test_global_norm_clip_over_slices(runs):
    """A ClipGradByGlobalNorm(0.5) at stage 2: the norm sums the squares
    of the slices over the group, so the losses equal the unsharded
    clipped step's to 1e-5."""
    *_rest, out = runs
    for r in range(2):
        np.testing.assert_allclose(out[r][("clip", 2)]["losses"],
                                   out[r]["plain_clip"]["losses"], rtol=1e-5,
                                   atol=1e-5)
        assert out[r][("clip", 2)]["issued"]["all_reduce"] == 1


def test_checkpoint_is_layout_free(runs):
    """A stage-3 step's state_dict (full shapes) resumes a stage-1 step:
    their next losses agree."""
    *_rest, out = runs
    for r in range(2):
        a, b = out[r]["resume"]
        np.testing.assert_allclose(a, b, rtol=1e-6)


def test_group_sharded_parallel_levels(runs):
    """"os", "os_g", "p_g_os" return the model and optimizer and keep the
    level; "p_g_os" records each parameter's ZeRO spec (the weights on
    the picked dim, the biases whole)."""
    *_rest, out = runs
    levels = out[0]["levels"]
    for level in ("os", "os_g", "p_g_os"):
        same_m, same_o, kept, specs = levels[level]
        assert same_m and same_o and kept == level
    assert levels["os"][3] == {n: () for n in levels["os"][3]}
    assert levels["p_g_os"][3] == {"0.weight": (None, "sdp"),
                                   "0.bias": (), "2.weight": ("sdp", None),
                                   "2.bias": ()}


def test_placement_helpers(runs, tmp_path):
    """``shard_optimizer_state`` cuts each slot on the dim
    ``_stage_spec_for`` picks (whole below 4096 elements) and keeps the
    step; ``ShardingParallel`` at stage 3 records the specs and passes the
    forward through; ``save_group_sharded_model`` writes the model's and
    the optimizer's state."""
    *_rest, out = runs
    for r in range(2):
        slots, step = out[r]["opt_cut"]
        assert slots == {"w": {"m": (64, 64), "v": (64, 64)},
                         "b": {"m": (64,)}} and step == 3
        assert out[r]["wrapper"] == ((None, "sdp"), True)
    from paddle_tpu_torch.distributed import sharding
    from paddle_tpu_torch.optimizer import AdamW
    m = torch.nn.Linear(4, 4)
    opt = AdamW(parameters=m.parameters())
    sharding.save_group_sharded_model(m, str(tmp_path / "ck"), opt)
    assert set(torch.load(tmp_path / "ck.pdparams")) == {"weight", "bias"}
    assert (tmp_path / "ck.pdopt").is_file()


def test_refusals_as_in_jax(world):
    """``zero_stage`` on a mesh of two ranks without an ``sdp`` axis of
    two raises ValueError; ``flat_master=True`` with ZeRO raises
    ValueError first; an unknown sharding level raises."""
    for got in world.run("job_zero_errors"):
        assert got == ["sdp", "flat_master", "flat_master"]
    from paddle_tpu_torch.distributed import sharding
    m = torch.nn.Linear(4, 4)
    with pytest.raises(ValueError, match="level"):
        sharding.group_sharded_parallel(m, None, level="p")
