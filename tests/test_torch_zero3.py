"""ZeRO stage 3's gather-on-use in the port (``distributed/sharding.py``
``GatherOnUse`` under ``TrainStep(zero_stage=3)``) and the sliced ZeRO
save (``incubate.checkpoint``), on one two-rank gloo world over {"sdp":
2}:

* the tiny GPT, per layer and scan-layers, f32 and AMP O2 bf16, with
  and without recompute: stage 3's losses, masters and (after
  ``sync_to_model``) model bit for bit stage 2's; its parameters rest
  as the rank's slices (the full storage freed), ``state_dict`` stays
  whole;
* the gathered full-parameter bytes alive at once (the hooks' counter)
  never exceed the tied ``wte`` plus one block's, and none outlive the
  step;
* the scan-layers model gathers one layer's rows of each stacked
  parameter at a time, likewise; ``stack_layers`` keeps the whole
  parameters in the model, as before, still bit for bit stage 2;
* stage 3 against the JAX package's ``TrainStep(zero_stage=3)`` on a
  two-device ``sdp`` mesh (1e-5);
* a checkpoint of a ZeRO step: each rank's file holds only its slices
  (the slots at stages 2 and 3, the masters too at stage 3: exactly the
  whole state less the other rank's slices), and the restored step has
  the saved state and next-step loss bit for bit."""
import re

import numpy as np
import pytest

import jax

import paddle_tpu as paddle
from paddle_tpu.distributed import mesh as jmesh

import _torch_dist

TOL = 1e-5


@pytest.fixture(scope="module")
def world():
    w = _torch_dist.World(2)
    yield w
    w.close()


def _weights(scan=False):
    from paddle_tpu.models.gpt import GPTConfig, GPTForCausalLM
    paddle.seed(5)
    cfg = GPTConfig.tiny()
    cfg.scan_layers = scan
    m = GPTForCausalLM(cfg)
    return {k: np.asarray(v.numpy()) for k, v in m.state_dict().items()}


def _ids():
    return np.random.default_rng(6).integers(0, 512, (4, 16)).astype(
        np.int64)


def _same(a, b):
    assert a["losses"] == b["losses"]
    for n, v in a["masters"].items():
        np.testing.assert_array_equal(b["masters"][n], v, err_msg=n)
    for n, v in a["model"].items():
        np.testing.assert_array_equal(b["model"][n], v, err_msg=n)


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("recompute", [False, True],
                         ids=["plain", "recompute"])
@pytest.mark.parametrize("scan", [False, True], ids=["per_layer", "scan"])
def test_stage_3_gathers_on_use_bit_for_bit_stage_2(world, amp, recompute,
                                                    scan):
    """Three steps, per layer and on the scan-layers model (whose stacked
    parameters are gathered a layer's rows at a time): the losses, the
    masters and the model after ``sync_to_model`` of stage 3 equal stage
    2's bit for bit; at rest stage 3's sliced parameters hold half their
    rows or columns, and the gathered bytes alive at once peaked above
    the token table and at most at it plus one block (or one layer's
    rows of the stacked ones), with none alive after the step."""
    ln = "gpt.h_stack.ln1_w" if scan else "gpt.h.0.ln1.weight"
    for out in world.run("_torch_hybrid:job_zero3", weights=_weights(scan),
                         ids=_ids(), amp=amp,
                         cfg={"use_recompute": recompute,
                              "scan_layers": scan}):
        two, three = out[2], out[3]
        _same(two, three)
        assert two["losses"][-1] < two["losses"][0]
        assert two["gather"] is None
        g = three["gather"]
        assert g["wte"] < g["peak"] <= g["wte"] + g["block"], g
        assert g["live"] == 0
        assert g["gathers"] > 0
        rest, full = three["rest"], two["rest"]
        assert rest["gpt.wte.weight"] == (256, 64)
        assert full["gpt.wte.weight"] == (512, 64)
        assert rest[ln] == full[ln]
        halved = [n for n in full if rest[n] != full[n]]
        assert len(halved) >= (6 if scan else 10)
        for n, v in three["masters"].items():
            assert v.shape == full[n], n


def test_stack_layers_keeps_its_parameters_whole(world):
    """``TrainStep(stack_layers=True)`` at stage 3: no gather-on-use
    (ROADMAP.md §C), the masters rest as slices and the losses and
    masters are stage 2's bit for bit."""
    for out in world.run("_torch_hybrid:job_zero3_stack",
                         weights=_weights(), ids=_ids()):
        _same(out[2], out[3])
        assert out[3]["gather"] is None
        assert out[3]["rest"] == out[2]["rest"]


def _jax_stage_3(steps=3):
    """The JAX step at stage 3 on a two-device {"sdp": 2} mesh (the batch
    replicated, as tests/test_zero.py runs it): losses and masters."""
    from paddle_tpu.jit import TrainStep
    from paddle_tpu.models.gpt import (GPTConfig, GPTForCausalLM,
                                       GPTPretrainingCriterion)
    prev = jmesh.get_mesh()
    try:
        jmesh.init_mesh({"sdp": 2, "mp": 1}, devices=jax.devices()[:2])
        with paddle.set_grad_enabled(True):
            m = GPTForCausalLM(GPTConfig.tiny())
            m.set_state_dict(_weights())
            crit = GPTPretrainingCriterion()
            step = TrainStep(m, lambda lg, lb: crit(lg, lb),
                             paddle.optimizer.AdamW(
                                 learning_rate=1e-3, epsilon=1e-6,
                                 parameters=m.parameters()), zero_stage=3)
            x = paddle.to_tensor(_ids().astype(np.int32))
            losses = [float(step(x, x).numpy()) for _ in range(steps)]
            masters = {k: np.asarray(v) for k, v in
                       step.state_dict()["params"].items()}
    finally:
        jmesh.set_mesh(prev)
    return losses, masters


def test_stage_3_tracks_jax_stage_3(world):
    """Three f32 steps: losses and masters within 1e-5 of the JAX
    package's stage-3 step."""
    jlosses, jmasters = _jax_stage_3()
    for out in world.run("_torch_hybrid:job_zero3", weights=_weights(),
                         ids=_ids()):
        three = out[3]
        np.testing.assert_allclose(three["losses"], jlosses, rtol=TOL)
        for n, v in jmasters.items():
            np.testing.assert_allclose(three["masters"][n], v, rtol=TOL,
                                       atol=TOL, err_msg=n)


@pytest.mark.parametrize("stage,stack", [(2, False), (3, False),
                                         (3, True)])
def test_checkpoint_holds_each_rank_slices(world, tmp_path, stage, stack):
    """``CheckpointManager.save`` of a ZeRO step: each rank's file holds
    the whole state less the other rank's slices, byte for byte (the
    slots, and at stage 3 the masters, as sliced leaves whose one shard
    is the rank's half on the cut dimension); ``register_train_step``
    registers the same sliced state; the step restored from the files
    holds the saved state and takes the next step with its loss, bit for
    bit.  Under ``stack_layers`` the stacked slices go under the
    per-layer names, each layer's slice a leaf."""
    outs = world.run("_torch_hybrid:job_zero_sliced_save",
                     weights=_weights(), ids=_ids(), stage=stage,
                     directory=str(tmp_path / "ck"), stack=stack)
    for o in outs:
        assert o["file_bytes"] == o["expected_bytes"], o["file_bytes"]
        share = o["file_bytes"] / o["whole_bytes"]
        assert share < (0.7 if stage == 2 else 0.56), share
        assert o["same_state"] and o["registered_sliced"]
        assert o["losses"][0] == o["losses"][1]
        assert o["shards"]
        for path, idxs in o["shards"].items():
            # ("train_step", "opt_state", "slots", name, slot) or
            # ("train_step", "params", name)
            assert len(idxs) == 1, path
            name = path[3] if path[1] == "opt_state" else path[2]
            if stack and ".h." in name:
                # a layer's slice: the template's cut, one dimension in
                name = re.sub(r"\.h\.\d+\.", ".h.#.", name)
                d = o["dims"][name] - 1
            else:
                d = o["dims"][name]
            a, b = idxs[0][d]
            size = b - a
            assert (a, b) == (o["rank"] * size, (o["rank"] + 1) * size)
        kinds = {path[1] for path in o["shards"]}
        assert kinds == ({"opt_state"} if stage == 2
                         else {"opt_state", "params"})


def test_a_new_step_on_a_resting_model(world):
    """A second step built on a model that rests as a stage-3 step's
    slices raises (its ``sync_to_model`` first); after it a deep copy of
    the model runs as it, gathering nothing, and the new step takes the
    model without the old hooks: its first loss is the old step's next,
    bit for bit."""
    for o in world.run("_torch_hybrid:job_zero3_rebuild", weights=_weights(),
                       ids=_ids()):
        assert o["refused"] is not None and "sync_to_model" in o["refused"]
        assert not o["hooks_left"] and o["copied"]
        assert o["losses"][0] == o["losses"][1]
