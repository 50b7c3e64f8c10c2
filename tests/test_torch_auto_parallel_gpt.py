"""The port's auto-parallel Engine on the tiny GPT
(``GPTPretrainingCriterion``, AdamW) against the JAX package's, on one
four-rank gloo world: on {"dp": 2, "mp": 2} and at ZeRO stage 3 on
{"dp": 2, "sdp": 2} (``fit`` ends with ``sync_to_model``, a collective
there, and ``evaluate`` / ``predict`` read the trained parameters), the
losses and logits to 1e-5 of JAX's Engine, the epoch's loss bit for bit
the port's ``TrainStep``'s over the same batches."""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.distributed import mesh as jmesh
from test_torch_auto_parallel import REL, _close

import _torch_dist

_JAX = {}


@pytest.fixture(scope="module")
def world():
    w = _torch_dist.World(4)
    yield w
    w.close()


def _gpt_weights():
    from paddle_tpu.models.gpt import GPTConfig, GPTForCausalLM
    paddle.seed(7)
    m = GPTForCausalLM(GPTConfig.tiny())
    return {k: np.asarray(v.numpy()) for k, v in m.state_dict().items()}


def _gpt_ids():
    return np.random.default_rng(4).integers(0, 512, (8, 16)).astype(
        np.int64)


def _jax_gpt(axes):
    """JAX's Engine on the tiny GPT over ``axes`` (one epoch of batches
    of 4): the history, evaluate and the first batch's logits."""
    key = ("gpt", tuple(sorted(axes.items())))
    if key in _JAX:
        return _JAX[key]
    from paddle_tpu.distributed.auto_parallel import Engine
    from paddle_tpu.io import DataLoader, TensorDataset
    from paddle_tpu.models.gpt import (GPTConfig, GPTForCausalLM,
                                       GPTPretrainingCriterion)
    ids = _gpt_ids().astype(np.int32)
    prev = jmesh.get_mesh()
    try:
        with paddle.set_grad_enabled(True):
            m = GPTForCausalLM(GPTConfig.tiny())
            m.set_state_dict(_gpt_weights())
            opt = paddle.optimizer.AdamW(learning_rate=1e-3, epsilon=1e-6,
                                         parameters=m.parameters())
            engine = Engine(m, GPTPretrainingCriterion(), opt)
            engine.prepare(mesh_axes=axes)
            x = paddle.to_tensor(ids)
            loader = DataLoader(TensorDataset([x, x]), batch_size=4,
                                shuffle=False, drop_last=True)
            hist = engine.fit(loader, epochs=1, verbose=0)
            result = engine.evaluate(loader)
            logits = np.asarray(engine.predict(loader, steps=1)[0].numpy())
    finally:
        jmesh.set_mesh(prev)
    _JAX[key] = (hist, result, logits)
    return _JAX[key]


@pytest.mark.parametrize("axes,zero_stage,jax_axes", [
    ({"dp": 2, "mp": 2}, None, {"dp": 2, "mp": 2}),
    ({"dp": 2, "sdp": 2}, 3, {"dp": 2, "mp": 1}),
])
def test_engine_gpt_matches_jax_and_the_step(world, axes, zero_stage,
                                             jax_axes):
    """The tiny GPT: the epoch's loss, evaluate's loss and the first
    batch's logits (vocab shards joined) within 1e-5 of JAX's Engine,
    the loss bit for bit the port's ``TrainStep`` over the same batches.
    At ZeRO stage 3 (against JAX's {"dp": 2, "mp": 1} run: the same
    math; its parallelize names 'mp')
    ``evaluate`` and ``predict`` run on the parameters ``fit`` left."""
    hist, result, logits = _jax_gpt(jax_axes)
    outs = world.run("_torch_hybrid:job_engine_gpt", weights=_gpt_weights(),
                     ids=_gpt_ids(), axes=axes, zero_stage=zero_stage)
    for o in outs:
        np.testing.assert_allclose(o["history"][0]["loss"],
                                   hist[0]["loss"], rtol=REL)
        np.testing.assert_allclose(o["evaluate"]["loss"], result["loss"],
                                   rtol=REL)
        assert o["evaluate"]["loss"] < o["history"][0]["loss"]
        _close(o["logits"], logits)
        assert o["history"][0]["loss"] == o["step_mean"]
        assert o["cost"] == axes
