"""Data parallelism in the port on a two-rank gloo world: ``DataParallel``
(rank 0's parameters broadcast at wrap time; gradients averaged by name,
with a parameter that one rank does not use and one that no rank uses),
and the JAX package's ``test_dp_training_matches_single_device`` at dp=2
through ``TrainStep(in_shardings=PartitionSpec("dp", None))``: against
the port at dp=1 and the JAX package's step on a ("dp",) mesh of two CPU
devices, to 1e-5."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as JP

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.distributed import mesh as jmesh

import _torch_dist
from paddle_tpu_torch.distributed.mesh import PartitionSpec


@pytest.fixture(scope="module")
def world():
    w = _torch_dist.World(2)
    yield w
    w.close()


def _dp_unused_inputs():
    rng = np.random.default_rng(3)
    names = ["a.weight", "a.bias", "b.weight", "b.bias", "c.weight",
             "c.bias"]
    weights = [{n: rng.standard_normal((4, 4) if n.endswith("weight")
                                       else (4,)).astype(np.float32)
                for n in names} for _ in range(2)]
    x = rng.standard_normal((2, 3, 4)).astype(np.float32)
    return weights, x


def test_data_parallel_averages_by_name_with_unused_parameters(world):
    weights, x = _dp_unused_inputs()
    out = world.run("job_dp_unused", weights=weights, x=x)
    # the reference: each rank's gradients from rank 0's weights, b only on
    # rank 0, averaged over the two ranks; c has a gradient on no rank
    grads = []
    for r in range(2):
        m = {n: torch.from_numpy(v.copy()).requires_grad_(True)
             for n, v in weights[0].items()}
        h = torch.from_numpy(x[r]) @ m["a.weight"] + m["a.bias"]
        if r == 0:
            h = h @ m["b.weight"] + m["b.bias"]
        h.sum().backward()
        grads.append({n: (None if t.grad is None else t.grad.numpy())
                      for n, t in m.items()})
    for r in range(2):
        params, got = out[r]
        for n, v in weights[0].items():
            np.testing.assert_array_equal(params[n], v)
        for n in ("a.weight", "a.bias", "b.weight", "b.bias"):
            parts = [g[n] if g[n] is not None else 0.0 for g in grads]
            np.testing.assert_allclose(got[n], (parts[0] + parts[1]) / 2,
                                       rtol=1e-6, atol=1e-6)
        assert got["c.weight"] is None and got["c.bias"] is None


def _jax_dp_losses(X, Y, dp):
    """The JAX test's model and step; with ``dp`` the batch is placed
    ('dp', None) on a ("dp",) mesh of ``dp`` CPU devices."""
    from paddle_tpu.jit import TrainStep
    paddle.seed(42)
    m = jnn.Sequential(jnn.Linear(16, 32), jnn.ReLU(), jnn.Linear(32, 4))
    weights = {"0.weight": np.asarray(m[0].weight.numpy()),
               "0.bias": np.asarray(m[0].bias.numpy()),
               "2.weight": np.asarray(m[2].weight.numpy()),
               "2.bias": np.asarray(m[2].bias.numpy())}
    opt = paddle.optimizer.SGD(parameters=m.parameters(), learning_rate=0.1)
    prev = jmesh.get_mesh()
    try:
        mesh = jmesh.init_mesh({"dp": dp})
        step = TrainStep(m, jnn.MSELoss(), opt, donate=False)
        sh = NamedSharding(mesh, JP("dp", None))
        xs = jax.device_put(jnp.asarray(X), sh)
        ys = jax.device_put(jnp.asarray(Y), sh)
        losses = [float(step(xs, ys).numpy()) for _ in range(3)]
    finally:
        jmesh.set_mesh(prev)
    return weights, losses


@pytest.mark.parametrize("flat_master", [False, True])
def test_dp_training_matches_single_device(world, flat_master):
    """dp=2 through ``in_shardings`` against dp=1 and JAX (3 SGD steps;
    losses and final parameters to 1e-5); with ``flat_master`` the
    gradient all-reduce runs over the one flat buffer."""
    rng = np.random.RandomState(0)
    X = rng.rand(16, 16).astype(np.float32)
    Y = rng.rand(16, 4).astype(np.float32)
    weights, jax_losses = _jax_dp_losses(X, Y, 2)
    dp2 = world.run("job_dp_train", weights=weights, X=X, Y=Y,
                    flat_master=flat_master)
    dp1_losses, dp1_params = _torch_dist.dp_train(
        weights, X, Y, flat_master=flat_master, dp=False)
    for losses, params in dp2:
        np.testing.assert_allclose(losses, dp1_losses, rtol=1e-5)
        np.testing.assert_allclose(losses, jax_losses, rtol=1e-5)
        for n in params:
            np.testing.assert_allclose(params[n], dp1_params[n], rtol=1e-5,
                                       atol=1e-6)
    # both ranks hold the same parameters and report the same loss
    for n in dp2[0][1]:
        np.testing.assert_array_equal(dp2[0][1][n], dp2[1][1][n])
    assert dp2[0][0] == dp2[1][0]


def test_in_shardings_specs_are_parsed_as_the_jax_step_takes_them():
    """One PartitionSpec for every batch element, or one each; the first
    dimension over one axis is ported, and the second over 'sep' (the
    GPT's sequence sharding, which the model does itself); any other axis
    past the first dimension raises."""
    from paddle_tpu_torch.jit import _batch_axis
    assert _batch_axis(None) == (None, None)
    assert _batch_axis(PartitionSpec("dp", None)) == ("dp", [("dp", None)])
    assert _batch_axis([PartitionSpec("dp"), None]) == ("dp", [("dp",), ()])
    assert _batch_axis(PartitionSpec("dp", "sep")) == ("dp",
                                                       [("dp", "sep")])
    with pytest.raises(NotImplementedError, match="§A5"):
        _batch_axis(PartitionSpec("dp", "mp"))
    with pytest.raises(ValueError, match="several"):
        _batch_axis([PartitionSpec("dp"), PartitionSpec("sdp")])
