"""The port's auto-parallel Engine (``paddle_tpu_torch.distributed.
auto_parallel``: ``Engine``, ``ProcessMesh``, ``shard_op``) against the
JAX package's on one four-rank gloo world:

* an 8-16-4 classifier (cross-entropy, Adam at 1e-2, ``Accuracy``) on
  {"dp": 2} (ranks 2 and 3 idle), {"dp": 4}, {"dp": 2, "mp": 2}, a
  ``ProcessMesh(shape=[2, 2])`` and a ``ProcessMesh`` with its own axis
  order and rank layout: ``fit``'s per-epoch losses, ``evaluate``'s loss
  and accuracy, ``predict``'s outputs and ``cost``'s mesh against JAX's
  ``Engine`` on the 8 host devices (1e-5 relative, an output's to its
  largest magnitude; the accuracy equal);
  and bit for bit against the port's own ``TrainStep`` over the same
  global batches (losses and trained parameters);
* (the tiny GPT's runs are tests/test_torch_auto_parallel_gpt.py's)
* ``ProcessMesh``'s layouts (each rank's coordinate and groups) and
  refusals; ``shard_op``'s values and gradient unchanged, and the specs
  it refuses."""
import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.distributed import mesh as jmesh

import _torch_dist

REL = 1e-5


@pytest.fixture(scope="module")
def world():
    w = _torch_dist.World(4)
    yield w
    w.close()


def _close(got, want):
    """Outputs within 1e-5 relative to the output's largest magnitude
    (after Adam's steps an element near zero carries the rounding of its
    neighbours)."""
    np.testing.assert_allclose(got, want, rtol=REL,
                               atol=REL * float(np.abs(want).max()))


def _classifier_data():
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((64, 8)).astype(np.float32)
    w = rng.standard_normal((8, 4)).astype(np.float32)
    ys = np.argmax(xs @ w + 0.5 * rng.standard_normal((64, 4)), 1)
    return xs, ys.astype(np.int64)


MESHES = {
    "dp2": {"axes": {"dp": 2}},
    "dp4": {"axes": {"dp": 4}},
    "dp2_mp2": {"axes": {"dp": 2, "mp": 2}},
    "process_mesh": {"shape": [2, 2], "names": ["dp", "mp"]},
    "process_mesh_layout": {"ranks": [[0, 2], [1, 3]],
                            "names": ["mp", "dp"]},
}

_JAX = {}


def _jax_mesh_kw(mesh):
    from paddle_tpu.distributed.auto_parallel import ProcessMesh
    if "axes" in mesh:
        return {"mesh_axes": mesh["axes"]}
    if "shape" in mesh:
        return {"process_mesh": ProcessMesh(shape=mesh["shape"],
                                            dim_names=mesh["names"])}
    return {"process_mesh": ProcessMesh(mesh=np.array(mesh["ranks"]),
                                        dim_names=mesh["names"])}


def _jax_classifier(name):
    """JAX's Engine on the classifier: weights, history, evaluate,
    predict, cost (cached)."""
    if name in _JAX:
        return _JAX[name]
    from paddle_tpu.distributed.auto_parallel import Engine
    from paddle_tpu.io import DataLoader, TensorDataset
    xs, ys = _classifier_data()
    prev = jmesh.get_mesh()
    try:
        with paddle.set_grad_enabled(True):
            paddle.seed(0)
            model = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(),
                                   jnn.Linear(16, 4))
            weights = {k: np.asarray(v.numpy())
                       for k, v in model.state_dict().items()}
            opt = paddle.optimizer.Adam(learning_rate=1e-2,
                                        parameters=model.parameters())
            engine = Engine(model=model, loss=jnn.functional.cross_entropy,
                            optimizer=opt, metrics=paddle.metric.Accuracy())
            engine.prepare(**_jax_mesh_kw(MESHES[name]))
            loader = DataLoader(TensorDataset([paddle.to_tensor(xs),
                                               paddle.to_tensor(ys)]),
                                batch_size=16, shuffle=False, drop_last=True)
            hist = engine.fit(loader, epochs=3, batch_size=16, verbose=0)
            result = engine.evaluate(loader, batch_size=16)
            preds = [np.asarray(o.numpy())
                     for o in engine.predict(loader, batch_size=16)]
            cost = engine.cost()["mesh"]
    finally:
        jmesh.set_mesh(prev)
    _JAX[name] = (weights, hist, result, preds, cost)
    return _JAX[name]


def _port_mesh(mesh):
    if "shape" in mesh:
        n = int(np.prod(mesh["shape"]))
        return {"ranks": np.arange(n).reshape(mesh["shape"]).tolist(),
                "names": mesh["names"]}
    return mesh


@pytest.mark.parametrize("name", sorted(MESHES))
def test_engine_classifier_matches_jax_and_the_step(world, name):
    """fit / evaluate / predict / cost on the mesh: within 1e-5 of JAX's
    Engine, the accuracy equal, every rank of the mesh alike; the
    epochs' losses and the trained parameters bit for bit the port's
    ``TrainStep`` fed the same global batches."""
    weights, hist, result, preds, cost = _jax_classifier(name)
    xs, ys = _classifier_data()
    outs = world.run("_torch_hybrid:job_engine_classifier", weights=weights,
                     xs=xs, ys=ys, mesh=_port_mesh(MESHES[name]))
    ranks = [o for o in outs if o is not None]
    assert len(ranks) == (2 if name == "dp2" else 4)
    for o in ranks:
        got = [h["loss"] for h in o["history"]]
        np.testing.assert_allclose(got, [h["loss"] for h in hist], rtol=REL)
        assert got[-1] < got[0]
        assert set(o["evaluate"]) == set(result) == {"loss", "acc"}
        np.testing.assert_allclose(o["evaluate"]["loss"], result["loss"],
                                   rtol=REL)
        assert o["evaluate"]["acc"] == result["acc"]
        assert len(o["predict"]) == len(preds) == 4
        for a, b in zip(o["predict"], preds):
            assert a.shape == (16, 4)
            _close(a, b)
        assert o["cost"] == cost
        # bit for bit the port's own step
        assert got == o["step_means"]
        for n, v in o["params"].items():
            np.testing.assert_array_equal(v, o["step_params"][n])
        assert o["history"] == ranks[0]["history"]


def test_process_mesh_layouts_and_refusals(world):
    """A ProcessMesh keeps the user's axis order and rank layout: on
    [[0, 2], [1, 3]] over ("mp", "dp") rank 1 stands at mp 1, dp 0, its
    dp group is [1, 3] and its mp group [0, 1].  A rank past the world
    raises ValueError, as JAX's unknown device id; a layout whose groups
    list ranks out of order, and ``process_ids``, NotImplementedError;
    neither mesh nor shape ValueError."""
    outs = world.run("_torch_hybrid:job_process_mesh",
                     ranks=[[0, 2], [1, 3]], names=["mp", "dp"])
    assert outs[1]["axis_names"] == ["mp", "dp"]
    assert outs[1]["coord"] == {"mp": 1, "dp": 0}
    assert outs[1]["groups"] == {"mp": [0, 1], "dp": [1, 3]}
    assert outs[2]["coord"] == {"mp": 0, "dp": 1}
    assert outs[0]["shape"] == [2, 2]
    for o in world.run("_torch_hybrid:job_process_mesh",
                       ranks=[[0, 1], [2, 9]], names=["dp", "mp"]):
        assert o.startswith("ValueError") and "[9]" in o
    for o in world.run("_torch_hybrid:job_process_mesh",
                       ranks=[[1, 0], [2, 3]], names=["dp", "mp"]):
        assert o.startswith("NotImplementedError") and "ROADMAP" in o
    for o in world.run("_torch_hybrid:job_process_mesh_errors"):
        assert o["process_ids"].startswith("NotImplementedError")
        assert o["nothing"].startswith("ValueError")


def test_shard_op_checks_and_changes_nothing(world):
    """``shard_op`` on {"dp": 4}: the matmul's values (JAX's: 4.0) and
    its input's gradient are the plain matmul's; an axis the mesh lacks,
    a dimension the axis does not divide and a spec past the rank raise
    ValueError."""
    a = np.ones((8, 4), np.float32)
    b = np.ones((4, 4), np.float32)
    for o in world.run("_torch_hybrid:job_shard_op", a=a, b=b):
        np.testing.assert_allclose(o["out"], 4.0)
        assert o["same"] and o["grad_same"]
        assert "lacks" in o["errors"]["unknown_axis"]
        assert "does not divide" in o["errors"]["indivisible"]
        assert "3-dimensional" not in o["errors"]["too_long"]
        assert "2-dimensional" in o["errors"]["too_long"]


def test_fit_needs_a_loss_and_an_optimizer():
    """As JAX's: ``fit`` without an optimizer raises ValueError before
    any mesh or device is touched."""
    import torch

    from paddle_tpu_torch.distributed.auto_parallel import Engine
    engine = Engine(model=torch.nn.Linear(2, 2), loss=lambda o, t: o.sum())
    with pytest.raises(ValueError, match="optimizer"):
        engine.fit([])
    with pytest.raises(RuntimeError, match="prepare"):
        engine.cost()
