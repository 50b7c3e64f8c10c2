"""The port's fleet facade (``distributed.fleet``) against the JAX
package's on a four-rank gloo world: the strategy's dict coercion;
``fleet.init``'s mesh (dp filled from the world) and hybrid topology on
every rank; ``distributed_model``'s wrapper for each degree;
``HybridParallelOptimizer`` passing calls through and clipping over mp
shards as JAX's unsharded clip does; ``fleet.elastic`` refused naming
ROADMAP.md; the ``parallel`` alias package's names."""
import dataclasses

import numpy as np
import pytest
import torch

import jax

import paddle_tpu as paddle
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.distributed.fleet.hybrid_optimizer import \
    HybridParallelOptimizer as JHybridOpt
from paddle_tpu.distributed.mesh import (CommunicateTopology as JTopo,
                                         HybridCommunicateGroup as JHcg)

import _torch_dist
import _torch_pipe as TP
from paddle_tpu_torch.distributed import fleet as tfleet
from paddle_tpu_torch.distributed.pipeline import PipelineLayer

HYBRIDS = [{}, {"pp_degree": 2}, {"mp_degree": 2},
           {"pp_degree": 2, "mp_degree": 2}, {"sharding_degree": 2},
           {"dp_degree": 2, "mp_degree": 2}]


@pytest.fixture(scope="module")
def world():
    w = _torch_dist.World(4)
    yield w
    w.close()


@pytest.fixture(scope="module")
def gpt():
    """The port's tiny GPT's weights (the JAX names), a batch, and one SGD
    step (lr 1) of it, unsharded, under a global-norm clip of 0.1."""
    from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForCausalLM,
                                             GPTPretrainingCriterion)
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import SGD
    m = GPTForCausalLM(GPTConfig.tiny(),
                       generator=torch.Generator().manual_seed(0))
    weights = {k: v.detach().numpy().copy()
               for k, v in m.state_dict().items()}
    ids = np.random.default_rng(4).integers(0, 512, (2, 16))
    opt = SGD(learning_rate=1.0, parameters=m.parameters(),
              grad_clip=ClipGradByGlobalNorm(0.1))
    x = torch.from_numpy(ids)
    GPTPretrainingCriterion()(m(x), x).backward()
    opt.step()
    stepped = {k: v.detach().numpy().copy()
               for k, v in m.state_dict().items()}
    return weights, ids, stepped


@pytest.mark.parametrize("attr,value", [
    ("hybrid_configs", {"dp_degree": 2, "pp_degree": 4, "bogus": 1}),
    ("sharding_configs", {"stage": 3, "offload": True, "bogus": 1}),
    ("pipeline_configs", {"accumulate_steps": 8, "micro_batch_size": 2}),
    ("amp_configs", {"enable": True, "level": "O2", "bogus": 0})])
def test_strategy_coercion_matches_jax(attr, value):
    """A dict assigned to a config attribute becomes its dataclass, with
    the keys it does not know dropped, as in the JAX package; the
    defaults are the JAX package's."""
    js, ts = jfleet.DistributedStrategy(), tfleet.DistributedStrategy()
    assert {k: (dataclasses.asdict(v) if dataclasses.is_dataclass(v)
                else v) for k, v in vars(ts).items()} == \
        {k: (dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v)
         for k, v in vars(js).items()}
    setattr(js, attr, dict(value))
    setattr(ts, attr, dict(value))
    assert type(getattr(ts, attr)).__name__ == \
        type(getattr(js, attr)).__name__
    assert dataclasses.asdict(getattr(ts, attr)) == \
        dataclasses.asdict(getattr(js, attr))


def _jax_init(hybrid, monkeypatch):
    """The JAX fleet.init over the first four CPU devices: its mesh and
    its topology."""
    devices = jax.devices()[:4]
    monkeypatch.setattr(jax, "devices", lambda *a: devices)
    strategy = jfleet.DistributedStrategy()
    strategy.hybrid_configs = dict(hybrid)
    try:
        jfleet.init(is_collective=True, strategy=strategy)
        mesh = jmesh.get_mesh()
        shape = dict(zip(mesh.axis_names, mesh.devices.shape))
        return shape, jfleet.fleet._topology
    finally:
        jmesh.init_mesh({"dp": 1})


@pytest.fixture(scope="module")
def inits(world):
    return {i: world.run("_torch_pipe:job_fleet_init", hybrid=h)
            for i, h in enumerate(HYBRIDS)}


@pytest.mark.parametrize("case", range(len(HYBRIDS)))
def test_fleet_init_mesh_and_topology_match_jax(inits, case, monkeypatch):
    """fleet.init lays the degrees over the world (the rest of it onto
    dp when dp is not named), as the JAX package over as many devices:
    the mesh, the hybrid group's degrees and mode, and each rank's
    coordinates (the JAX topology's for that rank); the worker calls."""
    shape, topo = _jax_init(HYBRIDS[case], monkeypatch)
    for rank, out in enumerate(inits[case]):
        assert out["mesh"] == shape
        hcg = JHcg(JTopo(topo.get_hybrid_group_names(), topo._dims), rank)
        assert [out[k] for k in ("dp", "mp", "pp", "sdp")] == [
            hcg.get_data_parallel_world_size(),
            hcg.get_model_parallel_world_size(),
            hcg.get_pipe_parallel_world_size(),
            hcg.get_sharding_parallel_world_size()]
        assert out["mode"] == hcg.get_parallel_mode()
        assert out["coord"] == [hcg.get_data_parallel_rank(),
                                hcg.get_stage_id(),
                                hcg.get_sharding_parallel_rank(),
                                hcg.get_model_parallel_rank()]
        assert out["worker_num"] == 4 and out["worker_index"] == rank
        assert out["first"] == (rank == 0)


def test_distributed_model_dispatch_matches_jax(world, gpt, monkeypatch):
    """distributed_model wraps for the degree the JAX package's does
    (pp > mp > sharding > dp): TensorParallel slices the Megatron
    parameters, ShardingParallel at stage 3 records the ZeRO placements,
    DataParallel runs the model."""
    torch.manual_seed(0)
    pipe = {k: v.detach().numpy() for k, v in PipelineLayer(
        TP.descs(), num_stages=2, loss_fn=TP._nn()[2]()).state_dict().items()
        if "shared.word" not in k}
    got = world.run("_torch_pipe:job_fleet_dispatch",
                    weights={"pipe": pipe, "gpt": gpt[0]})
    devices = jax.devices()[:4]
    monkeypatch.setattr(jax, "devices", lambda *a: devices)
    for name, hybrid in (("pp", {"pp_degree": 2}), ("mp", {"mp_degree": 2}),
                         ("sharding", {"sharding_degree": 2}), ("dp", {})):
        strategy = jfleet.DistributedStrategy()
        strategy.hybrid_configs = hybrid
        try:
            jfleet.init(is_collective=True, strategy=strategy)
            want = type(jfleet.distributed_model(
                paddle.nn.Linear(4, 4))).__name__
        finally:
            jmesh.init_mesh({"dp": 1})
        for out in got:
            assert out[name]["type"] == want, name
    for out in got:
        # 3 x 64 fused q/k/v columns, half a rank
        assert out["mp"]["qkv_shape"] == [64, 96]
        assert out["sharding"]["zero_specs"] > 0
        assert out["dp"]["forward"] == [2, 4, 512]


def test_hybrid_optimizer_clips_over_mp(world, gpt):
    """fleet at mp2 (dp filled to 2): the wrapped optimizer's step under
    a global-norm clip gives, gathered over the mp shards, the unsharded
    step's parameters (the JAX package's global norm over whole arrays);
    get_lr, clear_grad and state_dict pass through."""
    weights, ids, stepped = gpt
    for out in world.run("_torch_pipe:job_hybrid_clip", weights=weights,
                         ids=ids, clip=0.1):
        assert out["lr"] == 1.0 and out["grads_cleared"]
        assert out["state_dict_keys"] == ["_step_count"]
        for k, v in stepped.items():
            np.testing.assert_allclose(out["state"][k], v, rtol=1e-5,
                                       atol=1e-7, err_msg=k)


def test_hybrid_optimizer_matches_jax_unsharded():
    """On one rank the wrapper's clipped SGD step equals the JAX
    package's HybridParallelOptimizer's on the same Linear, and its
    pass-through calls answer as the JAX wrapper's do."""
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import SGD
    rng = np.random.default_rng(9)
    w = rng.standard_normal((8, 4)).astype(np.float32)
    x = rng.standard_normal((5, 8)).astype(np.float32)
    with paddle.set_grad_enabled(True):
        jl = paddle.nn.Linear(8, 4)
        jl.weight.set_value(paddle.to_tensor(w))
        jopt = JHybridOpt(paddle.optimizer.SGD(
            learning_rate=0.5, parameters=jl.parameters(),
            grad_clip=paddle.nn.ClipGradByGlobalNorm(0.05)))
        (jl(paddle.to_tensor(x)) ** 2).sum().backward()
        jopt.step()
        jopt.clear_grad()
    tl = tnn.Linear(8, 4)
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(w))
        tl.bias.zero_()
    topt = tfleet.distributed_optimizer(SGD(
        learning_rate=0.5, parameters=tl.parameters(),
        grad_clip=ClipGradByGlobalNorm(0.05)))
    (tl(torch.from_numpy(x)) ** 2).sum().backward()
    topt.step()
    topt.clear_grad()
    np.testing.assert_allclose(tl.weight.detach().numpy(),
                               np.asarray(jl.weight.numpy()), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(tl.bias.detach().numpy(),
                               np.asarray(jl.bias.numpy()), rtol=1e-6,
                               atol=1e-7)
    assert topt.get_lr() == jopt.get_lr()
    assert tl.weight.grad is None


def test_fleet_elastic_and_launch_resolve_to_the_ported_modules():
    """``fleet.elastic`` is the port's elastic manager module and
    ``distributed.launch`` its launcher, as in the JAX package."""
    import paddle_tpu.distributed as jdist

    import paddle_tpu_torch.distributed as tdist
    from paddle_tpu_torch.distributed import launch_main
    from paddle_tpu_torch.distributed.fleet import elastic
    assert tfleet.elastic is elastic
    assert elastic.__name__ == "paddle_tpu_torch.distributed.fleet.elastic"
    assert {"ElasticManager", "ElasticStatus"} <= set(dir(tfleet.elastic))
    assert tdist.launch is launch_main
    assert set(jdist.launch.__all__) <= set(dir(tdist.launch))


def test_module_level_aliases():
    """The module-level calls are the facade's, as in the JAX package."""
    for name in ("init", "distributed_model", "distributed_optimizer",
                 "get_hybrid_communicate_group"):
        assert getattr(tfleet, name) == getattr(tfleet.fleet, name)
        assert hasattr(jfleet, name)
    assert tfleet.worker_num() == 1 and tfleet.worker_index() == 0


def test_parallel_alias_package_names_match_jax():
    """``paddle_tpu_torch.parallel`` re-exports what
    ``paddle_tpu.parallel`` does, but the launcher."""
    import paddle_tpu.parallel as jpar

    import paddle_tpu_torch.parallel as tpar
    want = {n for n in dir(jpar) if not n.startswith("_")} - {"launch"}
    missing = sorted(n for n in want if not hasattr(tpar, n))
    assert missing == []
