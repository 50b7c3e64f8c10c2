"""The port's collectives (paddle_tpu_torch.distributed) on a four-rank gloo
world laid out as a 2 x 2 mesh ({"dp": 2, "mp": 2}), against the JAX
package's collectives under shard_map on a 2 x 2 mesh of the CPU devices
(rank r stands where device r stands): every op over each sub-axis, all
five ReduceOps, the in-place semantics and the identity over a world of
one; the fleet topology and ``__all__`` against the JAX package's."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as JP
from _jax_compat import shard_map

import paddle_tpu as paddle
from paddle_tpu import distributed as jdist
from paddle_tpu.distributed import mesh as jmesh

import _torch_dist
from paddle_tpu_torch import distributed as tdist
from paddle_tpu_torch.distributed import collective as tcoll
from paddle_tpu_torch.distributed import mesh as tmesh

AXES = ("dp", "mp")
OPS = ("SUM", "MAX", "MIN", "PROD", "AVG")


def _inputs():
    rng = np.random.default_rng(0)
    x = rng.uniform(0.5, 2.0, (4, 6)).astype(np.float32)
    lists = rng.uniform(0.5, 2.0, (4, 2, 6)).astype(np.float32)
    return x, lists


@pytest.fixture(scope="module")
def port():
    """Every rank's results of the collectives job (one world)."""
    world = _torch_dist.World(4)
    try:
        x, lists = _inputs()
        yield world.run("job_collectives", x=x, lists=lists,
                        objs=[{"rank": r} for r in range(4)])
    finally:
        world.close()


@pytest.fixture(scope="module")
def ref():
    """The JAX package's collectives under shard_map: {case: (4, ...)},
    row r device r's result."""
    x, lists = _inputs()
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), AXES)

    def body(xs, ls, l0):
        t = lambda a: paddle.Tensor(a)  # noqa: E731
        xv, lv = xs[0], ls[0]
        out = {}
        for op in OPS:
            for axis in AXES:
                y = t(xv)
                jdist.all_reduce(y, op=getattr(jdist.ReduceOp, op),
                                 group=axis)
                out["all_reduce_%s_%s" % (op, axis)] = y._array
        for axis in AXES:
            out["all_gather_" + axis] = jdist.all_gather(
                t(xv), group=axis)._array
            lst = []
            jdist.all_gather(lst, t(xv), group=axis)
            out["all_gather_list_" + axis] = jnp.stack(
                [a._array for a in lst])
            y = t(xv)
            jdist.broadcast(y, src=1, group=axis)
            out["broadcast_" + axis] = y._array
            for op in ("SUM", "MAX", "MIN"):
                y = t(xv)
                jdist.reduce(y, dst=0, op=getattr(jdist.ReduceOp, op),
                             group=axis)
                out["reduce_%s_%s" % (op, axis)] = y._array
            out["reduce_scatter_" + axis] = jdist.reduce_scatter(
                t(xv), group=axis)._array
            y = t(jnp.zeros_like(lv[0]))
            jdist.reduce_scatter(y, [t(lv[0]), t(lv[1])], group=axis)
            out["reduce_scatter_list_" + axis] = y._array
            y = t(jnp.zeros_like(lv[0]))
            jdist.scatter(y, [t(l0[0, 0]), t(l0[0, 1])], src=0,
                          group=axis)
            out["scatter_" + axis] = y._array
            got = []
            jdist.alltoall([t(lv[0]), t(lv[1])], got, group=axis)
            out["alltoall_" + axis] = jnp.stack([a._array for a in got])
            out["all_to_all_single_" + axis] = jdist.all_to_all_single(
                t(xv), group=axis)._array
        return {k: v[None] for k, v in out.items()}

    spec = JP(AXES)
    fn = shard_map(body, mesh=mesh, in_specs=(spec, spec, JP()),
                   out_specs=spec, check_vma=False)
    out = jax.jit(fn)(jnp.asarray(x), jnp.asarray(lists),
                      jnp.asarray(lists[:1]))
    return {k: np.asarray(v) for k, v in out.items()}


def _check(port, ref, case, rtol=1e-6):
    for r in range(4):
        np.testing.assert_allclose(port[r][case], ref[case][r], rtol=rtol,
                                   atol=1e-6, err_msg="%s rank %d"
                                   % (case, r))


@pytest.mark.parametrize("axis", AXES)
@pytest.mark.parametrize("op", OPS)
def test_all_reduce_matches_jax(port, ref, op, axis):
    """All five ReduceOps over each sub-axis of the 2 x 2 mesh (PROD: the
    port's real product against JAX's exp(psum(log x)), to 1e-5)."""
    _check(port, ref, "all_reduce_%s_%s" % (op, axis),
           rtol=1e-5 if op == "PROD" else 1e-6)


@pytest.mark.parametrize("axis", AXES)
@pytest.mark.parametrize("case", ["all_gather", "all_gather_list",
                                  "broadcast", "reduce_SUM", "reduce_MAX",
                                  "reduce_MIN", "reduce_scatter",
                                  "reduce_scatter_list", "scatter",
                                  "alltoall", "all_to_all_single"])
def test_collective_matches_jax(port, ref, case, axis):
    _check(port, ref, "%s_%s" % (case, axis))


def test_in_place_point_to_point_and_groups(port):
    """all_reduce and reduce_scatter write their input and return it;
    send / recv and isend / irecv pair mp rank 0 with mp rank 1; a
    new_group on an axis, the default axis under split_group_axis, the
    coordinates, all_gather_object, and the count of issued ops."""
    x, _lists = _inputs()
    for r in range(4):
        o = port[r]
        assert o["same"] == {"all_reduce": True, "reduce_scatter": True}
        assert o["coord"] == (r // 2, r % 2)
        partner = r + 1 if r % 2 == 0 else r - 1
        # mp rank 1 receives mp rank 0's row and sends it back times 10
        want = x[r] * 10 if r % 2 == 0 else x[partner]
        np.testing.assert_allclose(o["p2p"], want, rtol=1e-6)
        dp_peer = r ^ 2
        np.testing.assert_allclose(o["new_group_dp"], x[r] + x[dp_peer],
                                   rtol=1e-6)
        np.testing.assert_allclose(o["default_axis_mp"], x[r] + x[partner],
                                   rtol=1e-6)
        groups = {"dp": sorted([r, dp_peer]), "mp": sorted([r, partner])}
        for axis in AXES:
            assert list(o["all_gather_object_" + axis]) == [
                {"rank": q} for q in groups[axis]]
        issued = o["issued"]
        assert issued["all_reduce"] == 2 * len(OPS) + 2
        sent = ("send", "irecv") if r % 2 == 0 else ("recv", "isend")
        assert all(issued[k] == 1 for k in sent)
        assert issued["barrier"] == 1


def test_world_of_one_is_the_identity():
    """No process group: every collective returns its input untouched, as
    the JAX package's do outside shard_map; nothing is issued."""
    assert not torch.distributed.is_initialized()
    tmesh.set_mesh(None)
    tcoll.reset_counts()
    x = torch.arange(6.0).reshape(2, 3)
    for op in OPS:
        t = x.clone()
        assert tdist.all_reduce(t, op=getattr(tdist.ReduceOp, op)) is t
        torch.testing.assert_close(t, x)
    for fn in (tdist.broadcast, tdist.reduce, tdist.send, tdist.recv):
        t = x.clone()
        assert fn(t) is t
        torch.testing.assert_close(t, x)
    assert tdist.all_gather(x) is x
    lst = []
    tdist.all_gather(lst, x)
    assert len(lst) == 1 and lst[0] is x
    assert tdist.reduce_scatter(x.clone()).shape == x.shape
    t = torch.zeros(3)
    tdist.scatter(t, [torch.ones(3), torch.full((3,), 2.0)], src=1)
    torch.testing.assert_close(t, torch.full((3,), 2.0))
    assert tdist.alltoall(x) is x
    assert tdist.all_to_all_single(x) is x
    objs = []
    assert tdist.all_gather_object(objs, {"a": 1}) == [{"a": 1}]
    assert tdist.isend(x).wait() and tdist.irecv(x).is_completed()
    tdist.barrier()
    assert tcoll.issued() == {}
    assert tdist.get_rank() == 0 and tdist.get_world_size() == 1
    assert tdist.get_group().nranks == 1
    with pytest.raises(ValueError, match="devices"):
        tdist.init_mesh({"mp": 2})
    mesh = tdist.init_mesh({"dp": 1})
    assert mesh.shape == {"dp": 1} and tmesh.axis_size("mp") == 1
    tmesh.set_mesh(None)


def test_topology_matches_jax():
    """CommunicateTopology / HybridCommunicateGroup: host arithmetic, the
    JAX package's values exactly."""
    names = ("data", "pipe", "sharding", "model")
    dims = (2, 1, 2, 2)
    jt = jmesh.CommunicateTopology(names, dims)
    tt = tmesh.CommunicateTopology(names, dims)
    assert tt.world_size() == jt.world_size()
    for n in names:
        assert tt.get_dim(n) == jt.get_dim(n)
        assert tt.get_comm_list(n) == jt.get_comm_list(n)
        for i in range(dims[names.index(n)]):
            assert tt.get_axis_list(n, i) == jt.get_axis_list(n, i)
    for r in range(jt.world_size()):
        assert tuple(tt.get_coord(r)) == tuple(jt.get_coord(r))
        assert tt.get_rank_from_stage(r, model=1) == \
            jt.get_rank_from_stage(r, model=1)
        jh = jmesh.HybridCommunicateGroup(jt, r)
        th = tmesh.HybridCommunicateGroup(tt, r)
        for fn in ("get_data_parallel_rank", "get_data_parallel_world_size",
                   "get_data_parallel_group_src_rank",
                   "get_model_parallel_rank",
                   "get_model_parallel_world_size", "get_stage_id",
                   "get_pipe_parallel_world_size",
                   "get_sharding_parallel_rank",
                   "get_sharding_parallel_world_size", "get_parallel_mode"):
            assert getattr(th, fn)() == getattr(jh, fn)(), fn
        for fn in ("get_data_parallel_group", "get_model_parallel_group",
                   "get_sharding_parallel_group"):
            jg, tg = getattr(jh, fn)(), getattr(th, fn)()
            assert (tg.axis, tg.nranks, tg.rank, tg.ranks) == \
                (jg.axis, jg.nranks, jg.rank, jg.ranks)


def test_all_names_match_jax():
    """``__all__`` is the JAX package's plus the names the port had
    (store, recompute); ``launch`` is the launcher module, as in the JAX
    package, and ``fleet`` is the port's facade module."""
    ported = ["store", "TCPStore", "StoreReplyLostError", "recompute",
              "recompute_sequential"]
    assert tdist.__all__ == jdist.__all__ + ported
    for name in jdist.__all__:
        if name == "launch":
            from paddle_tpu_torch.distributed import launch_main
            assert getattr(tdist, name) is launch_main
            assert callable(launch_main.main)
            assert isinstance(launch_main.Launcher, type)
        elif name == "fleet":
            assert callable(tdist.fleet.init)
            assert callable(tdist.fleet.distributed_model)
        else:
            assert callable(getattr(tdist, name)) or isinstance(
                getattr(tdist, name), type)
    assert set(tcoll.__all__) >= set(jdist.collective.__all__)
